#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mdbench_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no result line) on failure:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile mdbench_tpu_torch/csrc/*.cu with nvcc for sm_90a;
  3. kernel: the exact-list LJ kernel against its plain torch version on
     random planes and lists holding sentinel ids and all-padding units,
     float32 (<= 1e-5 of max |f|) and float64 (<= 1e-12), share 1, 2, 4;
     then K1 and K1t on the distance sweep's edge cases
     (boundary_ilist_case: pairs exactly at the cutoff and one ulp inside
     it, padding, coinciding padding, NaN rows, an empty list, units
     without a pair inside, a tile with every pair inside, a unit whose
     pairs inside lie in one chunk): rows without a pair exactly 0, two
     launches the same bits, approx_rcp within the tolerance (float32) or
     bit-equal (float64);
  4. main path: the benchmark run of `python -m mdbench_tpu_torch.bench`
     (131,072 atoms, 200 SP steps, cluster scheme), gated on the C
     reference's temperature trace; it must plan capacity buckets, the
     set-up forces before the plan launch the flat kernel (K1) and the
     bucketed form (K1b) must cover every force evaluation of the checked
     and timed runs; no other kernel launches;
  5. small input: a jittered 6^3 box in float64, step-0 forces and a
     40-step temperature trace with both rebuild kinds, card against the
     CPU plain path;
  6. kernel at the main path's shapes: the run's final 131k planes and
     lists, kernel against plain version, exact and with the approximate
     reciprocal that the main path takes (each within 1e-5 / 1e-12 of max
     |f|; median times back to back and on the device alone); the sweep
     counts of those lists (ops/lj_cluster.ilist_sweep_counts: listed and
     inside pairs, the sweeps' warp steps, sweep B's efficiency) and the
     kernel's -Xptxas -v lines;
  7. EAM kernels: the two EAM passes (density, force) against their plain
     torch versions on the same random lists plus a random fp plane,
     float32 (<= 1e-5 of max |value|) and float64 (<= 1e-12), share 1,
     2, 4; all-padding units get exactly zero density and force; then
     both on phase 3's edge cases;
  8. EAM main path: the cluster EAM run of run_bench_eam (131,072 atoms,
     60 SP steps) on the stand-in potential below; it must plan capacity
     buckets, the flat passes (K2, K3) launch for the set-up forces before
     the plan and the bucketed ones (K2b, K3b) must each cover every force
     evaluation of the checked and timed runs; then the same
     run in float64, whose temperatures at steps 20/40/60 the SP run must
     meet within rel 2e-3 / 1e-2 / 3e-2 (tools/r3_eamc.py's SP tolerances;
     the golden EAM trace needs the real Cu_u3.eam);
  9. EAM small input: a jittered 6^3 box in float64, step-0 forces and a
     40-step temperature trace with both rebuild kinds, card against the
     CPU plain path;
 10. EAM kernels at the main path's shapes: the EAM run's final planes,
     lists and fp plane (error, median times back to back and on the
     device alone, the sweep counts, -Xptxas -v lines);
 11. group-window kernel: against its plain torch version on random group
     lists (windows inside the list, empty and past njg; sentinel ids and
     real ids past nj; an all-padding group, whose rows must be exactly
     0) and on the box cull's edge cases (boundary_group_lists: pairs
     exactly at the cutoff and one ulp inside it, touching boxes,
     padding, NaN rows, one-j16 windows; rows without a pair exactly 0),
     float32 (<= 1e-5 of max |f|) and float64 (<= 1e-12);
 12. group-window main path: run_bench(kernel="pallas"), the 131,072-atom
     200-step SP run on group lists with tile windows, gated on the C
     reference's temperature trace; the group-window kernel's launches
     must cover every force evaluation and the exact-list kernel must not
     launch; the final state's window counters (stats.py); then one
     torch.profiler pass over a _run_steps(200) of that run (after the
     counts are read): K4's summed device ms and the device busy share
     (kernel, memcpy and memset spans only);
 13. group-window small input: a jittered 6^3 box in float64, card
     against the CPU plain path (step-0 forces <= 1e-10, 40-step
     temperatures <= 1e-9, both rebuild kinds) for kernel="pallas", for
     kernel="pallas" with the prune every 3 steps, and for the Newton
     half lists (half_neigh=1, whose index_add_ sums with atomics on the
     card: ~1e-16 relative per sum in float64, so the same limits hold);
 14. group-window kernel at the main path's shapes: phase 12's final
     planes, lists and windows (error, median times back to back and on
     the device alone, the ratio to phase 6's K1 exact time, window pairs
     and the pairs the kernel evaluates; its work counts: member tiles,
     the lock-step design's lane-pairs, window and kept j-clusters,
     lane-pairs; the -Xptxas -v lines of its instantiations, typed too);
 15. the cluster stub (run_cluster_stub: 65,536 atoms, 76 j16 per group
     list, 200 steps) for seq, fix and rand: the kernel launches every
     step; its first force against the plain version (float32: the
     stub's geometry overflows some forces to inf or NaN, which must sit
     where the plain version has them; the finite ones <= 1e-5 of the
     largest); the kernel's median time on the stub's planes;
 16. typed kernels: the typed exact-list kernel (K1t) and the typed
     group-window kernel (K4t) against their typed plain versions on the
     random lists and windows of phases 3 and 11, with random types for
     T = 2 and 3 and non-uniform tables, and K4t on phase 11's edge
     cases, float32 (<= 1e-5 of max |f|) and
     float64 (<= 1e-12); all-padding units and groups get exactly 0; with
     uniform tables each equals its untyped kernel within the same limits;
 17. the typed main path from a file: a 131,072-atom two-type LAMMPS dump
     (the 32^3 lattice, its velocities after adjust_thermo, its glibc-rand
     types for ntypes=2, every number with 17 significant digits) read
     through Params(input_file=...) and run for 200 SP steps with the
     default EXPLICIT_TYPES tables on kernel="auto" (K1t) and
     kernel="pallas" (K4t); each run passes the golden gate (uniform
     tables: the untyped physics), the typed kernel's launches cover
     every force evaluation and the untyped kernels do not launch;
 18. non-uniform tables (eps 1.0 / 0.7 / 1.3, sigma 1.0 / 0.95 / 1.05,
     cutoff 2.5) on the same file: on both paths the SP run meets a DP
     run within the golden gate's tolerances at every 20th step; then a
     jittered 6^3 DP box with two types, card against the CPU plain path
     for "auto", "pallas" and half_neigh=1;
 19. K1t and K4t at the main path's shapes: phase 18's final SP states
     with their tables and phase 17's with the default ones (error
     against plain, against the untyped kernel with uniform tables;
     median times beside the untyped kernel's on the same lists); K1t
     also with the approximate reciprocal, as phase 17 runs it, against
     plain and timed on both states (also on the device alone), with the
     sweep counts of phase 18's lists and tables; K4t also on the device
     alone, its ratio to K1t exact and its work counts (culled against the
     tables' largest cutsq); phases 12, 17 and 18 launch no K1b;
 20. bucketed kernels: K1b, K2b and K3b against their plain bucketed
     twins on the random cases of phases 3 and 7 with hand-set plans (a
     zero tier, dummy units, and once a bucket whose cap is below its
     longest list), float32 (<= 1e-5) and float64 (<= 1e-12), share 1, 2,
     4; on untruncated plans equal to K1, K2 and K3 bit for bit; then all
     of them on phase 3's edge cases, bucketed over a hand plan with a
     zero tier and dummy units and over one with a truncating bucket;
 21. flat against bucketed: the 131k/200 SP run alternately without
     buckets (a subclass whose _plan_buckets returns False) and with them,
     F B B F F B B F, each golden-gated, AB_REPEATS timed regions of one
     run each (not the bench's 3 x 3, to keep the script short); median
     TOTALs; then a jittered 6^3 DP box with a hand-set plan, card against
     the CPU plain path (step-0 forces <= 1e-10, 40-step temperatures <=
     1e-9, both rebuild kinds), without and with the prune every 3 steps;
 22. K1b, K2b and K3b at the main paths' shapes: phases 4's and 8's final
     states beside K1, K2 and K3 on the same lists (bit-equal), error
     against the plain twins (K1b also with approx_rcp, as the main path
     runs it), median times back to back and on the device alone, bound,
     the j16 slots the blocks' tile loops run in unit order and in nji
     order, and the sweep counts of the bucketed lists;
 23. measure_phases on phase 4's final state (FORCE and NEIGH ms), and
     run_chunked(10, 4) at 131k with a rebuild every 10 steps, whose
     temperatures must equal run(ntimes=40)'s within rel 1e-6;
 24. the approximate reciprocal (Params.approx_rcp, which the main path
     takes): K1, K1t and K1b with approx_rcp on the random cases of phases
     3, 16 and 20, float32 within 1e-5 of max |f| of their plain twins
     (which divide), K1b equal to K1 bit for bit on untruncated plans when
     both take it; float64 bit-equal with the flag and without it;
 25. the bf16 probe (T2, probes/bf16.py): the bf16 kernel against its
     plain twin on phase 3's random cases and on probes.bf16.edge_case
     (odd inside counts, lists ending mid-chunk, an all-padding unit
     exactly 0, pairs on both sides of a cutoff that bfloat16 cannot
     represent), share 1, 2, 4, and on phase 4's final 131k flat lists,
     within BF16_TOL of max |f|; its bound (bf16_bound) beside the
     earlier one; the probe's force
     error against exact K1 and the device times (CUDA graph) of K1 exact,
     K1 approximate and the bf16 kernel on those lists (the bf16 JSON
     row's ms); the 131k/200 SP run with the bf16
     force on flat lists (one run(), repeats 1, chain 1): the bf16 kernel
     must cover every force evaluation, K1b and every other force kernel
     must not launch, and the temperatures must be finite; the golden
     gate's verdict is printed as the probe's finding (a FAIL is not
     fatal);
 26. the row-fetch probe (T1, probes/dma.py): the four variants (cp.async
     or TMA bulk, per row or per 8-row block) equal index_select bit for
     bit, at the tool's shapes and on short id lists that end inside a
     stage; ns per row and ms on the device alone (replayed from a CUDA
     graph: the JSON rows' ms and library_ms) and back to back from the
     host, each beside index_select's, and the bound.

 27. the verlet scheme's main path: run_bench_verlet (131,072 atoms, 200
     SP steps, 16-atom row lists), flat (engine.FlatSimulation: K1 for
     every force) and bucketed (the melt calibration plans capacity
     buckets: K1 for the set-up forces before the plan, K1b for every
     force of the checked and timed runs), each gated on the C
     reference's temperature trace; no other kernel launches;
 28. K1 and K1b on those runs' final row lists (planes
     x[:, d].reshape(-1, 8), share 2) against their plain twins, float32
     (<= 1e-5) and float64 (<= 1e-12), exact and with approx_rcp, K1b
     bit-equal to K1; median times back to back and on the device, sweep
     counts, bound, and the time of the three plane copies a force call
     makes; then a jittered 6^3 DP verlet box, card against the CPU plain
     path (step-0 forces <= 1e-10, 40-step temperatures <= 1e-9) on the
     row lists, the planar full lists and the half lists;
 29. measure_phases on the bucketed run's final state (FORCE and NEIGH
     ms), the stream synchronisations of a 40-step run and of one rebuild
     (torch.cuda.set_sync_debug_mode), and one torch.profiler pass over a
     200-step run (device ms by kernel, busy share).

 30. the verlet scheme's EAM path: first K5 and K6 (csrc/eam_verlet.cu)
     on their edge cases (verlet_eam_edge_cases: numneigh 0 over real
     entries, sentinel and NaN rows in lists, a pair at the cutoff and one
     ulp inside, padding rows, lists past their width; an odd width over
     53 atoms with a block of 16 empty rows and rows at and past the
     width; a single local atom) against their plain versions bit for
     bit, float32 and float64, spline and poly: rows without a pair
     inside exactly 0, two launches the same bits; then
     run_bench_eam(scheme="verlet") (131,072 atoms, 60
     SP steps, per-atom lists; eam_eval auto takes the polynomials on the
     card) on phase 8's stand-in potential: K5 then K6 once each for every
     force evaluation (Simulation._force calls) and no other hand kernel;
     TOTAL, FORCE and NEIGH (measure_phases), the calibrated list width
     K, the force's bound and one torch.profiler pass over a 60-step run
     (device busy share, device ms by kernel); an SP spline run and DP
     poly and spline runs (K5/K6 on every force), each SP run within
     EAM_SP_TOL of the DP run of its evaluation at steps 20/40/60, and the
     DP poly run within rel 1e-6 of phase 8's cluster DP run (poly) at
     every 20th step (step 0's temperatures within rel 1e-14); then K5 and
     K6 on the SP poly run's final 131k lists against their plain versions
     bit for bit (float32 and float64, poly and spline, two launches the
     same bits), median ms back to back and on the device alone, bounds
     and the share of them, the list entries' rate, the blocks an SM
     holds, the -Xptxas -v lines;
 31. verlet EAM on a jittered 8^3 DP box, spline and poly, card against
     the CPU plain path (step-0 forces and 20-step temperatures <= 1e-12),
     K5 and K6 on every card force, and no host synchronisation in a
     20-step run;
 32. the verlet stub (run_stub: 65,536 atoms, 76 neighbours, 200 SP
     steps) for LJ full and half lists (no hand kernel) and EAM spline and
     poly (K5 and K6 on each of the 400 forces): Mega atom updates/s, and
     the DP first force on the card against the CPU (<= 1e-12 of the
     largest finite value, non-finite entries equal);
 33. the command line (`python -m mdbench_tpu_torch.cli` in a
     subprocess for the verlet LJ run, cli.main in this process for the
     others): verlet and cluster LJ at 131k/200 SP with nstat 20,
     gated on the golden trace, each naming the card and K1b; on an 8^3
     box --vtk, --xtc, -w and --checkpoint, then --trace-index,
     --trace-mem and --timers diff (cluster), then --restore, each
     writing its files; and -f eam on both schemes (131k/60 SP, naming
     K5/K6 and K2b/K3b).

 34. the slab engine (parallel/verlet_domain.DomainSimulation) on an
     in-process mesh of one slab: run_bench_domain(ndev=1), 131,072 atoms,
     200 SP steps on the row lists (the melt calibration plans capacity
     buckets: K1 for the set-up forces, K1b after), gated on the C
     reference's temperature trace, TOTAL beside phase 27's single-engine
     TOTAL; every atom on the slab; then one more run of the timed
     region's kind: K1b launched once a step (K1 0), no host
     synchronisation (torch.cuda.set_sync_debug_mode);
 35. the same on two and four slabs (26.9 and 13.4 sigma wide, above
     cutneigh 2.8), one timed run each: golden-gated, atoms conserved across the migrations,
     the timed run's launches (two slabs: K1b if their units get a plan;
     four slabs: K1, 2,304 units a slab being too few for one) and no
     host synchronisation; the dry run (parallel/dryrun: 1, 4 and 8 slabs
     of an 8x2x2 box or longer, planar and row lists, against
     engine.Simulation; at 4 and 8 domains also its pencil leg, at 8 its
     brick leg); then
     K1b on the one-slab run's final row lists and K1 on the four-slab
     run's, as phase 28 (error against the plain twins, K1b equal to K1,
     times, sweep counts, bound);
 36. EAM on two slabs at 131k/60 on phase 8's stand-in potential: SP
     poly against DP poly within EAM_SP_TOL at steps 20/40/60 (the ghost
     fp exchanged between the slabs between the passes), K5 and K6 once
     each for every slab force (StagedDomainEngine._forces) and no other
     kernel;
     DP poly against phase 30's single-engine DP poly run (rel 1e-6 at
     steps 20/40/60);
     an 8^3 DP box on two slabs, spline and poly, card against the CPU
     (20-step temperatures <= 1e-12; K5/K6 on every slab force).

 37. the cluster slab engine (parallel/cluster_domain.
     ClusterDomainSimulation) on one slab: run_bench_domain(ndev=1,
     scheme="cluster"), 131,072 atoms, 200 SP steps on the exact lists,
     gated on the C reference's temperature trace, TOTAL beside phase 4's
     single-engine TOTAL; every atom on the slab; the melt calibration
     plans capacity buckets (K1 for the set-up forces, then K1b for every
     force of the checked and timed runs; no other kernel); then one more
     run of the timed region's kind: K1b once a step, and its host
     synchronisations by site (torch.cuda.set_sync_debug_mode): none in
     the domain engine's own code (parallel/), the shared cluster ops'
     printed; one torch.profiler pass (busy share, top kernels);
 38. the same on two and four slabs (one timed run each), golden-gated,
     atoms conserved across the migrations; four slabs' 2,560 units a
     slab are too few for a plan, so K1 covers every force there (the
     phase prints why);
 39. kernel="pallas" on two slabs (one timed run): golden-gated, K4
     covers every force evaluation, K1 and K1b do not launch; then K1b,
     K1 and K4 on the final lists of one slab of the runs of 37, 38 (four
     slabs) and 39 against their plain versions (f32 <= 1e-5, f64 <=
     1e-12; K1b equal to K1; median ms back to back and on the device,
     bound);
 40. cluster EAM on two slabs at 131k/60 on phase 8's stand-in potential:
     K2b/K3b (K2/K3 for the set-up forces before the plan) and no LJ
     kernel; SP against DP within EAM_SP_TOL at steps 20/40/60, the DP
     run within rel 1e-6 of phase 8's single-engine DP run; K2b and K3b
     on one slab's final lists as in 39;
 41. small inputs on two slabs, card against the CPU plain path: a
     jittered 6^3 DP LJ box and a jittered 6^3 DP EAM box, a full rebuild
     every other interval (migration) and cheap ones between: step-0
     forces <= 1e-12 of max |f| (each slab's atom window in order),
     40-step temperatures <= 1e-9; the cluster leg of the dry run on 1
     and 4 slabs runs in phase 35's dry-run step.

 42. the pencil engine (parallel/verlet_domain2d.Domain2DSimulation) on a
     (2, 2) in-process mesh: run_bench_domain(mesh=(2, 2)), 131,072 atoms,
     200 SP steps on the row lists (one timed run), gated on the C
     reference's temperature trace, TOTAL beside phase 27's single engine
     and phase 35's four slabs; every atom on some pencil; K1 (K1b after a
     bucket plan, which a pencil's units, under the planner's 4096, are
     too few for: the phase prints why) covers every force evaluation of
     the checked and timed runs and nothing else launches; then one more
     run of the timed region's kind: K1 once a step a pencil, and its
     host synchronisations by site, none in the engine's own code
     (parallel/); one torch.profiler pass;
 43. the brick engine (parallel/verlet_domain3d.Domain3DSimulation) on
     (2, 2, 2) (26.9 sigma a brick) and on (2, 2, 1), whose z seam goes
     through a self-send (the phase prints the rows it carries), with the
     same gates;
 44. EAM 131k/60 on phase 8's stand-in potential on (2, 2) pencils and
     (2, 2, 2) bricks, SP poly and DP poly: K5 and K6 once each for
     every domain force and no other kernel, SP
     within EAM_SP_TOL of DP at steps 20/40/60, DP within rel 1e-6 of
     phase 30's single-engine DP poly run;
 45. small inputs, card against the CPU: a jittered 6^3 DP box on the
     row lists on (2, 2) and (2, 2, 2) (20-step temperatures <= 1e-12,
     the same atoms per domain); then K1 on one pencil's and one brick's
     final row lists of phases 42-43, as phase 28 (error against the
     plain twin in float32 and float64, times back to back and on the
     device, sweep counts, bound): the JSON rows "K1 on pencil rows" and
     "K1 on brick rows".

 46-48, the scale runs (bench.run_bench_scale: mdbench_tpu's
 tools/r3_scale.py and tests/test_parallel.py configurations; no golden
 trace exists at these sizes, so each SP run is gated on a DP run of the
 same box, the slabs on the single engine, with bench.check_trace; each
 prints TOTAL (one timed run), the set-up seconds apart from it, the
 peak bytes, the launches and the temperatures beside GOLDEN_TEMP_131K
 for reference only):
 46. 1M LJ (64^3 cells), 40 steps: a DP verlet run (the reference
     trace), then SP cluster auto (K1 at set-up, K1b after the plan),
     cluster pallas (K4) and verlet auto (K1, then K1b), each within rel
     1e-3 of the DP run at steps 20 and 40; FORCE/NEIGH (measure_phases)
     of both auto runs; one rebuild of each scheme (host synchronisations
     by site, peak bytes, the chunk counts of ops/verlet's loops and of
     derive_ilists); K1b and K1 (the same bits) on the cluster and the
     verlet runs' final lists and K4 on the pallas run's, float32 with
     the approximate reciprocal where the run takes it, against their
     plain versions (<= 1e-5 of max |f|; the plain versions in chunks of
     units), ms back to back and on the device, bound;
 47. 1M verlet EAM (64^3 cells) on phase 8's stand-in potential, SP and
     DP poly, 60 steps: K5 then K6 once each for every force, SP within
     EAM_SP_TOL of DP; FORCE/NEIGH, one rebuild as in 46, and K5/K6 on the
     SP run's final lists as phase 30 checks them at 131k (bit for bit);
 48. 10.1M LJ (136^3 cells), SP, 40 steps: the verlet single engine, then
     8 slabs of an in-process mesh on the same card (parallel/
     verlet_domain.DomainSimulation): both start at Params.temp (rel
     1e-6 of the float64 sum of the float32 velocities), the slabs hold
     every atom at the end and meet the single engine within rel 1e-4 at
     steps 20 and 40; TOTAL against the single engine's, peak bytes
     against plan_capacities (1 and 8 domains); K1b and K1 on the single
     engine's final rows and on one slab's, as in 46.
 49. the bf16 derive (Params.derive_bf16): both derives on phase 4's
     final state at the group lists' width (the bf16 lists hold every
     exact entry; each extra entry lies outside cutneigh and within
     ops/cluster.bf16_reach and sqrt(cut_eff) + err_r of its unit, by the
     float64 distance of the float32 coordinates; no sentinel j16 before
     nji; nji sums and maxima, the calibrated capacities, bucket plans
     and their padded pairs); run_bench(derive_bf16=True) at 131k/200 SP
     (golden gate, K1 at set-up and K1b after the plan and nothing else,
     its temperatures against phase 4's, its final lists the bf16
     derive's, TOTAL of one timed run beside phase 4's); the A/B of
     tools/r3_derive16.py in turns f32, bf16, bf16, f32 (the derive alone,
     four turns of 11 event-fenced calls, as the eager run pays it, and
     two from a CUDA graph, the device's share; measure_phases of both
     engines; K1b with the approximate reciprocal on both lists' plans,
     back to back and on the device, and whether both give the same
     forces) and its verdict both ways, printed only; the exact derive's
     run again against phase 4's temperatures, beside the bf16 run's
     difference from them; K1b on the run's
     final lists against its plain version in chunks of units (1e-5 of
     max |f|, the same bits as K1); cluster EAM 131k/60 SP with
     derive_bf16 (K2 and K3 at set-up, K2b and K3b for every force after
     the plan, nothing else) within EAM_SP_TOL of phase 8's DP run.
 50. the verlet row lists' exact prune (csrc/verlet_prune.cu): on
     prune_edge_cases (float32 and float64) and on the candidates of a rebuild after a 20-step SP run of the
     131k engine (ranges and cells builds) and the 1M engine (ranges),
     the same rows and counts as exact_prune_ref bit for bit; at the
     engines' ranges candidates ms back to back and on the device, the
     plain version's ms, the run's launches, the bound by operations.
 51. the verlet ranges build's candidate stage (csrc/verlet_ranges.cu):
     on ranges_edge_cases (float32 and float64, and ccap at the random
     case's largest union and one below it) and on the inputs of a
     rebuild after a 20-step SP run of the 131k and the 1M engine, the
     outputs of range_candidates_ref (cand and total where no unit has
     more ranges than kcap), and at 131k derive_rowlists_from_ranges on
     the card equal to the CPU's; at the engines' inputs the kernel's ms back to
     back and on the device, the whole stage's and the plain chunk loop's
     ms, a derive call's launches, the run's launches, the bound by bytes.

Every kernel count is set to 0 just before each main path (phases 4, 8,
12, both runs of 17, the probes' runs in 25 and 26, both runs of 27, each
131k run of 30, the card's runs of 31, each stub of 32 (LJ: where it must
stay 0), each run of 34-36, 37-40, 42-44 and 46-48, both runs of 49, and
each run of 50 and 51: the prune and the ranges kernels')
and read just after it. Each phase prints its wall ("phase N: X s") when the next one
starts. Then it prints the script's wall time, a JSON line of the
kernels, nvidia-smi's line, and {"ok": true, "device": {...}} as the
last line.

Only phase 4 takes the benchmark's 3 x 3 timed runs; every other timed
131k run takes one timed region of one run (SEC_REPEATS, SEC_CHAIN), and
the small DP boxes run card against CPU without a timed region, to keep
the script well inside its limit.

A kernel's bound (bound_ms) is the least time the card could take for
the work the main path's inputs need: the larger of its operations over
the card's peak (67 TFLOP/s float32, 34 TFLOP/s float64, non-tensor, H100
SXM data sheet) and its bytes over 3.35 TB/s, each input read once and
each output written once. An LJ pair costs 8 operations for the distance
test and 15 more inside the cutoff (the divide counted as one); an EAM
pair 8, and inside the cutoff 6 + 2d (density) or 10 + 4d (force) for
Horner polynomials of degree d; the verlet EAM passes' spline form
counts its rows as polynomials of degree 3 (density) and 2 + 2 + 3
(force), with 8 more for the force's 1/r chain (eam_verlet_bounds). The
pairs are the kernel's work on these lists (stats.compute_cluster_stats;
for K5 and K6 each per-atom list up to min(numneigh, K)): the exact-list
kernels' listed pairs, and for the group-window kernels the window pairs that their
contract asks for, whatever they cull (the pairs the kernel evaluates
are printed beside). The bf16 kernel follows K1's convention: per listed
pair the distance test, 6 float32 operations (subtracts, converts to
bfloat16) and 7 bfloat16 ones (rsq, the two compares); per pair inside
its bfloat16 cutoff test the pair math, 9 float32 operations (the
reciprocal, converts, sums) and 10 bfloat16 ones (sr6, gf, d*gf), the
bfloat16 ones over 134 TFLOP/s (two per packed bf16x2 instruction at the
float32 rate) (bf16_bound; phase 25 prints the earlier bound, 9 float32
and 16 bfloat16 operations on every listed pair, beside it).
A row fetch moves bytes only. No single PyTorch call computes a force
kernel's function, so their library_ms is null; a row fetch's is
index_select's, which is also its plain version. The rows of K1, K1t and
K1b give the error and time of the form the main path launches, with the
approximate reciprocal (Params.approx_rcp), and the exact form's time as
exact_ms.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

KERNEL = {
    "name": "lj_cluster_ilist",
    "route": "cuda",
    "source": "mdbench_tpu_torch/csrc/lj_cluster_ilist.cu",
    "replaces": "mdbench_tpu/ops/pallas/lj_cluster.py:433",
}
STREAM_KERNEL = {
    "name": "lj_cluster_stream",
    "route": "cuda",
    "source": "mdbench_tpu_torch/csrc/lj_cluster_stream.cu",
    "replaces": "mdbench_tpu/ops/pallas/lj_cluster.py:50",
}
TYPED_KERNEL = {
    "name": "lj_cluster_ilist_typed",
    "route": "cuda",
    "source": "mdbench_tpu_torch/csrc/lj_cluster_ilist.cu",
    "replaces": "mdbench_tpu/ops/pallas/lj_cluster.py:433",
}
STREAM_TYPED_KERNEL = {
    "name": "lj_cluster_stream_typed",
    "route": "cuda",
    "source": "mdbench_tpu_torch/csrc/lj_cluster_stream.cu",
    "replaces": "mdbench_tpu/ops/pallas/lj_cluster.py:50",
}
# the capacity-bucketed forms (K1b, K2b, K3b): the same TPU kernels,
# called once per bucket by mdbench_tpu (engine_cluster.py:516,
# ops/pallas/eam_cluster.py:289)
BUCKET_KERNELS = {
    "lj_cluster_ilist_buckets": {
        "name": "lj_cluster_ilist_buckets",
        "route": "cuda",
        "source": "mdbench_tpu_torch/csrc/lj_cluster_ilist.cu",
        "replaces": "mdbench_tpu/ops/pallas/lj_cluster.py:433",
    },
    "eam_rho_buckets": {
        "name": "eam_rho_buckets",
        "route": "cuda",
        "source": "mdbench_tpu_torch/csrc/eam_cluster.cu",
        "replaces": "mdbench_tpu/ops/pallas/eam_cluster.py:45",
    },
    "eam_force_buckets": {
        "name": "eam_force_buckets",
        "route": "cuda",
        "source": "mdbench_tpu_torch/csrc/eam_cluster.cu",
        "replaces": "mdbench_tpu/ops/pallas/eam_cluster.py:86",
    },
}
BF16_KERNEL = {
    "name": "lj_cluster_ilist_bf16",
    "route": "cuda",
    "source": "mdbench_tpu_torch/csrc/lj_cluster_ilist.cu",
    "replaces": "tools/r3_bf16.py:39",
}
# the row-fetch variants: per row (tools/r4_dma.py k1) and per 8-row block (k8)
ROW_FETCH_REPLACES = {1: "tools/r4_dma.py:62", 8: "tools/r4_dma.py:91"}
EAM_KERNELS = {
    "eam_rho_ilist": {
        "name": "eam_rho_ilist",
        "route": "cuda",
        "source": "mdbench_tpu_torch/csrc/eam_cluster.cu",
        "replaces": "mdbench_tpu/ops/pallas/eam_cluster.py:45",
    },
    "eam_force_ilist": {
        "name": "eam_force_ilist",
        "route": "cuda",
        "source": "mdbench_tpu_torch/csrc/eam_cluster.cu",
        "replaces": "mdbench_tpu/ops/pallas/eam_cluster.py:86",
    },
}
# the verlet EAM passes (K5, K6): XLA in mdbench_tpu, not a Pallas kernel;
# the lines are its poly forms' passes (the main path's; the spline forms'
# are :79-130 and :142-153)
VERLET_EAM_KERNELS = {
    "eam_rho_nlist": {
        "name": "eam_rho_nlist",
        "route": "cuda",
        "source": "mdbench_tpu_torch/csrc/eam_verlet.cu",
        "replaces": "mdbench_tpu/ops/eam.py:166",
    },
    "eam_force_nlist": {
        "name": "eam_force_nlist",
        "route": "cuda",
        "source": "mdbench_tpu_torch/csrc/eam_verlet.cu",
        "replaces": "mdbench_tpu/ops/eam.py:222",
    },
}
# the verlet row lists' exact prune: XLA ops in mdbench_tpu, not a Pallas
# kernel (its cells build's prune; the ranges build's is :830)
PRUNE_KERNEL = {
    "name": "verlet_prune",
    "route": "cuda",
    "source": "mdbench_tpu_torch/csrc/verlet_prune.cu",
    "replaces": "mdbench_tpu/ops/verlet.py:465",
}
RANGES_KERNEL = {
    "name": "verlet_ranges",
    "route": "cuda",
    "source": "mdbench_tpu_torch/csrc/verlet_ranges.cu",
    "replaces": "mdbench_tpu/ops/verlet.py:533-829 (XLA, not a Pallas kernel)",
}
REPEATS, CHAIN = 3, 3  # as python -m mdbench_tpu_torch.bench (phase 4)
# every other timed 131k run: one timed region of one run, beside the
# checked run (the script's wall, not a benchmark's protocol)
SEC_REPEATS, SEC_CHAIN = 1, 1
AB_REPEATS = 1  # phase 21: timed regions per run, each of one chained run
# SP against DP temperatures of the EAM run (tools/r3_eamc.py GOLDEN_TOL)
EAM_SP_TOL = {20: 2e-3, 40: 1e-2, 60: 3e-2}
# the LJ wrappers' launch counts
LJ_COUNTS = ("LAUNCHES", "TYPED_LAUNCHES", "STREAM_LAUNCHES", "STREAM_TYPED_LAUNCHES",
             "BUCKET_LAUNCHES", "BF16_LAUNCHES")
# the non-uniform two-type tables of phase 18 (tests/test_cluster.py:65-68)
NONUNIFORM_TABLES = (np.array([[1.0, 0.7], [0.7, 1.3]]),
                     np.array([[1.0, 0.95], [0.95, 1.05]]) ** 6,
                     np.full((2, 2), 2.5**2))
# H100 SXM (NVIDIA's data sheet): non-tensor peaks (bfloat16: packed
# bf16x2, two operations per float32 slot), and HBM3's rate
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 134e12}
HBM_BYTES_PER_S = 3.35e12
# the bf16 kernel against its plain twin, relative to max |f|. The card's
# approximate reciprocal could round sr2 to the neighbouring bfloat16 value
# where the twin's exact one does not, moving that pair's term by 2^-8; on
# the H100 the two agreed to 6.4e-08 at 131k and 2.1e-10 on phase 3's
# cases (float32 summation order only), so the limit leaves room for such
# flips on weak pairs and none for a change in the order of operations
BF16_TOL = 1e-4


def write_standin_funcfl(path) -> None:
    """Write a stand-in single-element DYNAMO funcfl potential to `path`.

    It has the grid of Cu_u3.eam (nrho 500, drho 5.0100200400801306e-4,
    nr 500, dr 0.01, cut 4.95, header "29 63.550 3.8450 FCC"), so the EAM
    workload's atoms, box, cutoff, lists and kernel shapes are the real
    ones; only the table values differ. With r clamped below at 0.5 A and
    fc a C2 smoothstep from 1 at 4.35 A to 0 at 4.95 A:
      dens(r) = 0.0075 exp(-6 (r/2.72 - 1)) fc(r)
      phi(r)  = 0.2 exp(-8 (r/2.72 - 1)) fc(r), stored as
                Z(r) = sqrt(phi r / (27.2 * 0.529))
      F(rho)  = 3.5 ((rho/0.15)^2 - 2 rho/0.15)
    """
    nrho, drho, nr, dr, cut = 500, 5.0100200400801306e-4, 500, 0.01, 4.95
    r = np.maximum(np.arange(nr) * dr, 0.5)
    s = np.clip((r - 4.35) / 0.6, 0.0, 1.0)
    fc = 1.0 - s**3 * (10.0 - 15.0 * s + 6.0 * s * s)
    dens = 0.0075 * np.exp(-6.0 * (r / 2.72 - 1.0)) * fc
    phi = 0.2 * np.exp(-8.0 * (r / 2.72 - 1.0)) * fc
    z = np.sqrt(phi * r / (27.2 * 0.529))
    rho = np.arange(nrho) * drho
    frho = 3.5 * ((rho / 0.15) ** 2 - 2.0 * rho / 0.15)
    vals = np.concatenate([frho, z, dens])
    lines = ["stand-in Cu funcfl (analytic; not Cu_u3.eam)",
             "29 63.550 3.8450 FCC",
             f"{nrho} {drho:.16e} {nr} {dr:.16e} {cut:.16e}"]
    lines += [" ".join(f"{v:.16e}" for v in vals[i : i + 5])
              for i in range(0, vals.size, 5)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def random_tables(seed, ntypes, cutforce=2.5):
    """Symmetric non-uniform (eps, sig6, cutsq) float64 (T, T) tables: eps
    in [0.7, 1.3], sigma in [0.9, 1.1], cutoff in [2.0, cutforce] (no pair
    cutoff beyond the one the lists were built for)."""
    rng = np.random.default_rng(seed)

    def sym(lo, hi):
        a = rng.uniform(lo, hi, (ntypes, ntypes))
        return np.triu(a) + np.triu(a, 1).T

    return sym(0.7, 1.3), sym(0.9, 1.1) ** 6, sym(2.0, cutforce) ** 2


def write_typed_dump(path, nx=32, ntypes=2) -> int:
    """Write the LJ workload's atoms as a LAMMPS dump ('ITEM: ATOMS id type
    x y z vx vy vz', 'BOX BOUNDS pp pp pp'): the nx^3 FCC lattice, its
    velocities after adjust_thermo, and its glibc-rand types for `ntypes`
    (1-based in the file), every number with 17 significant digits so
    that it reads back bit-equal. Returns the atom count."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.thermo import adjust_thermo, setup_thermo

    p = Params(nx=nx, ny=nx, nz=nx, ntypes=ntypes)
    x, v, types = create_fcc_lattice(p)
    n = x.shape[0]
    v = adjust_thermo(p, setup_thermo(p, n), v, n)
    head = ["ITEM: TIMESTEP", "0", "ITEM: NUMBER OF ATOMS", str(n),
            "ITEM: BOX BOUNDS pp pp pp",
            *(f"0.0 {b:.17g}" for b in (p.xprd, p.yprd, p.zprd)),
            "ITEM: ATOMS id type x y z vx vy vz"]
    rows = np.concatenate([x, v], axis=1)
    with open(path, "w") as f:
        f.write("\n".join(head) + "\n")
        f.writelines(f"{i + 1} {types[i] + 1} " + " ".join(f"{a:.17g}" for a in row)
                     + "\n" for i, row in enumerate(rows))
    return n


def bound_of(ops: float, nbytes: int, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of `ops` over the card's peak for
    `dtype` and `nbytes` over its memory rate, and which one it is."""
    t_ops = ops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lj_ops(evaluated: int, inside: int) -> int:
    """Operations of the LJ kernels: 8 per evaluated pair, 15 more inside
    the cutoff."""
    return 8 * evaluated + 15 * inside


def ilist_pairs(cs: dict, share: int) -> int:
    """Pairs the exact-list kernels evaluate: each listed j16's 16 atoms
    against its unit's share*8 i-atoms (compute_cluster_stats' counts)."""
    return cs["clusters_processed"] * 16 * share * 8


def kernel_row(meta, launches, err, ms, plain_ms, bound, library_ms=None,
               exact_ms=None, device_ms=None) -> dict:
    """A kernel's entry of the JSON line. The exact-list kernels that the
    main path runs with approx_rcp give that form's error and time, and
    their exact form's time as `exact_ms`; `device_ms` is the time of the
    row's form on the device alone (probes.graph_ms)."""
    row = {**meta, "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
           "library_ms": library_ms}
    if exact_ms is not None:
        row["exact_ms"] = exact_ms
    if device_ms is not None:
        row["device_ms"] = device_ms
    return row


_PHASE = {"n": None, "t": 0.0}  # the running phase and its start


def phase(n) -> None:
    """Start phase `n` (None: stop), printing the wall of the one running
    ("phase N: X s", after a device synchronise); a no-op if n is the
    running phase."""
    import torch

    if n == _PHASE["n"]:
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    now = time.perf_counter()
    if _PHASE["n"] is not None:
        print(f"phase {_PHASE['n']}: {now - _PHASE['t']:.1f} s", flush=True)
    _PHASE["n"], _PHASE["t"] = n, now


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def tol_of(torch, dtype) -> float:
    return 1e-5 if dtype == torch.float32 else 1e-12


def rel_err(torch, got, want):
    """(max abs error, max abs error / max |want|) over the three
    components, in float64; fails on a non-finite value."""
    a = torch.stack([t.double() for t in got])
    b = torch.stack([t.double() for t in want])
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail("non-finite force")
    err = float((a - b).abs().max())
    return err, err / float(b.abs().max())


def median_ms(torch, fn, reps: int, batches: int = 5, warm: int = 3) -> float:
    """Device time per call (probes.event_ms: CUDA events around `reps`
    back-to-back calls, median over `batches`)."""
    from mdbench_tpu_torch.probes import event_ms

    return event_ms(fn, reps, batches, warm)


def random_case(torch, seed, share, dtype, device, cjn=512, icap=24,
                spacing=1.1):
    """Jittered lattice planes (lattice constant `spacing`) with ~10%
    padding atoms (sentinel coordinates, one offset per slot), all-padding
    rows 8-11 and the all-sentinel last j16; lists of random length with a
    sentinel id mid-list and sentinel ids past nji."""
    from mdbench_tpu_torch.state import SENTINEL_COORD

    rng = np.random.default_rng(seed)
    nrows = 2 * cjn
    nu = (nrows - 16) // share
    g = np.stack(np.meshgrid(*[np.arange(21)] * 3, indexing="ij"), -1)
    pts = g.reshape(-1, 3)[rng.permutation(21**3)[: nrows * 8]] * spacing
    pts = pts + rng.normal(0.0, 0.05, pts.shape)
    rank = np.arange(nrows * 8, dtype=np.float64).reshape(nrows, 8)
    padmask = rng.random((nrows, 8)) < 0.1
    padmask[8:12] = True
    padmask[-2:] = True
    planes = []
    for c in range(3):
        pl = pts[:, c].reshape(nrows, 8).copy()
        pl[padmask] = (SENTINEL_COORD * (1.0 + rank * 1e-6))[padmask]
        planes.append(torch.tensor(pl, dtype=dtype, device=device))
    sentinel16 = cjn - 1
    ijl = np.full((nu, icap), sentinel16, np.int32)
    nji = rng.integers(0, icap + 1, nu).astype(np.int32)
    for u in range(nu):
        ids = rng.choice(cjn - 1, nji[u], replace=False)
        if nji[u] > 2:
            ids[rng.integers(nji[u])] = sentinel16
        ijl[u, : nji[u]] = ids
    return (*planes, torch.tensor(ijl, device=device),
            torch.tensor(nji, device=device), nu * share)


def hand_plan(nji, icap: int, gran: int = 1, trunc: bool = False):
    """A hand-set capacity-bucket plan (sizes, caps) for lists of lengths
    `nji` (numpy), with every feature the planner's plans can have: a
    zero tier holding the empty lists (rounded down to `gran` units); a
    middle tier of about half the units (at least `gran`) at the cap of
    its longest list rounded up to 8, or with `trunc` 4 below that longest
    list (a bucket that truncates: its units read only cap entries); a
    last tier at `icap` that also holds `gran` dummy units. Sizes are
    multiples of `gran` (128 // share for mdbench_tpu's Pallas kernels)."""
    srt = np.sort(np.asarray(nji))
    nu = srt.size
    z = int((srt == 0).sum()) // gran * gran
    a = max((nu // 2 - z) // gran * gran, gran)
    longest = int(srt[min(z + a, nu) - 1])
    cap_a = max(longest - 4, 1) if trunc else max((longest + 7) // 8 * 8, 8)
    rest = (max(nu - z - a, 0) // gran + 1) * gran
    return (z, a, rest), (0, cap_a, int(icap))


def random_group_lists(seed, ng=8, L=32, ghost_rows=64, spacing=1.1):
    """A numpy case for the group-window force: (planes, jlist, ranges,
    n_clusters_pad), planes three (C_total, 8) float64 arrays, jlist
    (ng, L) and ranges (ng, 33) int32. Jittered lattice planes
    (lattice constant `spacing`) with ~10% padding atoms, group 1 all
    padding and the last j16 all-sentinel; each group list holds nj
    distinct j16 with a sentinel id among them, and real (random) ids past
    nj; njg = ceil(nj / 8); the windows are random, and in every group
    member 0's starts after 0 and ends before njg, member 1's is empty
    and member 2's ends past njg (njg bounds it)."""
    from mdbench_tpu_torch.state import SENTINEL_COORD

    rng = np.random.default_rng(seed)
    npad = ng * 16
    nrows = npad + ghost_rows + 2
    cjn = nrows // 2
    side = int(np.ceil((nrows * 8) ** (1.0 / 3.0)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
    pts = g.reshape(-1, 3)[rng.permutation(side**3)[: nrows * 8]] * spacing
    pts = pts + rng.normal(0.0, 0.05, pts.shape)
    rank = np.arange(nrows * 8, dtype=np.float64).reshape(nrows, 8)
    padmask = rng.random((nrows, 8)) < 0.1
    padmask[16:32] = True  # group 1: all padding
    padmask[-2:] = True  # the last j16 is all-sentinel
    planes = []
    for c in range(3):
        pl = pts[:, c].reshape(nrows, 8).copy()
        pl[padmask] = (SENTINEL_COORD * (1.0 + rank * 1e-6))[padmask]
        planes.append(pl)
    sentinel16 = cjn - 1
    nslab = L // 8
    jl = rng.integers(0, cjn - 1, (ng, L)).astype(np.int32)
    ranges = np.zeros((ng, 33), np.int32)
    for gi in range(ng):
        nj = int(rng.integers(L // 2, L + 1))
        jl[gi, :nj] = rng.choice(cjn - 1, nj, replace=False)
        jl[gi, rng.integers(nj)] = sentinel16
        njg = (nj + 7) // 8
        a, b = rng.integers(0, njg + 1, (2, 16))
        start, end = np.minimum(a, b), np.maximum(a, b)
        start[0], end[0] = 1, njg - 1
        start[1] = end[1] = njg // 2
        end[2] = nslab
        ranges[gi] = np.concatenate([start, end, [njg]])
    return planes, jl, ranges, npad


def boundary_group_lists(np_dtype, nan: bool = True):
    """A numpy case for the group-window force at the edges of the stream
    kernel's box cull: (planes, jlist, ranges, n_clusters_pad), planes
    three (68, 8) arrays of `np_dtype`, jlist (3, 24) and ranges (3, 33)
    int32, for cutforcesq = 6.25. Group 0's members are unit cubes 6 apart
    along y (member m: x, z in {0, 1}, y in {6m, 6m + 1}); group 1 is all
    padding; group 2's members sit near y = 200. Against member 0's box,
    rows of the ghost j16 24-27: row 48 at box distance exactly 2.5 (every
    pair's rsq >= 6.25, four exactly at it), row 49 one ulp of `np_dtype`
    closer (four pairs just inside), row 50 touching the box along x (gap
    0) and 1.5 away along y, row 51 a near neighbour, row 52 all padding,
    row 53 half padding, row 54 all NaN and row 55 half NaN (with
    nan=False those NaN are padding too). Rows 56-63 neighbour members 2
    and 3, rows 64-65 group 2's member 0, rows 66-67 the all-padding
    sentinel j16. Windows: group 0 reads its own j16 (tile 0) and the
    ghosts (tile 1), njg 2, with member 1's window empty, member 2's
    [1, 3) past njg and a tile past njg that would change its force if it
    were read; group 2 has one real j16 (nj 1, njg 1) and every member's
    window is that tile."""
    from mdbench_tpu_torch.state import SENTINEL_COORD

    nrows, npad = 68, 48
    slot = np.arange(8)
    bx, by, bz = slot & 1, (slot >> 1) & 1, (slot >> 2) & 1
    xyz = np.zeros((3, nrows, 8))
    rank = np.arange(nrows * 8, dtype=np.float64).reshape(nrows, 8)
    pad = np.zeros((nrows, 8), bool)
    nanm = np.zeros((nrows, 8), bool)

    def put(row, x, y, z):
        xyz[:, row] = np.broadcast_to(x, 8), np.broadcast_to(y, 8), np.broadcast_to(z, 8)

    for m in range(16):
        put(m, bx, 6.0 * m + by, bz)
        put(32 + m, bx, 200.0 + 6.0 * m + by, bz)
    pad[16:32] = True
    below = float(np.nextafter(np_dtype(3.5), np_dtype(0.0)))
    put(48, 3.5 + 0.5 * bx, by, bz)
    put(49, below + 0.5 * bx, by, bz)
    put(50, 1.0 + 0.8 * bx, 2.5 + 0.5 * by, bz)
    put(51, -1.2 - 0.8 * bx, by, bz)
    pad[52] = True
    put(53, 2.0 + 0.6 * bx, by, 1.0)
    pad[53, :4] = True
    put(54, 0.5, 0.5, 0.5)
    (nanm if nan else pad)[54] = True
    put(55, -1.4 - 0.7 * bx, by, 0.5)
    (nanm if nan else pad)[55, :4] = True
    for k in range(4):
        put(56 + k, 2.0 + 0.7 * bx + 0.1 * k, 12.0 + by + 0.1 * k, bz + 0.05 * k)
        put(60 + k, -1.8 - 0.6 * bx - 0.1 * k, 18.0 + by + 0.1 * k, bz - 0.05 * k)
    for k in range(2):
        put(64 + k, 2.0 + 0.6 * bx + 0.2 * k, 200.0 + by + 0.1 * k, bz + 0.2 * k)
    pad[66:] = True
    planes = []
    for c in range(3):
        pl = np.where(pad, SENTINEL_COORD * (1.0 + rank * 1e-6), xyz[c])
        planes.append(np.where(nanm, np.nan, pl).astype(np_dtype))
    sentinel16 = nrows // 2 - 1
    jl = np.full((3, 24), sentinel16, np.int32)
    jl[0, :8] = np.arange(8)  # group 0's own j16
    jl[0, 8:16] = np.arange(24, 32)  # the ghost rows 48-63
    jl[0, 16:20] = 28  # past njg: member 2's neighbours again
    jl[1, :8] = np.arange(24, 32)
    jl[2, 0] = 32
    jl[2, 8:16] = 32  # past njg
    ranges = np.zeros((3, 33), np.int32)
    ranges[0, :16], ranges[0, 16:32], ranges[0, 32] = 0, 2, 2
    ranges[0, [1, 2, 4]] = 1, 1, 1
    ranges[0, [16 + 1, 16 + 2, 16 + 5]] = 1, 3, 1
    ranges[1, 16:32], ranges[1, 32] = 1, 1
    ranges[2, 16:32], ranges[2, 32] = 1, 1
    return planes, jl, ranges, npad


def boundary_ilist_case(np_dtype, share: int = 2, nan: bool = True):
    """A numpy case for the exact-list kernels at the edges of their
    distance sweep: (planes, ijlist, nji, n_clusters_pad), planes three
    (82, 8) arrays of `np_dtype`, for cutforcesq = 6.25, with 8 i-rows.
    Row 0 is a unit cube at the origin, row 1 the same cube 6 away along
    y, rows 2-3 and the 32 j16 4-35 points of one grid (spacing 0.175)
    in a cube of side 1.4 at y = 40 (every pair among them inside the
    cutoff, none at rsq 0), rows 4-6 far from everything and row 7 all
    padding. Against row 0: j16 36's row 72 sits exactly at the cutoff
    (four pairs at rsq = 6.25) and row 73 one ulp of `np_dtype` closer
    (four pairs just inside); j16 37 is one row of padding and one half
    padding; j16 38 one row of NaN and one half NaN (with nan=False that
    NaN is padding too); j16 39 repeats row 7's padding coordinates
    (rsq exactly 0 against it); j16 40 is the all-padding sentinel. Every
    unit lists j16 4-39 in that order, then the sentinel, except the last
    unit, whose list is empty (nji 0, only sentinel ids). So the unit of
    rows 2-3 (share 2) has a first tile with every pair inside, the unit
    of rows 0-1 has its inside pairs in one chunk (of 64 or 128 atoms),
    and the units of rows 4-7 none."""
    from mdbench_tpu_torch.state import SENTINEL_COORD

    nrows, npad = 82, 8
    slot = np.arange(8)
    bx, by, bz = slot & 1, (slot >> 1) & 1, (slot >> 2) & 1
    xyz = np.zeros((3, nrows, 8))
    rank = np.arange(nrows * 8, dtype=np.float64).reshape(nrows, 8)
    pad = np.zeros((nrows, 8), bool)
    nanm = np.zeros((nrows, 8), bool)

    def put(row, x, y, z):
        xyz[:, row] = np.broadcast_to(x, 8), np.broadcast_to(y, 8), np.broadcast_to(z, 8)

    put(0, bx, by, bz)
    put(1, bx, 6.0 + by, bz)
    g = np.stack(np.meshgrid(*[np.arange(9)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = g[np.random.default_rng(8).permutation(729)[: 66 * 8]] * 0.175
    dense = [2, 3, *range(8, 72)]
    for k, row in enumerate(dense):
        put(row, *(pts[8 * k : 8 * k + 8].T + np.array([[0.0], [40.0], [0.0]])))
    for k, row in enumerate((4, 5, 6)):
        put(row, bx + 3.0 * k, 500.0 + by, bz)
    pad[7] = True
    below = float(np.nextafter(np_dtype(3.5), np_dtype(0.0)))
    put(72, 3.5 + 0.5 * bx, by, bz)
    put(73, below + 0.5 * bx, by, bz)
    pad[74] = True
    put(75, 2.0 + 0.6 * bx, by, 1.0)
    pad[75, :4] = True
    put(76, 0.5, 0.5, 0.5)
    (nanm if nan else pad)[76] = True
    put(77, -1.4 - 0.7 * bx, by, 0.5)
    (nanm if nan else pad)[77, :4] = True
    pad[80:] = True
    planes = []
    for c in range(3):
        pl = np.where(pad, SENTINEL_COORD * (1.0 + rank * 1e-6), xyz[c])
        pl[78:80] = pl[7]  # j16 39: row 7's padding coordinates again
        planes.append(np.where(nanm, np.nan, pl).astype(np_dtype))
    nu = npad // share
    ijl = np.full((nu, 40), nrows // 2 - 1, np.int32)
    ijl[:, :36] = np.arange(4, 40)
    nji = np.full(nu, 36, np.int32)
    ijl[-1], nji[-1] = nrows // 2 - 1, 0
    return planes, ijl, nji, npad


VERLET_EAM_CUTSQ = 4.5**2  # the edge case's cutoff: 4.5 is exact in both types


def verlet_eam_case(np_dtype, seed: int = 0) -> dict:
    """A numpy case for the verlet EAM kernels (K5, K6) at their edges,
    for cutforcesq = VERLET_EAM_CUTSQ: per-atom lists over a jittered
    6^3 cubic lattice of spacing 2.0 A (150 random points local, the rest
    ghosts), list width k = 72 (some lists overflow it), the sentinel row
    at the end. Edge rows: rows 0 and 1 have numneigh 0 over real
    entries; a few lists hold the sentinel row mid-list, some of them
    also one of two NaN ghost rows; row `at` lists one partner exactly at
    the cutoff (dy = 4.5), row `inside` one partner one ulp of `np_dtype`
    closer, row `nan` is NaN and lists five lattice rows, and the rows
    past the locals up to nlocal_pad are padding (sentinel coordinates,
    numneigh 0). Returns x (nrows, 3), neighbors and numneigh (int64),
    border_map (every ghost's owner: a random local, the sentinel for
    the NaN ghosts), nlocal_pad, `empty` (the rows that get rho and force
    exactly 0) and `nan_rows` (the rows whose pairs touch a NaN row,
    where mdbench_tpu's force is NaN: it multiplies by a masked 0)."""
    from mdbench_tpu_torch.state import SENTINEL_COORD

    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = g[rng.permutation(216)] * 2.0 + rng.normal(0.0, 0.08, (216, 3))
    nlat, k = 150, 72
    below = float(np.nextafter(np_dtype(4.5), np_dtype(0.0)))
    at, inside, nan_i, npad = nlat, nlat + 1, nlat + 2, 160
    special_l = [[60.0, 0.0, 0.0], [80.0, 0.0, 0.0], [np.nan] * 3]
    ghosts = [*pts[nlat:], [60.0, 4.5, 0.0], [80.0, below, 0.0], [np.nan] * 3, [np.nan] * 3]
    rank = np.arange(npad - nan_i - 1, dtype=np.float64)[:, None]
    pad = np.broadcast_to(SENTINEL_COORD * (1.0 + rank * 1e-6), (npad - nan_i - 1, 3))
    x = np.concatenate([pts[:nlat], special_l, pad, ghosts,
                        [[SENTINEL_COORD] * 3]]).astype(np_dtype)
    nrows, sentinel = x.shape[0], x.shape[0] - 1
    g_at, g_nan = npad + (216 - nlat), npad + (216 - nlat) + 2
    lat = np.r_[0:nlat, npad : npad + 216 - nlat]  # the lattice rows
    neighbors = np.full((npad, k), sentinel, np.int64)
    numneigh = np.zeros(npad, np.int64)
    xd = x.astype(np.float64)
    for i in range(nlat):
        d2 = ((xd[lat] - xd[i]) ** 2).sum(1)
        cand = np.sort(lat[(d2 <= 25.0) & (lat != i)])
        numneigh[i] = len(cand)
        neighbors[i, : min(len(cand), k)] = cand[:k]
    neighbors[at, 0], numneigh[at] = g_at, 1
    neighbors[inside, 0], numneigh[inside] = g_at + 1, 1
    neighbors[nan_i, :5], numneigh[nan_i] = lat[:5], 5
    nan_rows = {nan_i}
    for i in rng.choice(np.arange(2, nlat), 12, replace=False):
        n = min(int(numneigh[i]), k)
        neighbors[i, rng.integers(n)] = sentinel
        if i % 3 == 0:
            neighbors[i, rng.integers(n)] = g_nan + int(i % 2)
            nan_rows.add(int(i))
    numneigh[:2] = 0
    border_map = rng.integers(0, nlat, nrows - 1 - npad)
    border_map[-2:] = sentinel
    return dict(x=x, neighbors=neighbors, numneigh=numneigh, border_map=border_map,
                nlocal_pad=npad, empty=[0, 1, at, nan_i, *range(nan_i + 1, npad)],
                inside=inside, nan_rows=sorted(nan_rows))


def verlet_eam_block_case(np_dtype, k: int, nlocal: int, seed: int = 0) -> dict:
    """A numpy case for K5 and K6 at the edges of a list layout, in the
    form of verlet_eam_case: `nlocal` local atoms (= nlocal_pad) and as
    many ghosts plus 40 at random in a 9 A cube, lists of width `k` of
    random rows (never the atom itself; repeats allowed, as the contract
    does not forbid them) with the sentinel row mid-list. Local row 0
    lists exactly k entries, row 1 k + 5 (past the width), rows 16 to 31
    none (a block of 16 empty rows), the others 1 to k; the last local
    row lists first a ghost 1.0 A away along y (`inside`). Every entry
    past a row's count is the sentinel."""
    from mdbench_tpu_torch.state import SENTINEL_COORD

    rng = np.random.default_rng(seed)
    nghost = nlocal + 40
    nrows = nlocal + nghost + 1
    sentinel = nrows - 1
    x = np.concatenate([rng.uniform(0.0, 9.0, (nlocal + nghost, 3)),
                        [[SENTINEL_COORD] * 3]]).astype(np_dtype)
    inside = nlocal - 1
    x[nlocal] = x[inside] + np.array([0.0, 1.0, 0.0], np_dtype)
    numneigh = rng.integers(1, k + 1, nlocal).astype(np.int64) if k else np.zeros(
        nlocal, np.int64)
    numneigh[0] = k
    if nlocal > 1:
        numneigh[1] = k + 5
    numneigh[16:32] = 0
    neighbors = np.full((nlocal, k), sentinel, np.int64)
    for i in range(nlocal):
        rows = rng.integers(0, nrows - 1, k)
        rows[rows == i] = sentinel
        if k > 2:
            rows[k // 2] = sentinel
        neighbors[i, : min(int(numneigh[i]), k)] = rows[: min(int(numneigh[i]), k)]
    if k:
        neighbors[inside, 0] = nlocal
        numneigh[inside] = max(int(numneigh[inside]), 1)
    border_map = rng.integers(0, nlocal, nghost)
    return dict(x=x, neighbors=neighbors, numneigh=numneigh, border_map=border_map,
                nlocal_pad=nlocal, empty=[i for i in range(nlocal) if numneigh[i] == 0],
                inside=inside, nan_rows=[])


def verlet_eam_edge_cases(np_dtype, seed: int = 0) -> dict:
    """Every edge case of K5 and K6 by name: verlet_eam_case ("lattice"),
    and verlet_eam_block_case with an odd width (rows start 8 bytes off a
    16-byte boundary) over 53 atoms (no multiple of a block's 8 warps, a
    block of 16 empty rows, rows at and past the width) and with a single
    local atom (one block, one warp busy)."""
    return {"lattice": verlet_eam_case(np_dtype, seed),
            "odd k": verlet_eam_block_case(np_dtype, 37, 53, seed),
            "one atom": verlet_eam_block_case(np_dtype, 5, 1, seed)}


PRUNE_CUTSQ = 2.8**2  # the prune cases' cutoff: cutneigh of the LJ box, inexact in float32


def prune_case(np_dtype, seed: int = 0, nu: int = 24, cc: int = 50,
               rcap: int = 64) -> dict:
    """A numpy case for the exact prune (ops/verlet._exact_prune) at
    PRUNE_CUTSQ: 64 16-row blocks of x, the first nu the local units, the
    last all at SENTINEL_COORD (its id is sent16). Each block's atoms lie
    within 1.2 of its centre, the centres uniform in a box of side 12, so
    some candidates are in range and some not; ~10% of the atoms are
    padding (SENTINEL_COORD; validu False in the units), unit 5 all of
    them. Each unit lists cc random ids (cc no multiple of 32), its own
    first, sent16 mid-list and, in every third unit, in its last 7 slots.
    Returns x (nrows, 3), cand (nu, cc) int64, validu (nu, 16) bool,
    nlocal_pad, cutsq, rcap and sent16."""
    from mdbench_tpu_torch.state import SENTINEL_COORD

    rng = np.random.default_rng(seed)
    n16 = 64
    x = (rng.uniform(0.0, 12.0, (n16, 1, 3))
         + rng.uniform(-1.2, 1.2, (n16, 16, 3))).reshape(-1, 3)
    pad = rng.random(n16 * 16) < 0.1
    pad[5 * 16 : 6 * 16] = True
    pad[(n16 - 1) * 16 :] = True
    x[pad] = SENTINEL_COORD
    sent16 = n16 - 1
    cand = rng.integers(0, sent16, (nu, cc))
    cand[:, 0] = np.arange(nu)
    cand[:, cc // 2] = sent16
    cand[::3, -7:] = sent16
    return dict(x=x.astype(np_dtype), cand=cand.astype(np.int64),
                validu=~pad[: nu * 16].reshape(nu, 16), nlocal_pad=16 * nu,
                cutsq=PRUNE_CUTSQ, rcap=rcap, sent16=sent16)


def prune_boundary_case(np_dtype) -> dict:
    """The prune's cutoff edge in `np_dtype`, at PRUNE_CUTSQ: unit 0 is one
    real atom at the origin (15 padding atoms), unit 1 16 real atoms far
    away; block 2 holds one atom at (-dx, -dy, 0) whose rsq from the
    origin is exactly PRUNE_CUTSQ rounded to np_dtype (kept: torch
    compares in x's dtype; in float32 that value lies above the float64
    cutoff), block 3 the same with dx one ulp longer (dropped), block 4
    the pair along (y, z) instead (kept), block 5 one ulp shorter (kept),
    block 6 only padding atoms (dropped), block 7 the sentinel block.
    Returns the fields of prune_case."""
    from mdbench_tpu_torch.state import SENTINEL_COORD

    t = np_dtype
    c = t(PRUNE_CUTSQ)

    def rsq(d):
        d = [t(v) for v in d]
        return t(t(t(d[0] * d[0]) + t(d[1] * d[1])) + t(d[2] * d[2]))

    # (dx, dy) with rsq exactly c: along x alone in float64; in float32 no
    # float is sqrt(c) to the last bit, so a grid of dy is searched
    pair = next((dx, t(k / 8)) for k in range(23)
                for dx0 in [t(np.sqrt(float(c) - (k / 8) ** 2))]
                for dx in [dx0, *(np.nextafter(dx0, t(s * np.inf)) for s in (1, -1))]
                if rsq((dx, k / 8, 0.0)) == c)
    dx, dy = pair
    up, down = np.nextafter(dx, t(np.inf)), np.nextafter(dx, t(0.0))
    atoms = {2: (dx, dy, 0.0), 3: (up, dy, 0.0), 4: (0.0, dx, dy), 5: (down, dy, 0.0)}
    assert rsq(atoms[2]) == c and rsq(atoms[4]) == c
    assert rsq(atoms[3]) > c and rsq(atoms[5]) <= c
    x = np.full((8, 16, 3), SENTINEL_COORD)
    x[0, 0] = 0.0
    x[1] = 50.0
    x[1, :, 0] += 3.0 * np.arange(16)
    for b, a in atoms.items():
        x[b, 7] = np.negative(a)
    validu = np.zeros((2, 16), bool)
    validu[0, 0] = True
    validu[1] = True
    sent16 = 7
    cand = np.array([[0, 1, 2, 3, 4, 5, 6, sent16, 2],
                     [1, 0, 2, 3, sent16, 4, sent16, sent16, sent16]], np.int64)
    return dict(x=x.reshape(-1, 3).astype(np_dtype), cand=cand, validu=validu,
                nlocal_pad=32, cutsq=PRUNE_CUTSQ, rcap=8, sent16=sent16)


def prune_edge_cases(np_dtype, seed: int = 0) -> dict:
    """Every edge case of the prune by name: "random" (prune_case),
    "overflow" (the same with rcap 8, which most units' kept rows pass),
    "nan" (the same with NaN in a real atom of unit 2, in atom 0 of unit 3
    made padding, in an atom of block 40, and +inf in a real atom of unit
    4 and in an atom of block 41: inf - inf is NaN), "boundary"
    (prune_boundary_case) and "wide" (300 candidates a unit, rcap 304)."""
    nan = prune_case(np_dtype, seed + 1)
    x, validu = nan["x"].reshape(64, 16, 3), nan["validu"]
    x[2, int(np.flatnonzero(validu[2])[0]), 1] = np.nan
    x[3, 0, 0], validu[3, 0] = np.nan, False
    x[40, 0, 2] = np.nan
    x[4, int(np.flatnonzero(validu[4])[0]), 0] = np.inf
    x[41, 3, 0] = np.inf
    return {"random": prune_case(np_dtype, seed),
            "overflow": prune_case(np_dtype, seed + 2, rcap=8),
            "nan": nan,
            "boundary": prune_boundary_case(np_dtype),
            "wide": prune_case(np_dtype, seed + 3, nu=40, cc=300, rcap=304)}


RANGES_BOX = (11.0, 12.5, 14.0)  # the ranges cases' box: 3 x 4 x 5 bins of cutneigh 2.8


def _np_flat_bins(x, grid, np_dtype):
    """ops/cells.coord_to_bin in numpy for finite rows: floor(x / binsize)
    + 1 in np_dtype (as torch divides a tensor by a Python float),
    clipped into the grid, z fastest."""
    b = [np.clip(np.floor(x[:, d].astype(np_dtype) / np_dtype(grid.binsize[d])) + 1, 0,
                 grid.dims[d] - 1).astype(np.int64) for d in range(3)]
    return (b[0] * grid.dims[1] + b[1]) * grid.dims[2] + b[2]


def ranges_case(np_dtype, seed: int = 0, ucol: int = 4, kcap: int = 64, ccap: int = 256,
                ghosts: bool = True, nan: bool = False) -> dict:
    """A numpy case for the ranges build's candidate stage
    (ops/verlet._range_candidates) in RANGES_BOX at cutneigh 2.8: 1,625
    locals uniform at the LJ box's density, 12 of them moved just past a
    face (their bins in the margin ring, whose stencils reach past the
    grid), sorted by bin as the engine sorts them; nlocal_pad 1,664, so
    unit 101 holds 9 real atoms and units 102-103 none; with `ghosts`,
    ~3,300 ghosts at the same density in the shell of width cutneigh
    around the box, sorted by bin, and 37 sentinel rows in their block
    (gcap a multiple of 16), else gcap 0; then 16 sentinel rows. Units
    that hold two columns put overlapping and duplicate ranges in the
    shared stencil columns. `nan` puts a NaN in the y of a real atom of
    unit 40. Returns x (nrows, 3), nlocal, nlocal_pad, gcap, prd,
    cutneigh, ucol, kcap and ccap."""
    from mdbench_tpu_torch.ops.cells import make_cell_grid
    from mdbench_tpu_torch.state import SENTINEL_COORD

    rng = np.random.default_rng(seed)
    prd, cut = np.array(RANGES_BOX), 2.8
    grid = make_cell_grid(prd, cut, 0.8442)
    nlocal, nlocal_pad = 1625, 1664
    xl = rng.uniform(0.0, 1.0, (nlocal, 3)) * prd
    for k, i in enumerate(rng.choice(nlocal, 12, replace=False)):
        d = k % 3
        xl[i, d] = -0.05 if k < 6 else prd[d] + 0.05
    xl = xl.astype(np_dtype)
    xl = xl[np.argsort(_np_flat_bins(xl, grid, np_dtype), kind="stable")]
    if ghosts:
        xg = rng.uniform(0.0, 1.0, (4970, 3)) * (prd + 2 * cut) - cut
        xg = xg[((xg < 0.0) | (xg >= prd)).any(1)].astype(np_dtype)
        xg = xg[np.argsort(_np_flat_bins(xg, grid, np_dtype), kind="stable")]
        gcap = (len(xg) + 37 + 15) // 16 * 16
    else:
        xg, gcap = np.zeros((0, 3), np_dtype), 0
    x = np.full((nlocal_pad + gcap + 16, 3), SENTINEL_COORD, np_dtype)
    x[:nlocal] = xl
    x[nlocal_pad : nlocal_pad + len(xg)] = xg
    if nan:
        x[40 * 16 + 5, 1] = np.nan
    return dict(x=x, nlocal=nlocal, nlocal_pad=nlocal_pad, gcap=gcap,
                prd=tuple(float(v) for v in prd), cutneigh=cut, ucol=ucol, kcap=kcap,
                ccap=ccap)


def ranges_edge_cases(np_dtype) -> dict:
    """Every edge case of the ranges build's candidate stage by name (each
    a ranges_case): "random" (the defaults, with room over every unit's
    columns, ranges and candidates: padding atoms, units without a real
    atom, margin columns, overlapping and duplicate ranges),
    "ucol" (ucol 1, which units of two columns pass), "kcap" (kcap 8,
    which most units' ranges pass), "narrow" (ccap 40, no multiple of 32,
    which most units' candidates pass), "gcap0" (no ghost block) and "nan"
    (a NaN coordinate in a real atom)."""
    return {"random": ranges_case(np_dtype, 0),
            "ucol": ranges_case(np_dtype, 1, ucol=1),
            "kcap": ranges_case(np_dtype, 2, kcap=8),
            "narrow": ranges_case(np_dtype, 3, ccap=40),
            "gcap0": ranges_case(np_dtype, 4, ghosts=False),
            "nan": ranges_case(np_dtype, 5, nan=True)}


def ranges_tensors(torch, case: dict, device) -> tuple:
    """A ranges case's operands as _range_candidates takes them: (grid,
    x, nlocal, nlocal_pad, gcap, cutneigh, ucol, kcap, ccap), x on
    `device`."""
    from mdbench_tpu_torch.ops.cells import make_cell_grid

    grid = make_cell_grid(np.array(case["prd"]), case["cutneigh"], 0.8442)
    return (grid, torch.from_numpy(case["x"]).to(device), case["nlocal"],
            case["nlocal_pad"], case["gcap"], case["cutneigh"], case["ucol"],
            case["kcap"], case["ccap"])


def prune_operands(sim, state) -> tuple:
    """The operands of the exact prune in a rebuild of `sim` (an
    engine.Simulation on row lists) from `state`: the arguments of the one
    ops/verlet._exact_prune call that sim._reneighbor makes."""
    from mdbench_tpu_torch.ops import verlet

    real, seen = verlet._exact_prune, []

    def spy(*args):
        seen.append(args)
        return real(*args)

    verlet._exact_prune = spy
    try:
        sim._reneighbor(state.x, state.types)
    finally:
        verlet._exact_prune = real
    if len(seen) != 1:
        fail(f"a rebuild called the exact prune {len(seen)} times, not once")
    return seen[0]


def prune_tensors(torch, case: dict, device) -> tuple:
    """A prune case's operands as _exact_prune takes them: (x, cand,
    nlocal_pad, validu, cutsq, rcap, sent16) on `device`."""
    return (torch.from_numpy(case["x"]).to(device),
            torch.from_numpy(case["cand"]).to(device), case["nlocal_pad"],
            torch.from_numpy(case["validu"]).to(device), case["cutsq"], case["rcap"],
            case["sent16"])


def sweep_edge_calls(torch, dev, np_dtype, share: int, nan: bool, poly) -> tuple:
    """The exact-list kernels and their plain versions on
    boundary_ilist_case(np_dtype, share, nan): (calls, planes, plain
    planes, n_clusters_pad). calls maps a name to (kernel, plain), each
    taking the coordinate planes: K1 and K1t (two random types, random
    tables; both also take approx_rcp), K2 and K3 (cutoff 2.5 A, the EAM
    polynomials `poly`, a random fp plane), and K1b, K2b and K3b over a
    hand plan with a zero tier and dummy units, K1bt, K2bt and K3bt over
    one with a truncating bucket. The plain versions take the planes with
    the NaN rows as padding."""
    from mdbench_tpu_torch.ops import eam_cluster as ec
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops.cluster import bucket_maps_core

    dtype = torch.float32 if np_dtype == np.float32 else torch.float64
    planes, ijl, nji, npad = boundary_ilist_case(np_dtype, share, nan)
    p_k = [torch.tensor(q, device=dev) for q in planes]
    p_r = [torch.tensor(q, device=dev)
           for q in boundary_ilist_case(np_dtype, share, False)[0]]
    rng = np.random.default_rng(share)
    tc = torch.tensor(rng.integers(0, 2, planes[0].shape), dtype=torch.int32, device=dev)
    tabs = tuple(torch.tensor(t, dtype=dtype, device=dev) for t in random_tables(share, 2))
    fp = torch.tensor(rng.normal(-10.0, 3.0, planes[0].shape), dtype=dtype, device=dev)
    cut2 = 2.5**2
    eam = (npad, cut2, poly)
    ljs = (npad, cut2, 1.0, 1.0)
    icap = ijl.shape[1]
    ijl, nji = torch.tensor(ijl, device=dev), torch.tensor(nji, device=dev)
    calls = {
        "K1": (lambda p, **k: lj.lj_cluster_force_ilist(*p, ijl, nji, *ljs, share=share,
                                                        **k),
               lambda p: lj.lj_cluster_force_ilist_ref(*p, ijl, *ljs, share=share)),
        "K1t": (lambda p, **k: lj.lj_cluster_force_ilist(*p, ijl, nji, *ljs, share=share,
                                                         tc=tc, tables=tabs, **k),
                lambda p: lj.lj_cluster_force_ilist_ref(*p, ijl, *ljs, share=share, tc=tc,
                                                        tables=tabs)),
        "K2": (lambda p: (ec.eam_rho_ilist(*p, ijl, nji, *eam, share=share),),
               lambda p: (ec.eam_rho_ilist_ref(*p, ijl, *eam, share=share),)),
        "K3": (lambda p: ec.eam_force_ilist(*p, fp, ijl, nji, *eam, share=share),
               lambda p: ec.eam_force_ilist_ref(*p, fp, ijl, *eam, share=share)),
    }
    for tag, trunc in (("", False), ("t", True)):
        plan = hand_plan(nji.cpu().numpy(), icap, trunc=trunc)
        bij, bcr, binv, _ = bucket_maps_core(ijl, nji, npad, share, p_k[0].shape[0], *plan)
        maps = (bij, bcr, binv)
        calls["K1b" + tag] = (
            lambda p, m=maps, plan=plan, **k: lj.lj_cluster_force_buckets(
                *p, *m, nji, npad, plan, *ljs[1:], share=share, **k),
            lambda p, m=maps, plan=plan: lj.lj_cluster_force_buckets_ref(
                *p, *m, npad, plan, *ljs[1:], share=share))
        calls["K2b" + tag] = (
            lambda p, m=maps, plan=plan: (ec.eam_rho_buckets(*p, *m, nji, *eam, plan,
                                                             share=share),),
            lambda p, m=maps, plan=plan: (ec.eam_rho_buckets_ref(*p, *m, *eam, plan,
                                                                 share),))
        calls["K3b" + tag] = (
            lambda p, m=maps, plan=plan: ec.eam_force_buckets(*p, fp, *m, nji, *eam, plan,
                                                              share=share),
            lambda p, m=maps, plan=plan: ec.eam_force_buckets_ref(*p, fp, *m, *eam, plan,
                                                                  share))
    return calls, p_k, p_r, npad


def check_sweep_edges(torch, dev, names, poly) -> None:
    """Phases 3, 7 and 20's edge cases: the kernels `names` of
    sweep_edge_calls, float32 and float64, share 1, 2, 4, with NaN rows,
    against their plain versions (rows 0-1 also on their own: their forces
    are small beside the dense rows'), within 1e-5 / 1e-12 of max |value|;
    rows 4-7 (no pair inside, or no list) exactly 0; two launches the same
    bits; K1b, K2b and K3b equal to K1, K2 and K3 bit for bit; the LJ
    kernels with approx_rcp within the tolerance in float32 and bit-equal
    in float64."""
    for np_dtype in (np.float32, np.float64):
        dtype = torch.float32 if np_dtype == np.float32 else torch.float64
        tol = tol_of(torch, dtype)
        for share in (1, 2, 4):
            calls, p_k, p_r, npad = sweep_edge_calls(torch, dev, np_dtype, share, True,
                                                     poly)
            worst = 0.0
            got = {}
            for name in names:
                kern, plain = calls[name]
                out, again = kern(p_k), kern(p_k)
                torch.cuda.synchronize()
                want = plain(p_r)
                for rows in (slice(0, 2), slice(0, npad)):
                    a, b = [t[rows] for t in out], [t[rows] for t in want]
                    if not any(bool(t.any()) for t in b):
                        if any(bool(t.any()) for t in a):
                            fail(f"{name} edge case: rows without a pair got a value")
                        continue
                    rel = rel_err(torch, a, b)[1]
                    worst = max(worst, rel)
                    if not rel <= tol:
                        fail(f"{name} edge case disagrees with its plain version "
                             f"({dtype}, share {share}): rel {rel:.3e}")
                if not all(torch.equal(a, b) and not bool(a[4:].any())
                           for a, b in zip(out, again)):
                    fail(f"{name} edge case: rows 4-7 not 0, or two launches differ")
                if name.startswith("K1"):
                    approx = kern(p_k, approx_rcp=True)
                    if dtype == torch.float64:
                        ok = all(torch.equal(a, b) for a, b in zip(approx, out))
                    else:
                        ok = rel_err(torch, approx, want)[1] <= tol
                    if not ok:
                        fail(f"{name} edge case with approx_rcp ({dtype}, share {share})")
                got[name] = out
            for name in got:
                if name.endswith("b") and name[:2] in got and not all(
                        torch.equal(a, b) for a, b in zip(got[name], got[name[:2]])):
                    fail(f"{name} edge case is not {name[:2]} bit for bit")
            print(f"edge cases {'/'.join(names)} {str(dtype)[6:]} share {share}: "
                  f"max rel err {worst:.3e} (tol {tol:.0e}); rows without a pair 0, "
                  f"repeat launches equal", flush=True)


def sweep_line(torch, lj, planes, lists, nji, share: int, cutsq, **kw) -> str:
    """A line of the exact-list kernels' work on these lists
    (ops/lj_cluster.ilist_sweep_counts; `kw`: buckets, tc, tables):
    listed and inside pairs, the warp steps of sweep A, sweep B's warp
    iterations and the staged atoms at which the earlier design's branch
    around the pair math was taken, and sweep B's efficiency."""
    c = lj.ilist_sweep_counts(*planes, lists, nji, share, cutsq, **kw)
    listed, inside = int(c["listed"].sum()), int(c["inside"].sum())
    return (f"sweep counts (chunk {lj.SWEEP_CHUNK}): listed {listed}, inside {inside} "
            f"({inside / max(listed, 1):.4f}); warp steps: sweep A {c['warp_sweep_a']}, "
            f"sweep B {c['warp_sweep_b']}, the earlier branch {c['warp_branch']}; "
            f"sweep B efficiency {c['efficiency']:.4f}")


def kernel_ptxas_lines(kernel: str, src_dir=None) -> list:
    """The -Xptxas -v lines (registers, shared memory, spills) of every
    instantiation of `kernel`, from the build's log (of the library built
    from `src_dir`, the package's csrc/ by default), each tagged with its
    mangled template arguments."""
    import re

    from mdbench_tpu_torch import _build

    log = _build.library_path(src_dir).with_suffix(".log")
    out, tag = [], None
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry" in line:
            m = re.search(kernel + r"I(\w+?)Ev", line)
            tag = m and f"{kernel}<{m[1]}>"
        elif tag and ("Used" in line or "spill" in line):
            out.append(f"{tag}: {line.strip()}")
    return out


def lockstep_lane_pairs(torch, ranges) -> int:
    """Lane-pairs of the group-window kernel's lock-step design (one
    128-thread block per group walking every tile below njg, a warp of 4
    members running a tile's 128 j atoms when the window of any of them
    holds it): warp tiles x 128 x 32, on these windows."""
    rg = ranges.long()
    njg = rg[:, 32]
    s = torch.arange(max(int(njg.max()), 1), device=rg.device)
    inwin = ((s >= rg[:, :16, None]) & (s < rg[:, 16:32, None])
             & (s < njg[:, None, None]))
    warp_tiles = int(inwin.reshape(rg.shape[0], 4, 4, -1).any(2).sum())
    return warp_tiles * 128 * 32


def stream_work_line(torch, lj, planes, pr, cutsq: float, cs: dict) -> tuple:
    """(pairs the group-window kernel evaluates, a line of its work counts
    on these lists: member tiles, the lock-step design's lane-pairs, the
    window and kept j-clusters and the lane-pairs it runs)."""
    w = {k: int(v.sum()) for k, v in lj.stream_work_counts(
        *planes, pr.jlist, pr.ranges, cutsq).items()}
    old = lockstep_lane_pairs(torch, pr.ranges)
    return w["lane_pairs"], (
        f"member tiles {w['tiles']} (stats {cs['tiles']}), window pairs "
        f"{cs['padded_pairs']}, {cs['pairs_within_cutforce']} inside the cutoff; "
        f"lock-step lane-pairs {old}; window j-clusters {w['window_clusters']}, "
        f"kept {w['kept_clusters']} ({w['kept_clusters'] / max(w['window_clusters'], 1):.4f}), "
        f"lane-pairs {w['lane_pairs']} ({old / max(w['lane_pairs'], 1):.3f}x fewer)")


def device_profile(torch, fn) -> dict:
    """One torch.profiler pass over fn(), synchronised before and after:
    wall_s (host clock, profiler overhead included), busy (the union of
    the device's kernel, memcpy and memset spans over wall_s;
    record_function ranges, which also show on the device, left out),
    spans (their count) and ms (device ms summed by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, ms = [], {}
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)  # newer torch only
        if e.device_type() != DeviceType.CUDA or (annotation and annotation()):
            continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        ms[e.name()] = ms.get(e.name(), 0.0) + e.duration_ns() * 1e-6
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return dict(wall_s=wall, busy=busy * 1e-9 / wall, spans=len(spans), ms=ms)


def reset_counts(lj, ec) -> None:
    """Every kernel's launch count to 0."""
    from mdbench_tpu_torch.ops import eam as ev

    for name in LJ_COUNTS:
        setattr(lj, name, 0)
    for counts in (ec.LAUNCHES, ev.LAUNCHES):
        for name in counts:
            counts[name] = 0


def hand_launches(lj, ec) -> dict:
    """Every kernel's launch count by name."""
    from mdbench_tpu_torch.ops import eam as ev

    return {**{name: getattr(lj, name) for name in LJ_COUNTS}, **ec.LAUNCHES,
            **ev.LAUNCHES}


@contextlib.contextmanager
def counted(cls, method: str, per_call=lambda *args: 1):
    """Counts the calls of cls.method while the block runs, each call
    weighted by per_call(*its arguments): yields a one-element list."""
    real, calls = getattr(cls, method), [0]

    def wrapped(self, *args, **kw):
        calls[0] += per_call(*args)
        return real(self, *args, **kw)

    setattr(cls, method, wrapped)
    try:
        yield calls
    finally:
        setattr(cls, method, real)


def check_verlet_eam_launches(lj, ec, evals: int, what: str) -> dict:
    """K5 (eam_rho_nlist) then K6 (eam_force_nlist) once each for each of
    the `evals` force evaluations (or domain forces) of `what`, and no
    other hand kernel; returns the counts."""
    counts = hand_launches(lj, ec)
    k5, k6 = counts.pop("eam_rho_nlist"), counts.pop("eam_force_nlist")
    if not (k5 == k6 == evals > 0) or any(counts.values()):
        fail(f"{what}: K5 {k5} and K6 {k6} launches for {evals} force evaluations, "
             f"other kernels {counts}")
    return {"K5": k5, "K6": k6}


def run_eam_phases(torch, dev, smi: str, ec) -> tuple:
    """Phases 7-10 (the cluster EAM path). Returns the kernels' JSON rows,
    the SP run's (sim, final state, launches) and the DP run's (sim,
    result)."""
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import run_bench_eam
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.engine_cluster import GROUP, ClusterSimulation
    from mdbench_tpu_torch.models.eam_tables import (
        apply_eam_overrides,
        fit_eam_poly,
        load_eam,
    )
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops.eam import EamDevice
    from mdbench_tpu_torch.probes import graph_ms
    from mdbench_tpu_torch.stats import compute_cluster_stats

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")
    write_standin_funcfl(eam_file)
    tables = load_eam(eam_file)
    poly = fit_eam_poly(tables)
    cut2 = tables.cut**2
    print(f"EAM potential: stand-in funcfl (Cu_u3's grid), polynomial fit "
          f"max_rel_err {poly.max_rel_err:.3e}", flush=True)

    def check(what, got, want, dtype):
        """rel_err of `got` against `want`; fails above the tolerance."""
        err, rel = rel_err(torch, got, want)
        if not rel <= tol_of(torch, dtype):
            fail(f"{what} disagrees with its plain version ({dtype}): rel {rel:.3e}")
        return err, rel

    phase(7)
    # 7. EAM kernels on random planes, lists and fp planes; the lattice
    # constant puts the nearest pairs just below the fit window (1.5 A)
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.float64):
        for share in (1, 2, 4):
            xc, yc, zc, ijl, nji, npad = random_case(
                torch, 10 + share, share, dtype, dev, spacing=1.45)
            fp = torch.tensor(rng.normal(-10.0, 3.0, tuple(xc.shape)),
                              dtype=dtype, device=dev)
            args = (npad, cut2, poly)
            rho = ec.eam_rho_ilist(xc, yc, zc, ijl, nji, *args, share=share)
            f = ec.eam_force_ilist(xc, yc, zc, fp, ijl, nji, *args, share=share)
            torch.cuda.synchronize()
            e2, r2 = check(f"eam_rho_ilist share {share}", (rho,),
                           (ec.eam_rho_ilist_ref(xc, yc, zc, ijl, *args, share=share),),
                           dtype)
            e3, r3 = check(f"eam_force_ilist share {share}", f,
                           ec.eam_force_ilist_ref(xc, yc, zc, fp, ijl, *args,
                                                  share=share), dtype)
            if any(bool((t[8:12] != 0).any()) for t in (rho, *f)):
                fail(f"padding units got a density or force ({dtype}, share {share})")
            print(f"EAM kernels random {str(dtype)[6:]} share {share}: rho max abs "
                  f"err {e2:.3e} rel {r2:.3e}; force max abs err {e3:.3e} rel "
                  f"{r3:.3e} (tol {tol_of(torch, dtype):.0e})", flush=True)
    check_sweep_edges(torch, dev, ("K2", "K3"), poly)

    phase(8)
    # 8. EAM main path at full width; count the kernels' launches in it:
    # K2 and K3 for the set-up forces before the bucket plan, K2b and K3b
    # for every force after it
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    sim, out, rate = run_bench_eam(eam_file, "sp", repeats=SEC_REPEATS,
                                   chain=SEC_CHAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ec.LAUNCHES)
    p = sim.params
    need = (1 + SEC_REPEATS * SEC_CHAIN) * (p.ntimes + 1)
    print(f"EAM main path: {sim.natoms} atoms, {p.ntimes} steps, {p.precision}, "
          f"cutforce {p.cutforce}, cutneigh {p.cutneigh}, n_clusters_pad "
          f"{sim.n_clusters_pad}, icap {sim.icap}, ghost_cap {sim.ghost_cap}, "
          f"list_cap {sim.list_cap}, grows {sim.grows or 'none'}, buckets {sim.buckets}")
    print(f"EAM main path: TOTAL {out.total_time:.6f} s per run, {rate:.6e} "
          f"atom-updates/s, run() wall {wall:.2f} s, on {smi}")
    lj_launches = {name: getattr(lj, name) for name in LJ_COUNTS}
    print(f"EAM main path: kernel launches {launches} (K2 and K3 >= 1 before the "
          f"plan, K2b and K3b each >= {need} force evaluations); LJ kernels "
          f"{lj_launches}", flush=True)
    if sim.buckets is None:
        fail("the EAM 131k run planned no capacity buckets")
    for name, n in launches.items():
        if n < (need if name.endswith("_buckets") else 1):
            fail(f"the EAM main path launched {name} {n} times")
    if any(lj_launches.values()):
        fail("the EAM main path launched an LJ kernel")
    temps = out.temps
    if temps.shape != (p.ntimes,) or not np.isfinite(temps).all():
        fail("EAM temperature trace is not finite or has the wrong shape")
    st = out.state
    for t in (st.vxc, st.fxc, st.clusters.xc[: sim.n_clusters_pad]):
        if not bool(torch.isfinite(t).all()):
            fail("the EAM run's final state is not finite")
    sim_dp, out_dp, _ = run_bench_eam(eam_file, "dp", repeats=1, chain=1)
    for step, tol in EAM_SP_TOL.items():
        t_sp, t_dp = float(temps[step - 1]), float(out_dp.temps[step - 1])
        rel = abs(t_sp - t_dp) / abs(t_dp)
        print(f"EAM step {step}: T sp {t_sp:.6e}, dp {t_dp:.6e}, rel {rel:.3e} "
              f"(tol {tol:.0e})", flush=True)
        if not rel <= tol:
            fail(f"EAM SP run departs from the DP run at step {step}")

    phase(9)
    # 9. EAM small input: card against the CPU plain path, float64
    kw = dict(nx=6, ny=6, nz=6, ntimes=40, reneigh_every=10, resort_every=20,
              precision="dp", scheme="cluster", force_field=FF_EAM,
              eam_file=eam_file)
    x, v, _ = create_fcc_lattice(apply_eam_overrides(Params(**kw), tables))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    f_cpu = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu").first_force_atoms()
    f_gpu = ClusterSimulation(Params(**kw), x=x, v=v, device=dev).first_force_atoms()
    frel = np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max()
    r_cpu = ClusterSimulation(Params(**kw), device="cpu").run(repeats=0)
    r_gpu = ClusterSimulation(Params(**kw), device=dev).run(repeats=0)
    trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
    print(f"EAM small input 6^3 dp: step-0 force rel err {frel:.3e} (tol 1e-10), "
          f"40-step temperature rel err {trel:.3e} (tol 1e-9)", flush=True)
    if not (frel <= 1e-10 and trel <= 1e-9):
        fail("the card's EAM run disagrees with the CPU plain path")

    phase(10)
    # 10. EAM kernels at the main path's shapes: the run's final state
    cl, pr = st.clusters, st.pairs
    npad, share = sim.n_clusters_pad, sim.ishare
    args = (npad, cut2, sim.eam_poly)
    cs = compute_cluster_stats(cl, pr, npad, GROUP, cut2, p.cutneigh**2)
    evaluated, inside = ilist_pairs(cs, share), cs["pairs_within_cutforce"]
    deg = {k: len(getattr(sim.eam_poly, k)) - 1 for k in ("dens", "g1", "g2")}
    ops = {"eam_rho_ilist": 8 * evaluated + (6 + 2 * deg["dens"]) * inside,
           "eam_force_ilist": 8 * evaluated + (10 + 2 * (deg["g1"] + deg["g2"])) * inside}
    print(f"EAM kernels at 131k: {evaluated} pairs evaluated, {inside} inside the "
          f"cutoff; Horner degrees {deg}; " + sweep_line(
              torch, lj, (cl.xc, cl.yc, cl.zc), pr.ijlist, pr.nji, share, cut2),
          flush=True)
    rows = {}
    for dtype in (torch.float32, torch.float64):
        planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]
        rho_ref = ec.eam_rho_ilist_ref(*planes, pr.ijlist, *args, share=share)
        fp = ec.fp_plane_from_rho(
            rho_ref, EamDevice.from_tables(sim.eam_tables, dev, dtype),
            st.halo.border_map, planes[0].shape[0])
        calls = {
            "eam_rho_ilist": (
                lambda: (ec.eam_rho_ilist(*planes, pr.ijlist, pr.nji, *args,
                                          share=share),),
                lambda: (ec.eam_rho_ilist_ref(*planes, pr.ijlist, *args,
                                              share=share),)),
            "eam_force_ilist": (
                lambda: ec.eam_force_ilist(*planes, fp, pr.ijlist, pr.nji,
                                           *args, share=share),
                lambda: ec.eam_force_ilist_ref(*planes, fp, pr.ijlist, *args,
                                               share=share)),
        }
        for name, (kern, plain) in calls.items():
            out = kern()
            err, rel = check(f"{name} at 131k", out, plain(), dtype)
            ms, dev_ms = median_ms(torch, kern, 50), graph_ms(kern, 50)
            plain_ms = median_ms(torch, plain, 5)
            moved = nbytes_of(*planes, pr.ijlist, pr.nji, *out) + (
                nbytes_of(fp) if name == "eam_force_ilist" else 0)
            bound = bound_of(ops[name], moved, dtype)
            print(f"{name} at 131k ({str(dtype)[6:]}, {pr.ijlist.shape[0]} units x "
                  f"icap {pr.ijlist.shape[1]}, share {share}): max abs err {err:.3e}, "
                  f"rel {rel:.3e} (tol {tol_of(torch, dtype):.0e}); median kernel "
                  f"{ms:.4f} ms back to back, {dev_ms:.4f} ms on the device (CUDA "
                  f"graph), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]}) on {smi}", flush=True)
            if dtype == torch.float32:
                rows[name] = kernel_row(EAM_KERNELS[name], launches[name], err, ms,
                                        plain_ms, bound, device_ms=dev_ms)
    for line in kernel_ptxas_lines("eam_ilist_kernel"):
        print("  " + line)
    return [rows[name] for name in EAM_KERNELS], (sim, st, launches), (sim_dp, out_dp)


def stub_force_err(torch, got, want):
    """(max abs error, that / max finite |want|, finite share) of the
    stub's float32 forces: the non-finite entries (NaN, +inf, -inf) of
    `got` must be those of `want`; the finite ones are compared."""
    a = torch.stack([t.double() for t in got])
    b = torch.stack([t.double() for t in want])
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(test(a), test(b)):
            fail("the stub's non-finite forces differ from the plain version's")
    fin = torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0, 0.0, 0.0
    err = float((a[fin] - b[fin]).abs().max())
    return err, err / float(b[fin].abs().max()), float(fin.double().mean())


def run_group_phases(torch, dev, smi: str, ec, k1_exact: dict) -> dict:
    """Phases 11-15 (the group-window path). `k1_exact` holds phase 6's
    K1 exact ms by dtype. Returns the kernel's JSON row."""
    from mdbench_tpu_torch.bench import run_bench
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import GROUP, ClusterSimulation
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.probes import graph_ms
    from mdbench_tpu_torch.stats import compute_cluster_stats
    from mdbench_tpu_torch.stub import (
        create_cluster_pair_list,
        create_stub_clusters,
        run_cluster_stub,
    )

    phase(11)
    # 11. the kernel on random group lists
    for dtype in (torch.float32, torch.float64):
        for seed in (1, 2, 3):
            planes, jl, rg, npad = random_group_lists(seed, ng=64, L=40)
            xc, yc, zc = (torch.tensor(q, dtype=dtype, device=dev) for q in planes)
            jl, rg = torch.tensor(jl, device=dev), torch.tensor(rg, device=dev)
            args = (npad, 2.5**2, 1.0, 1.0)
            got = lj.lj_cluster_force_stream(xc, yc, zc, jl, rg, *args)
            torch.cuda.synchronize()
            want = lj.lj_cluster_force_group_ref(xc, yc, zc, jl, *args, ranges=rg)
            err, rel = rel_err(torch, got, want)
            if any(bool((f[16:32] != 0).any()) for f in got):
                fail(f"the all-padding group got a force ({dtype}, seed {seed})")
            print(f"group kernel random {str(dtype)[6:]} seed {seed}: max abs err "
                  f"{err:.3e}, rel {rel:.3e} (tol {tol_of(torch, dtype):.0e})",
                  flush=True)
            if not rel <= tol_of(torch, dtype):
                fail(f"group kernel disagrees with its plain version ({dtype})")
        # the box cull's edge cases; NaN atoms take no pair, so the kernel
        # on the NaN rows must give the plain force with padding there
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        for nan in (False, True):
            planes, jl, rg, npad = boundary_group_lists(np_dtype, nan=nan)
            ref_planes = boundary_group_lists(np_dtype, nan=False)[0]
            jl, rg = torch.tensor(jl, device=dev), torch.tensor(rg, device=dev)
            args = (npad, 2.5**2, 1.0, 1.0)
            got = lj.lj_cluster_force_stream(
                *(torch.tensor(q, device=dev) for q in planes), jl, rg, *args)
            want = lj.lj_cluster_force_group_ref(
                *(torch.tensor(q, device=dev) for q in ref_planes), jl, *args, ranges=rg)
            err, rel = rel_err(torch, got, want)
            zero = [1, *range(16, 32), *range(33, 48)]  # empty or fully culled
            if any(bool((f[zero] != 0).any()) for f in got):
                fail(f"group kernel edge cases: a row without pairs got a force ({dtype})")
            print(f"group kernel edge cases {str(dtype)[6:]} (NaN rows {nan}): max abs "
                  f"err {err:.3e}, rel {rel:.3e} (tol {tol_of(torch, dtype):.0e})",
                  flush=True)
            if not rel <= tol_of(torch, dtype):
                fail(f"group kernel disagrees with its plain version on the edge cases "
                     f"({dtype}, NaN rows {nan})")

    phase(12)
    # 12. the group-window main path; count the kernels' launches in it
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    sim, out, rate = run_bench(repeats=SEC_REPEATS, chain=SEC_CHAIN, kernel="pallas")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lj.STREAM_LAUNCHES
    others = {name: getattr(lj, name) for name in LJ_COUNTS if name != "STREAM_LAUNCHES"}
    p = sim.params
    need = (1 + SEC_REPEATS * SEC_CHAIN) * (p.ntimes + 1)
    st = out.state
    cs = compute_cluster_stats(st.clusters, st.pairs, sim.n_clusters_pad, GROUP,
                               p.cutforce**2, p.cutneigh**2)
    print(f"group main path: {sim.natoms} atoms, {p.ntimes} steps, {p.precision}, "
          f"kernel {p.kernel}, n_clusters_pad {sim.n_clusters_pad}, list_cap "
          f"{sim.list_cap}, ghost_cap {sim.ghost_cap}, grows {sim.grows or 'none'}")
    print(f"group main path: golden gate passed; TOTAL {out.total_time:.6f} s per "
          f"run, {rate:.6e} atom-updates/s, run() wall {wall:.2f} s, on {smi}")
    print(f"group main path: group kernel launches {launches} (>= {need} force "
          f"evaluations); other LJ kernels {others}; EAM {dict(ec.LAUNCHES)}")
    print(f"group main path: final-state counters {cs}", flush=True)
    if launches < need:
        fail(f"the group main path launched the group kernel {launches} times, "
             f"fewer than its {need} force evaluations")
    if any(others.values()) or any(ec.LAUNCHES.values()):
        fail("the group main path launched another force kernel")
    temps = out.temps
    if temps.shape != (p.ntimes,) or not np.isfinite(temps).all():
        fail("group temperature trace is not finite or has the wrong shape")
    for t in (st.vxc, st.fxc, st.clusters.xc[: sim.n_clusters_pad]):
        if not bool(torch.isfinite(t).all()):
            fail("the group run's final state is not finite")
    print("group main path temps:", " ".join(
        f"{s}:{temps[s - 1]:.6e}" for s in range(p.reneigh_every, p.ntimes + 1,
                                                    p.reneigh_every)))
    # one profiled run of the timed region's kind, after the counts were read
    s0 = sim.initial_state()
    prof = device_profile(torch, lambda: sim._run_steps(s0, p.ntimes))
    k4_ms = sum(v for k, v in prof["ms"].items() if "lj_cluster_stream_kernel" in k)
    dev_ms = sum(prof["ms"].values())
    print(f"group main path profile (torch.profiler, one _run_steps({p.ntimes})): "
          f"wall {prof['wall_s']:.6f} s profiled, {prof['spans']} device spans, busy "
          f"{prof['busy']:.4f} of it; K4 {k4_ms:.4f} ms summed on the device, all "
          f"kernels and copies {dev_ms:.4f} ms; against the unprofiled TOTAL "
          f"{out.total_time:.6f} s: K4 {k4_ms * 1e-3 / out.total_time:.4f}, device "
          f"{dev_ms * 1e-3 / out.total_time:.4f}; on {smi}", flush=True)
    if prof["spans"] == 0:
        print("group main path profile: the profiler saw no device span "
              "(busy share not measured)", flush=True)

    phase(13)
    # 13. small input: card against the CPU plain path, float64
    base = dict(nx=6, ny=6, nz=6, ntimes=40, reneigh_every=10, resort_every=20,
                precision="dp", scheme="cluster")
    x, v, _ = create_fcc_lattice(Params(**base))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    for extra in ({"kernel": "pallas"}, {"kernel": "pallas", "prune_every": 3},
                  {"half_neigh": 1}):
        kw = {**base, **extra}
        f_cpu = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu").first_force_atoms()
        f_gpu = ClusterSimulation(Params(**kw), x=x, v=v, device=dev).first_force_atoms()
        frel = np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max()
        r_cpu = ClusterSimulation(Params(**kw), device="cpu").run(repeats=0)
        r_gpu = ClusterSimulation(Params(**kw), device=dev).run(repeats=0)
        trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
        print(f"group small input 6^3 dp {extra}: step-0 force rel err {frel:.3e} "
              f"(tol 1e-10), 40-step temperature rel err {trel:.3e} (tol 1e-9)",
              flush=True)
        if not (frel <= 1e-10 and trel <= 1e-9):
            fail(f"the card's run {extra} disagrees with the CPU plain path")

    phase(14)
    # 14. the kernel at the main path's shapes: the run's final state
    cl, pr = st.clusters, st.pairs
    npad = sim.n_clusters_pad
    cut = (p.cutforce**2, p.sigma6, p.epsilon)
    res = {}
    for dtype in (torch.float32, torch.float64):
        planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]

        def kern():
            return lj.lj_cluster_force_stream(*planes, pr.jlist, pr.ranges, npad, *cut)

        def plain():
            return lj.lj_cluster_force_group_ref(*planes, pr.jlist, npad, *cut,
                                                 ranges=pr.ranges)

        out = kern()
        err, rel = rel_err(torch, out, plain())
        ms = median_ms(torch, kern, 50)
        ms_dev = graph_ms(kern, 50)
        plain_ms = median_ms(torch, plain, 5)
        bound = bound_of(lj_ops(cs["padded_pairs"], cs["pairs_within_cutforce"]),
                         nbytes_of(*planes, pr.jlist, pr.ranges, *out), dtype)
        res[dtype] = (err, ms, plain_ms, bound)
        evaluated, work = stream_work_line(torch, lj, planes, pr, cut[0], cs)
        print(f"group kernel at 131k ({str(dtype)[6:]}, {pr.jlist.shape[0]} groups x "
              f"L {pr.jlist.shape[1]}, {cs['padded_pairs']} window pairs = "
              f"{cs['padded_pairs'] / (ms * 1e-3):.4e} pairs/s): max abs err "
              f"{err:.3e}, rel {rel:.3e} (tol {tol_of(torch, dtype):.0e}); median "
              f"kernel {ms:.4f} ms back to back, {ms_dev:.4f} ms on the device (CUDA "
              f"graph); K1 exact on phase 4's lists {k1_exact[dtype]:.4f} ms, K4 / K1 "
              f"exact {ms / k1_exact[dtype]:.4f}; plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}; window pairs), {evaluated} pairs "
              f"evaluated on {smi}", flush=True)
        print(f"group kernel work at 131k ({str(dtype)[6:]}): {work}", flush=True)
        if not rel <= tol_of(torch, dtype):
            fail(f"group kernel disagrees with its plain version at 131k ({dtype})")
    for line in kernel_ptxas_lines("lj_cluster_stream_kernel"):
        print("  " + line)

    phase(15)
    # 15. the cluster stub on the card
    for pattern in ("seq", "fix", "rand"):
        before = lj.STREAM_LAUNCHES
        r = run_cluster_stub(natoms=65536, nneighs=76, ntimes=200, pattern=pattern,
                             device=dev)
        n = lj.STREAM_LAUNCHES - before
        if n < 2 * r["ntimes"]:
            fail(f"the stub ({pattern}) launched the group kernel {n} times for "
                 f"{2 * r['ntimes']} steps")
        xch, ych, zch, n_pad = create_stub_clusters((65536 + 7) // 8, GROUP)
        jlh, rgh, _ = create_cluster_pair_list(n_pad, GROUP, 76, pattern)
        jl = torch.tensor(jlh[:, 0], device=dev)
        rg = torch.tensor(rgh[:, 0], device=dev)
        args = (n_pad, 1.0e12, 1.0, 1.0)
        planes = [torch.tensor(q, dtype=torch.float32, device=dev)
                  for q in (xch, ych, zch)]
        err, rel, fin = stub_force_err(
            torch, r["first_force"],
            lj.lj_cluster_force_group_ref(*planes, jl, *args, ranges=rg))
        ms = median_ms(torch, lambda: lj.lj_cluster_force_stream(
            *planes, jl, rg, *args), 50)
        # float64, where every stub force is finite
        p64 = [q.double() for q in planes]
        _, rel64 = rel_err(torch, lj.lj_cluster_force_stream(*p64, jl, rg, *args),
                           lj.lj_cluster_force_group_ref(*p64, jl, *args, ranges=rg))
        print(f"stub {pattern}: {r['mega_updates']:.4f} Mega atom updates/s "
              f"(TOTAL {r['total']:.6f} s, {n} kernel launches); first force: "
              f"{fin:.3f} of it finite, max abs err {err:.3e}, rel {rel:.3e} "
              f"(tol 1e-05) there; float64 rel {rel64:.3e} (tol 1e-12); kernel on "
              f"the stub's first planes {ms:.4f} ms on {smi}", flush=True)
        if not (rel <= 1e-5 and rel64 <= 1e-12):
            fail(f"the stub's first force ({pattern}) disagrees with the plain version")

    return kernel_row(STREAM_KERNEL, launches, *res[torch.float32])


def run_typed_phases(torch, dev, smi: str, ec) -> list:
    """Phases 16-19 (the typed LJ path from an atom file). Returns the
    typed kernels' JSON rows."""
    import tempfile

    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import root_bench, run_bench_file
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import GROUP, ClusterSimulation
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.probes import graph_ms
    from mdbench_tpu_torch.stats import compute_cluster_stats

    def tables_on(tabs, dtype):
        return tuple(torch.tensor(t, dtype=dtype, device=dev) for t in tabs)

    def check(what, got, want, dtype):
        err, rel = rel_err(torch, got, want)
        if not rel <= tol_of(torch, dtype):
            fail(f"{what} disagrees ({dtype}): rel {rel:.3e}")
        return err, rel

    uniform2 = (np.ones((2, 2)), np.ones((2, 2)), np.full((2, 2), 2.5**2))

    phase(16)
    # 16. typed kernels on random lists and windows
    for dtype in (torch.float32, torch.float64):
        for ntypes in (2, 3):
            for share in (1, 2, 4):
                xc, yc, zc, ijl, nji, npad = random_case(
                    torch, 20 + share, share, dtype, dev)
                rng = np.random.default_rng(30 + share)
                tc = torch.tensor(rng.integers(0, ntypes, tuple(xc.shape)),
                                  dtype=torch.int32, device=dev)
                tabs = tables_on(random_tables(ntypes + share, ntypes), dtype)
                args = (npad, 2.5**2, 1.0, 1.0)
                got = lj.lj_cluster_force_ilist(xc, yc, zc, ijl, nji, *args,
                                                share=share, tc=tc, tables=tabs)
                torch.cuda.synchronize()
                err, rel = check(f"K1t share {share} T {ntypes}", got,
                                 lj.lj_cluster_force_ilist_ref(
                                     xc, yc, zc, ijl, *args, share=share, tc=tc,
                                     tables=tabs), dtype)
                if any(bool((f[8:12] != 0).any()) for f in got):
                    fail(f"K1t: padding units got a force ({dtype}, share {share})")
                print(f"K1t random {str(dtype)[6:]} share {share} T {ntypes}: max abs "
                      f"err {err:.3e}, rel {rel:.3e} (tol {tol_of(torch, dtype):.0e})",
                      flush=True)
            # uniform tables: the untyped kernel's force
            got = lj.lj_cluster_force_ilist(xc, yc, zc, ijl, nji, *args, share=share,
                                            tc=tc % 2, tables=tables_on(uniform2, dtype))
            want = lj.lj_cluster_force_ilist(xc, yc, zc, ijl, nji, *args, share=share)
            _, rel_u = check("K1t with uniform tables against K1", got, want, dtype)
            for seed in (1, 2):
                planes, jl, rg, npad = random_group_lists(seed, ng=64, L=40)
                xc, yc, zc = (torch.tensor(q, dtype=dtype, device=dev) for q in planes)
                jl, rg = torch.tensor(jl, device=dev), torch.tensor(rg, device=dev)
                rng = np.random.default_rng(40 + seed)
                tc = torch.tensor(rng.integers(0, ntypes, tuple(xc.shape)),
                                  dtype=torch.int32, device=dev)
                tabs = tables_on(random_tables(ntypes + 10 * seed, ntypes), dtype)
                args = (npad, 2.5**2, 1.0, 1.0)
                got = lj.lj_cluster_force_stream(xc, yc, zc, jl, rg, *args, tc=tc,
                                                 tables=tabs)
                torch.cuda.synchronize()
                err, rel = check(f"K4t seed {seed} T {ntypes}", got,
                                 lj.lj_cluster_force_group_ref(
                                     xc, yc, zc, jl, *args, ranges=rg, tc=tc,
                                     tables=tabs), dtype)
                if any(bool((f[16:32] != 0).any()) for f in got):
                    fail(f"K4t: the all-padding group got a force ({dtype}, seed {seed})")
                print(f"K4t random {str(dtype)[6:]} seed {seed} T {ntypes}: max abs "
                      f"err {err:.3e}, rel {rel:.3e} (tol {tol_of(torch, dtype):.0e})",
                      flush=True)
            got = lj.lj_cluster_force_stream(xc, yc, zc, jl, rg, *args, tc=tc % 2,
                                             tables=tables_on(uniform2, dtype))
            want = lj.lj_cluster_force_stream(xc, yc, zc, jl, rg, *args)
            _, rel_u4 = check("K4t with uniform tables against K4", got, want, dtype)
            # the box cull's edge cases (phase 11's), culled against the
            # tables' largest cutsq
            np_dtype = np.float32 if dtype == torch.float32 else np.float64
            planes, jl, rg, npad = boundary_group_lists(np_dtype, nan=True)
            ref = boundary_group_lists(np_dtype, nan=False)[0]
            jl, rg = torch.tensor(jl, device=dev), torch.tensor(rg, device=dev)
            tc = torch.tensor(np.random.default_rng(50).integers(0, ntypes, planes[0].shape),
                              dtype=torch.int32, device=dev)
            tabs = tables_on(random_tables(ntypes + 20, ntypes), dtype)
            got = lj.lj_cluster_force_stream(
                *(torch.tensor(q, device=dev) for q in planes), jl, rg, npad, 2.5**2,
                1.0, 1.0, tc=tc, tables=tabs)
            err, rel = check(f"K4t edge cases T {ntypes}", got, lj.lj_cluster_force_group_ref(
                *(torch.tensor(q, device=dev) for q in ref), jl, npad, 2.5**2, 1.0, 1.0,
                ranges=rg, tc=tc, tables=tabs), dtype)
            print(f"K4t edge cases {str(dtype)[6:]} T {ntypes}: max abs err {err:.3e}, "
                  f"rel {rel:.3e} (tol {tol_of(torch, dtype):.0e})", flush=True)
            print(f"uniform tables {str(dtype)[6:]} T {ntypes}: K1t vs K1 rel "
                  f"{rel_u:.3e}, K4t vs K4 rel {rel_u4:.3e}", flush=True)

    check_golden = root_bench().check_golden
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = f"{tmp}/lj_two_types_131k.dmp"
        t0 = time.perf_counter()
        natoms = write_typed_dump(path)
        print(f"typed dump: {natoms} atoms, two types, written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        phase(17)
        # 17. the typed main path from the file, on both force paths
        counts, states, rates = {}, {}, {}
        for kernel, name in (("auto", "TYPED_LAUNCHES"),
                             ("pallas", "STREAM_TYPED_LAUNCHES")):
            reset_counts(lj, ec)
            t0 = time.perf_counter()
            sim, out, rate = run_bench_file(path, "sp", kernel, repeats=1, chain=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {n: getattr(lj, n) for n in LJ_COUNTS}
            p = sim.params
            need = 2 * (p.ntimes + 1)  # the checked run and the timed one
            print(f"typed main path {kernel}: {sim.natoms} atoms, {sim.ntypes} types "
                  f"from {p.input_file.rsplit('/', 1)[-1]}, {p.ntimes} steps, "
                  f"{p.precision}, n_clusters_pad {sim.n_clusters_pad}, icap "
                  f"{sim.icap}, list_cap {sim.list_cap}, grows {sim.grows or 'none'}")
            print(f"typed main path {kernel}: TOTAL {out.total_time:.6f} s per run, "
                  f"{rate:.6e} atom-updates/s, run() wall {wall:.2f} s (file read "
                  f"included), on {smi}")
            print(f"typed main path {kernel}: launches {got} (the typed kernel >= "
                  f"{need} force evaluations); EAM {dict(ec.LAUNCHES)}", flush=True)
            if sim.ntypes != 2 or sim.tables is None:
                fail("the typed dump did not run typed")
            if got[name] < need:
                fail(f"the typed main path ({kernel}) launched its kernel "
                     f"{got[name]} times, fewer than its {need} force evaluations")
            if any(n for k, n in got.items() if k != name) or any(ec.LAUNCHES.values()):
                fail(f"the typed main path ({kernel}) launched another force kernel")
            temps = out.temps
            if temps.shape != (p.ntimes,) or not np.isfinite(temps).all():
                fail("typed temperature trace is not finite or has the wrong shape")
            check_golden(temps, p.reneigh_every)
            print(f"typed main path {kernel}: golden gate passed; temps:", " ".join(
                f"{s}:{temps[s - 1]:.6e}" for s in range(20, p.ntimes + 1, 20)),
                flush=True)
            counts[kernel], states[kernel], rates[kernel] = got[name], (sim, out.state), rate

        phase(18)
        # 18. non-uniform tables: SP against DP on both paths
        states18 = {}
        b_before = lj.BUCKET_LAUNCHES
        for kernel in ("auto", "pallas"):
            sim_sp, out_sp, rate_sp = run_bench_file(
                path, "sp", kernel, NONUNIFORM_TABLES, repeats=1, chain=1)
            _, out_dp, _ = run_bench_file(path, "dp", kernel, NONUNIFORM_TABLES,
                                          repeats=0)
            worst = 0.0
            for step in range(20, sim_sp.params.ntimes + 1, 20):
                t_sp, t_dp = float(out_sp.temps[step - 1]), float(out_dp.temps[step - 1])
                rel = abs(t_sp - t_dp) / abs(t_dp)
                tol = 1e-3 if step <= 60 else 2e-2
                worst = max(worst, rel / tol)
                print(f"non-uniform {kernel} step {step}: T sp {t_sp:.6e}, dp "
                      f"{t_dp:.6e}, rel {rel:.3e} (tol {tol:.0e})")
                if not rel <= tol:
                    fail(f"non-uniform SP run ({kernel}) departs from DP at step {step}")
            print(f"non-uniform {kernel}: TOTAL {out_sp.total_time:.6f} s per run, "
                  f"{rate_sp:.6e} atom-updates/s (SP) on {smi}; worst rel/tol "
                  f"{worst:.3f}", flush=True)
            states18[kernel] = (sim_sp, out_sp.state)
        if lj.BUCKET_LAUNCHES != b_before:
            fail("a typed run launched the bucketed kernel K1b")

    base = dict(nx=6, ny=6, nz=6, ntimes=40, reneigh_every=10, resort_every=20,
                precision="dp", scheme="cluster")
    x, v, types = create_fcc_lattice(Params(**base, ntypes=2))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    for extra in ({"kernel": "auto"}, {"kernel": "pallas"}, {"half_neigh": 1}):
        kw = {**base, **extra}

        def sim_on(device):
            return ClusterSimulation(Params(**kw), x=x, v=v, types=types,
                                     tables=NONUNIFORM_TABLES, device=device)

        f_cpu, f_gpu = (sim_on(d).first_force_atoms() for d in ("cpu", dev))
        frel = np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max()
        r_cpu, r_gpu = (sim_on(d).run(repeats=0) for d in ("cpu", dev))
        trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
        print(f"typed small input 6^3 dp {extra}: step-0 force rel err {frel:.3e} "
              f"(tol 1e-10), 40-step temperature rel err {trel:.3e} (tol 1e-9)",
              flush=True)
        if not (frel <= 1e-10 and trel <= 1e-9):
            fail(f"the card's typed run {extra} disagrees with the CPU plain path")

    phase(19)
    # 19. K1t and K4t at the main path's shapes
    rows = []
    k1t_exact = {}  # K1t's exact ms by dtype, for K4t's ratio
    for kernel, meta in (("auto", TYPED_KERNEL), ("pallas", STREAM_TYPED_KERNEL)):
        sim, st = states18[kernel]
        cl, pr = st.clusters, st.pairs
        npad, p = sim.n_clusters_pad, sim.params
        cut = (p.cutforce**2, p.sigma6, p.epsilon)
        cs = compute_cluster_stats(cl, pr, npad, GROUP, p.cutforce**2, p.cutneigh**2)
        if kernel == "auto":
            evaluated = ilist_pairs(cs, sim.ishare)
            lists = (pr.ijlist, pr.nji)

            def run(planes, **typed):
                return lj.lj_cluster_force_ilist(*planes, *lists, npad, *cut,
                                                 share=sim.ishare, **typed)

            def plain(planes, **typed):
                return lj.lj_cluster_force_ilist_ref(*planes, pr.ijlist, npad, *cut,
                                                     share=sim.ishare, **typed)
        else:
            evaluated = cs["padded_pairs"]
            lists = (pr.jlist, pr.ranges)

            def run(planes, **typed):
                return lj.lj_cluster_force_stream(*planes, *lists, npad, *cut, **typed)

            def plain(planes, **typed):
                return lj.lj_cluster_force_group_ref(*planes, pr.jlist, npad, *cut,
                                                     ranges=pr.ranges, **typed)
        inside = cs["pairs_within_cutforce"]
        res = {}
        for dtype in (torch.float32, torch.float64):
            planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]
            typed = dict(tc=cl.tc, tables=tables_on(NONUNIFORM_TABLES, dtype))
            out, want = run(planes, **typed), plain(planes, **typed)
            err, rel = check(f"{meta['name']} at 131k", out, want, dtype)
            ms = median_ms(torch, lambda: run(planes, **typed), 50)
            if kernel == "auto":
                k1t_exact[dtype] = ms
                if dtype == torch.float32:
                    print(f"{meta['name']} at 131k (phase 18's final state): " + sweep_line(
                        torch, lj, planes, pr.ijlist, pr.nji, sim.ishare, p.cutforce**2,
                        **typed), flush=True)
            else:
                ms_dev = graph_ms(lambda: run(planes, **typed), 50)
                cull = float(typed["tables"][2].max())
                lane_pairs, work = stream_work_line(torch, lj, planes, pr, cull, cs)
                print(f"{meta['name']} at 131k ({str(dtype)[6:]}, phase 18's final "
                      f"state): median {ms:.4f} ms back to back, {ms_dev:.4f} ms on the "
                      f"device (CUDA graph); K1t exact on phase 18's auto state "
                      f"{k1t_exact[dtype]:.4f} ms, K4t / K1t exact "
                      f"{ms / k1t_exact[dtype]:.4f}; {lane_pairs} pairs evaluated; "
                      f"work: {work}", flush=True)
            ms_untyped = median_ms(torch, lambda: run(planes), 50)
            plain_ms = median_ms(torch, lambda: plain(planes, **typed), 5)
            bound = bound_of(lj_ops(evaluated, inside),
                             nbytes_of(*planes, *lists, cl.tc, *typed["tables"], *out),
                             dtype)
            res[dtype] = (err, ms, plain_ms, bound)
            approx = ""
            if kernel == "auto":
                # K1t as the main path runs it, with approx_rcp: the JSON row's
                # error and time, the exact time beside them
                err_a, rel_a = check(f"{meta['name']} with approx_rcp at 131k",
                                     run(planes, approx_rcp=True, **typed), want, dtype)
                ms_a = median_ms(torch, lambda: run(planes, approx_rcp=True, **typed), 50)
                dev_a = graph_ms(lambda: run(planes, approx_rcp=True, **typed), 50)
                res[dtype] = (err_a, ms_a, plain_ms, bound, ms, dev_a)
                approx = (f"; with approx_rcp max abs err {err_a:.3e}, rel {rel_a:.3e}, "
                          f"median {ms_a:.4f} ms back to back, {dev_a:.4f} ms on the "
                          f"device (CUDA graph)")
            print(f"{meta['name']} at 131k ({str(dtype)[6:]}, phase 18's final state, "
                  f"{evaluated} pairs evaluated, {inside} inside the cutoff): max abs "
                  f"err {err:.3e}, rel {rel:.3e} (tol {tol_of(torch, dtype):.0e}); "
                  f"median kernel {ms:.4f} ms, untyped kernel on the same lists "
                  f"{ms_untyped:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound[0]:.4f} ms ({bound[1]}){approx} on {smi}", flush=True)
        # phase 17's final state with the default (uniform) tables
        sim, st = states[kernel]
        cl, pr = st.clusters, st.pairs
        lists = (pr.ijlist, pr.nji) if kernel == "auto" else (pr.jlist, pr.ranges)
        npad = sim.n_clusters_pad
        planes = [cl.xc, cl.yc, cl.zc]
        typed = dict(tc=cl.tc, tables=sim.tables)
        out, want = run(planes, **typed), plain(planes, **typed)
        err, rel = check(f"{meta['name']} at 131k (uniform)", out, want, torch.float32)
        _, rel_u = check(f"{meta['name']} with uniform tables against the untyped "
                         "kernel at 131k", out, run(planes), torch.float32)
        approx = ""
        if kernel == "auto":
            # the lists and tables phase 17's K1t launches ran on, with approx_rcp
            err_a, rel_a = check(f"{meta['name']} with approx_rcp at 131k (uniform)",
                                 run(planes, approx_rcp=True, **typed), want,
                                 torch.float32)
            ms_e = median_ms(torch, lambda: run(planes, **typed), 50)
            ms_a = median_ms(torch, lambda: run(planes, approx_rcp=True, **typed), 50)
            approx = (f"; with approx_rcp max abs err {err_a:.3e}, rel {rel_a:.3e}; "
                      f"median {ms_e:.4f} ms exact, {ms_a:.4f} ms with approx_rcp")
        print(f"{meta['name']} at 131k (float32, phase 17's final state, uniform "
              f"tables): max abs err {err:.3e}, rel {rel:.3e}; against the untyped "
              f"kernel rel {rel_u:.3e} (tol 1e-05){approx}", flush=True)
        row = res[torch.float32]
        rows.append(kernel_row(meta, counts[kernel], *row[:4],
                               exact_ms=row[4] if len(row) > 4 else None,
                               device_ms=row[5] if len(row) > 5 else None))
    return rows


def slot_sums(torch, pairs, share: int, buckets, per: int = 0) -> tuple:
    """(flat, sorted, listed) j16 slots of the exact-list kernels on these
    lists: a block holds upb = 16 / share units and its tile loop runs to
    its longest list, so it costs upb * max(n) slots; n is what each list
    row's unit reads (ops/lj_cluster.ilist_rows): flat, min(nji, icap) in
    unit order; sorted (K1b), min(nji, its bucket's cap) in nji order, 0
    for dummy units. listed is the sum of the flat n. With `per`, groups
    of `per` units take the place of blocks (per = 32 / (8 * share): the
    units of one warp, which is what idles when its own units' lists are
    done)."""
    from mdbench_tpu_torch.ops.lj_cluster import ilist_rows

    upb = per or 128 // (8 * share)
    _, n_flat = ilist_rows(pairs.ijlist, pairs.nji, share)
    _, n_sorted = ilist_rows(pairs.bijlist, pairs.nji, share, (buckets, pairs.bcrows))

    def blocks(n):
        n = torch.nn.functional.pad(n, (0, -n.shape[0] % upb))
        return int(n.reshape(-1, upb).amax(1).sum()) * upb

    return blocks(n_flat), blocks(n_sorted), int(n_flat.sum())


def run_bucket_kernel_phase(torch, dev, ec) -> None:
    """Phase 20: K1b, K2b and K3b against their plain bucketed twins on
    the random cases of phases 3 and 7, with hand-set plans (zero tier,
    dummy units, and one truncating bucket), float32 and float64, share 1,
    2, 4; on untruncated plans bit-equal to K1, K2 and K3."""
    from mdbench_tpu_torch.models.eam_tables import fit_eam_poly, load_eam
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops.cluster import bucket_maps_core

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")
    write_standin_funcfl(eam_file)
    poly = fit_eam_poly(load_eam(eam_file))
    rng = np.random.default_rng(20)
    for dtype in (torch.float32, torch.float64):
        tol = tol_of(torch, dtype)
        for share in (1, 2, 4):
            for trunc in (False, True):
                # phase 3's lattice (LJ) and phase 7's (EAM, 1.45 A)
                for kind, spacing, seed in (("lj", 1.1, share), ("eam", 1.45, 10 + share)):
                    xc, yc, zc, ijl, nji, npad = random_case(
                        torch, seed, share, dtype, dev, spacing=spacing)
                    plan = hand_plan(nji.cpu().numpy(), ijl.shape[1], trunc=trunc)
                    bij, bcr, binv, bovf = bucket_maps_core(
                        ijl, nji, npad, share, xc.shape[0], *plan)
                    if bool(bovf) != trunc or sum(plan[0]) <= nji.shape[0] or not plan[0][0]:
                        fail(f"phase 20's plan {plan} lacks a zero tier, dummy units "
                             "or the truncating bucket")
                    maps = (bij, bcr, binv)
                    if kind == "lj":
                        args = (npad, 2.5**2, 1.0, 1.0)
                        got = {"K1b": lj.lj_cluster_force_buckets(
                            xc, yc, zc, *maps, nji, npad, plan, *args[1:], share=share)}
                        want = {"K1b": lj.lj_cluster_force_buckets_ref(
                            xc, yc, zc, *maps, npad, plan, *args[1:], share=share)}
                        flat = {"K1b": lj.lj_cluster_force_ilist(
                            xc, yc, zc, ijl, nji, *args, share=share)}
                    else:
                        fp = torch.tensor(rng.normal(-10.0, 3.0, tuple(xc.shape)),
                                          dtype=dtype, device=dev)
                        args = (npad, poly.cut**2, poly)
                        got = {"K2b": (ec.eam_rho_buckets(xc, yc, zc, *maps, nji, *args,
                                                          plan, share=share),),
                               "K3b": ec.eam_force_buckets(xc, yc, zc, fp, *maps, nji,
                                                           *args, plan, share=share)}
                        want = {"K2b": (ec.eam_rho_buckets_ref(xc, yc, zc, *maps, *args,
                                                               plan, share),),
                                "K3b": ec.eam_force_buckets_ref(xc, yc, zc, fp, *maps,
                                                                *args, plan, share)}
                        flat = {"K2b": (ec.eam_rho_ilist(xc, yc, zc, ijl, nji, *args,
                                                         share=share),),
                                "K3b": ec.eam_force_ilist(xc, yc, zc, fp, ijl, nji, *args,
                                                          share=share)}
                    torch.cuda.synchronize()
                    for name in got:
                        err, rel = rel_err(torch, got[name], want[name])
                        if not rel <= tol:
                            fail(f"{name} disagrees with its plain twin ({dtype}, share "
                                 f"{share}, trunc {trunc}): rel {rel:.3e}")
                        if any(bool((f[8:12] != 0).any()) for f in got[name]):
                            fail(f"{name}: padding units got a value")
                        same = all(torch.equal(a, b) for a, b in zip(got[name], flat[name]))
                        if not trunc and not same:
                            fail(f"{name} is not its flat kernel bit for bit ({dtype}, "
                                 f"share {share})")
                        print(f"{name} random {str(dtype)[6:]} share {share} plan {plan}: "
                              f"max abs err {err:.3e}, rel {rel:.3e} (tol {tol:.0e}); "
                              f"equal to the flat kernel: {same}", flush=True)
    check_sweep_edges(torch, dev, ("K1", "K2", "K3", "K1b", "K2b", "K3b", "K1bt", "K2bt",
                                   "K3bt"), poly)


def run_bucket_phases(torch, dev, smi: str, ec, lj_main, eam_main) -> list:
    """Phases 20-23 (capacity buckets). `lj_main` is phase 4's (sim,
    final state, K1b launches), `eam_main` phase 8's (sim, final state,
    launches). Returns the K1b, K2b and K3b rows of the JSON line."""
    from mdbench_tpu_torch.bench import root_bench
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import GROUP, ClusterSimulation, FlatSimulation
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops.eam import EamDevice
    from mdbench_tpu_torch.probes import graph_ms
    from mdbench_tpu_torch.stats import compute_cluster_stats

    phase(20)
    # 20. the bucketed kernels on random cases
    run_bucket_kernel_phase(torch, dev, ec)

    phase(21)
    # 21. the 131k LJ run, flat against bucketed, alternating
    check_golden = root_bench().check_golden
    totals = {"flat": [], "bucketed": []}
    for side in ("flat", "bucketed", "bucketed", "flat") * 2:
        params = Params(precision="sp", scheme="cluster", dense_thermo=False)
        before = lj.BUCKET_LAUNCHES
        sim = (FlatSimulation if side == "flat" else ClusterSimulation)(params,
                                                                          device=dev)
        out = sim.run(repeats=AB_REPEATS, chain=1)
        check_golden(out.temps, params.reneigh_every)
        if (sim.buckets is None) != (side == "flat") or (
                (lj.BUCKET_LAUNCHES > before) != (side == "bucketed")):
            fail(f"phase 21's {side} run took the other path")
        totals[side].append(out.total_time)
        print(f"A/B {side}: TOTAL {out.total_time:.6f} s, golden gate passed, buckets "
              f"{sim.buckets}, grows {sim.grows or 'none'}", flush=True)
    med = {k: float(np.median(v)) for k, v in totals.items()}
    print(f"A/B 131k/200 SP (F B B F F B B F, repeats {AB_REPEATS}, chain 1): median "
          f"TOTAL flat {med['flat']:.6f} s, bucketed {med['bucketed']:.6f} s; flat "
          f"{totals['flat']}, bucketed {totals['bucketed']} on {smi}", flush=True)

    base = dict(nx=6, ny=6, nz=6, ntimes=40, reneigh_every=10, resort_every=20,
                precision="dp", scheme="cluster")
    x, v, _ = create_fcc_lattice(Params(**base))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    plan = None
    for extra in ({}, {"prune_every": 3}):
        kw = {**base, **extra}

        def sim_on(device):
            nonlocal plan
            sim = ClusterSimulation(Params(**kw), x=x, v=v, device=device)
            if plan is None:
                plan = hand_plan(sim.initial_state().pairs.nji.cpu().numpy(), sim.icap)
            sim.buckets = plan
            return sim

        before = lj.BUCKET_LAUNCHES
        f_cpu, f_gpu = (sim_on(d).first_force_atoms() for d in ("cpu", dev))
        frel = np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max()
        r_cpu, r_gpu = (sim_on(d).run(repeats=0) for d in ("cpu", dev))
        trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
        n = lj.BUCKET_LAUNCHES - before
        print(f"bucketed small input 6^3 dp {extra}, plan {plan}: step-0 force rel err "
              f"{frel:.3e} (tol 1e-10), 40-step temperature rel err {trel:.3e} (tol "
              f"1e-9), {n} K1b launches", flush=True)
        if not (frel <= 1e-10 and trel <= 1e-9) or n < 41:
            fail(f"the card's bucketed run {extra} disagrees with the CPU plain path")

    phase(22)
    # 22. K1b, K2b and K3b at 131k beside K1, K2 and K3 on the same lists
    rows = []
    sim, st, b_launches = lj_main
    cl, pr = st.clusters, st.pairs
    npad, share, buckets = sim.n_clusters_pad, sim.ishare, sim.buckets
    p = sim.params
    cut = (p.cutforce**2, p.sigma6, p.epsilon)
    maps = (pr.bijlist, pr.bcrows, pr.binv)
    cs = compute_cluster_stats(cl, pr, npad, GROUP, p.cutforce**2, p.cutneigh**2,
                               buckets=buckets)
    evaluated, inside = ilist_pairs(cs, share), cs["pairs_within_cutforce"]
    slots = slot_sums(torch, pr, share, buckets)
    warps = slot_sums(torch, pr, share, buckets, per=4 // share or 1)
    print(f"K1b at 131k: phase 4's final lists, buckets {buckets}; j16 slots by block "
          f"flat {slots[0]}, nji-sorted {slots[1]} (sorted / flat "
          f"{slots[1] / slots[0]:.4f}), by warp flat {warps[0]}, nji-sorted {warps[1]} "
          f"({warps[1] / warps[0]:.4f}), listed {slots[2]}; bucketed padded pairs "
          f"{cs['padded_pairs']}; " + sweep_line(
              torch, lj, (cl.xc, cl.yc, cl.zc), pr.bijlist, pr.nji, share,
              p.cutforce**2, buckets=(buckets, pr.bcrows)), flush=True)
    res = {}
    for dtype in (torch.float32, torch.float64):
        planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]

        def kern():
            return lj.lj_cluster_force_buckets(*planes, *maps, pr.nji, npad, buckets,
                                               *cut, share=share)

        def flat():
            return lj.lj_cluster_force_ilist(*planes, pr.ijlist, pr.nji, npad, *cut,
                                             share=share)

        def plain():
            return lj.lj_cluster_force_buckets_ref(*planes, *maps, npad, buckets, *cut,
                                                   share=share)

        def kern_approx():
            return lj.lj_cluster_force_buckets(*planes, *maps, pr.nji, npad, buckets,
                                               *cut, share=share, approx_rcp=True)

        out, want = kern(), plain()
        err, rel = rel_err(torch, out, want)
        err_a, rel_a = rel_err(torch, kern_approx(), want)
        same = all(torch.equal(a, b) for a, b in zip(out, flat()))
        ms, ms_flat = median_ms(torch, kern, 50), median_ms(torch, flat, 50)
        ms_approx = median_ms(torch, kern_approx, 50)
        dev_ms, dev_approx = graph_ms(kern, 50), graph_ms(kern_approx, 50)
        plain_ms = median_ms(torch, plain, 5)
        bound = bound_of(lj_ops(evaluated, inside),
                         nbytes_of(*planes, *maps[:2], pr.nji, *out), dtype)
        # the main path's form (approx_rcp) for the JSON row, the exact time beside
        res[dtype] = (err_a, ms_approx, plain_ms, bound, ms, dev_approx)
        print(f"K1b at 131k ({str(dtype)[6:]}): max abs err {err:.3e}, rel {rel:.3e} "
              f"(tol {tol_of(torch, dtype):.0e}); equal to K1: {same}; with "
              f"approx_rcp (the main path's form) max abs err {err_a:.3e}, rel "
              f"{rel_a:.3e}; median K1b {ms:.4f} ms exact, {ms_approx:.4f} ms with "
              f"approx_rcp, K1 on the same lists {ms_flat:.4f} ms (K1b / K1 "
              f"{ms / ms_flat:.4f}); on the device (CUDA graph) {dev_ms:.4f} ms exact, "
              f"{dev_approx:.4f} ms with approx_rcp; plain {plain_ms:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}) on {smi}", flush=True)
        if not rel <= tol_of(torch, dtype) or not same:
            fail(f"K1b at 131k disagrees with its plain twin or with K1 ({dtype})")
        if not rel_a <= tol_of(torch, dtype):
            fail(f"K1b with approx_rcp disagrees with its plain twin at 131k ({dtype})")
    rows.append(kernel_row(BUCKET_KERNELS["lj_cluster_ilist_buckets"], b_launches,
                           *res[torch.float32][:4], exact_ms=res[torch.float32][4],
                           device_ms=res[torch.float32][5]))

    sim_e, st_e, launches_e = eam_main
    cl, pr = st_e.clusters, st_e.pairs
    npad, share, buckets = sim_e.n_clusters_pad, sim_e.ishare, sim_e.buckets
    maps = (pr.bijlist, pr.bcrows, pr.binv)
    args = (npad, sim_e.params.cutforce**2, sim_e.eam_poly)
    cs = compute_cluster_stats(cl, pr, npad, GROUP, sim_e.params.cutforce**2,
                               sim_e.params.cutneigh**2, buckets=buckets)
    evaluated, inside = ilist_pairs(cs, share), cs["pairs_within_cutforce"]
    deg = {k: len(getattr(sim_e.eam_poly, k)) - 1 for k in ("dens", "g1", "g2")}
    ops = {"eam_rho_buckets": 8 * evaluated + (6 + 2 * deg["dens"]) * inside,
           "eam_force_buckets": 8 * evaluated + (10 + 2 * (deg["g1"] + deg["g2"])) * inside}
    slots = slot_sums(torch, pr, share, buckets)
    warps = slot_sums(torch, pr, share, buckets, per=4 // share or 1)
    print(f"K2b/K3b at 131k: phase 8's final lists, buckets {buckets}; j16 slots by "
          f"block flat {slots[0]}, nji-sorted {slots[1]} (sorted / flat "
          f"{slots[1] / slots[0]:.4f}), by warp flat {warps[0]}, nji-sorted {warps[1]} "
          f"({warps[1] / warps[0]:.4f}), listed {slots[2]}; " + sweep_line(
              torch, lj, (cl.xc, cl.yc, cl.zc), pr.bijlist, pr.nji, share,
              sim_e.params.cutforce**2, buckets=(buckets, pr.bcrows)), flush=True)
    res = {}
    for dtype in (torch.float32, torch.float64):
        planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]
        rho_ref = ec.eam_rho_ilist_ref(*planes, pr.ijlist, *args, share=share)
        fp = ec.fp_plane_from_rho(
            rho_ref, EamDevice.from_tables(sim_e.eam_tables, dev, dtype),
            st_e.halo.border_map, planes[0].shape[0])
        calls = {
            "eam_rho_buckets": (
                lambda: (ec.eam_rho_buckets(*planes, *maps, pr.nji, *args, buckets,
                                            share=share),),
                lambda: (ec.eam_rho_ilist(*planes, pr.ijlist, pr.nji, *args,
                                          share=share),),
                lambda: (ec.eam_rho_buckets_ref(*planes, *maps, *args, buckets,
                                                share),)),
            "eam_force_buckets": (
                lambda: ec.eam_force_buckets(*planes, fp, *maps, pr.nji, *args, buckets,
                                             share=share),
                lambda: ec.eam_force_ilist(*planes, fp, pr.ijlist, pr.nji, *args,
                                           share=share),
                lambda: ec.eam_force_buckets_ref(*planes, fp, *maps, *args, buckets,
                                                 share)),
        }
        for name, (kern, flat, plain) in calls.items():
            out = kern()
            err, rel = rel_err(torch, out, plain())
            same = all(torch.equal(a, b) for a, b in zip(out, flat()))
            ms, ms_flat = median_ms(torch, kern, 50), median_ms(torch, flat, 50)
            dev_ms = graph_ms(kern, 50)
            plain_ms = median_ms(torch, plain, 5)
            moved = nbytes_of(*planes, *maps[:2], pr.nji, *out) + (
                nbytes_of(fp) if name == "eam_force_buckets" else 0)
            bound = bound_of(ops[name], moved, dtype)
            print(f"{name} at 131k ({str(dtype)[6:]}): max abs err {err:.3e}, rel "
                  f"{rel:.3e} (tol {tol_of(torch, dtype):.0e}); equal to the flat "
                  f"kernel: {same}; median {ms:.4f} ms back to back, {dev_ms:.4f} ms on "
                  f"the device (CUDA graph), flat kernel on the same lists "
                  f"{ms_flat:.4f} ms (ratio {ms / ms_flat:.4f}), plain {plain_ms:.4f} "
                  f"ms, bound {bound[0]:.4f} ms ({bound[1]}) on {smi}", flush=True)
            if not rel <= tol_of(torch, dtype) or not same:
                fail(f"{name} at 131k disagrees with its plain twin or its flat "
                     f"kernel ({dtype})")
            if dtype == torch.float32:
                res[name] = kernel_row(BUCKET_KERNELS[name], launches_e[name], err, ms,
                                       plain_ms, bound, device_ms=dev_ms)
    rows += [res["eam_rho_buckets"], res["eam_force_buckets"]]

    phase(23)
    # 23. measure_phases on phase 4's final state; run_chunked at 131k
    sim, st, _ = lj_main
    t_force, t_neigh = sim.measure_phases(st)
    print(f"measure_phases at 131k (phase 4's final state, buckets {sim.buckets}): "
          f"FORCE {t_force * 1e3:.4f} ms per call, NEIGH {t_neigh * 1e3:.4f} ms per "
          f"full rebuild on {smi}", flush=True)
    if not (0 < t_force < 1 and 0 < t_neigh < 10):
        fail("measure_phases gave no plausible times")
    kw = dict(precision="sp", scheme="cluster", reneigh_every=10)
    steps = []
    before = lj.BUCKET_LAUNCHES
    chunked = ClusterSimulation(Params(**kw), device=dev).run_chunked(
        10, 4, lambda state, step: steps.append(step))
    n = lj.BUCKET_LAUNCHES - before
    ref = ClusterSimulation(Params(**kw), device=dev).run(ntimes=40)
    rel = float(np.max(np.abs(chunked.temps - ref.temps) / np.abs(ref.temps)))
    print(f"run_chunked(10, 4) at 131k (reneigh_every 10): callback steps {steps}, "
          f"{n} K1b launches, temperatures against run(ntimes=40) rel {rel:.3e} (tol "
          f"1e-6), chunked wall {chunked.total_time:.4f} s", flush=True)
    if steps != [0, 10, 20, 30, 40] or not rel <= 1e-6 or n < 40:
        fail("run_chunked at 131k departs from run()")
    return rows


def run_approx_phase(torch, dev) -> None:
    """Phase 24: K1, K1t and K1b with approx_rcp on the random cases of
    phases 3, 16 and 20."""
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops.cluster import bucket_maps_core

    phase(24)
    for dtype in (torch.float32, torch.float64):
        tol = tol_of(torch, dtype)
        for share in (1, 2, 4):
            args = (2.5**2, 1.0, 1.0)
            # phase 3's case: K1, and K1b on phase 20's hand-set plans
            xc, yc, zc, ijl, nji, npad = random_case(torch, share, share, dtype, dev)
            cases = {"K1": (
                lambda a: lj.lj_cluster_force_ilist(xc, yc, zc, ijl, nji, npad, *args,
                                                    share=share, approx_rcp=a),
                lj.lj_cluster_force_ilist_ref(xc, yc, zc, ijl, npad, *args,
                                              share=share))}
            for trunc in (False, True):
                plan = hand_plan(nji.cpu().numpy(), ijl.shape[1], trunc=trunc)
                maps = bucket_maps_core(ijl, nji, npad, share, xc.shape[0], *plan)[:3]
                cases[f"K1b trunc {trunc}"] = (
                    lambda a, maps=maps, plan=plan: lj.lj_cluster_force_buckets(
                        xc, yc, zc, *maps, nji, npad, plan, *args, share=share,
                        approx_rcp=a),
                    lj.lj_cluster_force_buckets_ref(xc, yc, zc, *maps, npad, plan,
                                                    *args, share=share))
            # phase 16's case: K1t with two random types
            txc, tyc, tzc, tijl, tnji, tnpad = random_case(torch, 20 + share, share,
                                                           dtype, dev)
            tc = torch.tensor(np.random.default_rng(30 + share).integers(
                0, 2, tuple(txc.shape)), dtype=torch.int32, device=dev)
            tabs = tuple(torch.tensor(t, dtype=dtype, device=dev)
                         for t in random_tables(2 + share, 2))
            cases["K1t"] = (
                lambda a: lj.lj_cluster_force_ilist(txc, tyc, tzc, tijl, tnji, tnpad,
                                                    *args, share=share, tc=tc,
                                                    tables=tabs, approx_rcp=a),
                lj.lj_cluster_force_ilist_ref(txc, tyc, tzc, tijl, tnpad, *args,
                                              share=share, tc=tc, tables=tabs))
            got = {name: (run(True), run(False)) for name, (run, _) in cases.items()}
            torch.cuda.synchronize()
            for name, (approx, exact) in got.items():
                err, rel = rel_err(torch, approx, cases[name][1])
                same = all(torch.equal(a, b) for a, b in zip(approx, exact))
                print(f"{name} approx_rcp {str(dtype)[6:]} share {share}: max abs err "
                      f"{err:.3e}, rel {rel:.3e} (tol {tol:.0e}); equal to the exact "
                      f"kernel: {same}", flush=True)
                if not rel <= tol:
                    fail(f"{name} with approx_rcp disagrees with its plain twin ({dtype})")
                if dtype == torch.float64 and not same:
                    fail(f"{name} in float64 changed with approx_rcp")
            if not all(torch.equal(a, b) for a, b in
                       zip(got["K1b trunc False"][0], got["K1"][0])):
                fail(f"K1b with approx_rcp is not K1 with it bit for bit ({dtype})")


def bf16_inside(torch, planes, ijlist, npad: int, cutsq: float, share: int):
    """Per i-atom (unit-major, as the lists' rows), the listed pairs the bf16
    kernel's sweep A marks: 0 < rsq < cutsq on rsq formed in bfloat16 as
    its plain twin forms it (float32 distances rounded to bfloat16)."""
    nu, icap = ijlist.shape
    jl = ijlist.long()

    def delta(p):
        pj = p.reshape(-1, 16)[jl].reshape(nu, 1, icap * 16)
        return (p[:npad].reshape(nu, share * 8, 1) - pj).to(torch.bfloat16)

    dx, dy, dz = (delta(p) for p in planes)
    rsq = (dx * dx + dy * dy + dz * dz).float()
    return ((rsq < cutsq) & (rsq > 0)).sum(2).flatten()


def bf16_bound(listed: int, inside: int, nbytes: int) -> tuple:
    """(bound_ms, bound_by) of the bf16 kernel: per listed pair the
    distance test (6 float32 operations: subtracts and converts; 7
    bfloat16: rsq and the two compares), per inside pair the pair math (9
    float32: the reciprocal, converts, sums; 10 bfloat16: sr6, gf, d*gf);
    and the bytes."""
    t_ops = ((6 * listed + 9 * inside) / PEAK_FLOPS["float32"]
             + (7 * listed + 10 * inside) / PEAK_FLOPS["bfloat16"])
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def run_bf16_phase(torch, dev, smi: str, ec, lj_main) -> dict:
    """Phase 25: the bf16 probe (T2). `lj_main` is phase 4's (sim, final
    state, K1b launches). Returns the bf16 kernel's JSON row."""
    phase(25)
    from mdbench_tpu_torch.engine_cluster import GROUP
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.probes import bf16 as probe
    from mdbench_tpu_torch.stats import compute_cluster_stats

    for share in (1, 2, 4):
        xc, yc, zc, ijl, nji, npad = random_case(torch, share, share, torch.float32,
                                                 dev)
        args = (npad, 2.5**2, 1.0, 1.0)
        got = lj.lj_cluster_force_ilist_bf16(xc, yc, zc, ijl, nji, *args, share=share)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, got, lj.lj_cluster_force_ilist_bf16_ref(
            xc, yc, zc, ijl, *args, share=share))
        print(f"bf16 kernel random share {share}: max abs err {err:.3e}, rel "
              f"{rel:.3e} (tol {BF16_TOL:.0e})", flush=True)
        if not rel <= BF16_TOL or any(bool((f[8:12] != 0).any()) for f in got):
            fail(f"the bf16 kernel disagrees with its plain twin (share {share})")
        case = probe.edge_case(share, dev)
        got = probe.edge_force(case)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, got, probe.edge_force(case, plain=True))
        print(f"bf16 kernel edge case share {share} (cutoff {probe.EDGE_CUTOFF}, nji "
              f"{case['nji'].tolist()}): max abs err {err:.3e}, rel {rel:.3e} (tol "
              f"{BF16_TOL:.0e})", flush=True)
        if not rel <= BF16_TOL or any(bool((f[share:2 * share] != 0).any()) for f in got):
            fail(f"the bf16 kernel disagrees with its plain twin on the edge case "
                 f"(share {share})")

    sim, st, _ = lj_main
    cl, pr, p = st.clusters, st.pairs, sim.params
    npad, share = sim.n_clusters_pad, sim.ishare
    planes = (cl.xc, cl.yc, cl.zc)
    cut = (p.cutforce**2, p.sigma6, p.epsilon)

    def kern():
        return lj.lj_cluster_force_ilist_bf16(*planes, pr.ijlist, pr.nji, npad, *cut,
                                              share=share)

    def plain():
        return lj.lj_cluster_force_ilist_bf16_ref(*planes, pr.ijlist, npad, *cut,
                                                  share=share)

    out = kern()
    err, rel = rel_err(torch, out, plain())
    plain_ms = median_ms(torch, plain, 5)
    mx, mean = probe.force_error(sim, st)
    t = probe.kernel_times(sim, st)
    cs = compute_cluster_stats(cl, pr, npad, GROUP, p.cutforce**2, p.cutneigh**2)
    pairs = ilist_pairs(cs, share)
    inside = int(bf16_inside(torch, planes, pr.ijlist, npad, cut[0], share).sum())
    nbytes = nbytes_of(*planes, pr.ijlist, pr.nji, *out)
    bound = bf16_bound(pairs, inside, nbytes)
    # the earlier convention: the whole pair math on every listed pair
    old_ms = max((9 / PEAK_FLOPS["float32"] + 16 / PEAK_FLOPS["bfloat16"]) * pairs,
                 nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"bf16 kernel at 131k (phase 4's final flat lists, {pairs} pairs, {inside} "
          f"inside in bfloat16): max abs err {err:.3e}, rel {rel:.3e} (tol "
          f"{BF16_TOL:.0e}) against its plain twin")
    print(f"bf16 force err: max/typ {mx:.3e}  mean/typ {mean:.3e} (against exact K1)")
    print(f"force K1 exact: {t['k1_exact']:.4f} ms   K1 approx-rcp: "
          f"{t['k1_approx']:.4f} ms   bf16: {t['bf16']:.4f} ms (bf16 / exact "
          f"{t['bf16'] / t['k1_exact']:.4f}, approx / exact "
          f"{t['k1_approx'] / t['k1_exact']:.4f}); bf16 plain {plain_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}: distance test on every listed pair, "
          f"pair math inside; {bound[0] / t['bf16']:.1%} of it on the device), the "
          f"earlier bound (pair math on every listed pair) {old_ms:.4f} ms on {smi}",
          flush=True)
    if not rel <= BF16_TOL:
        fail("the bf16 kernel disagrees with its plain twin at 131k")

    # the probe's golden run: the bf16 force on flat lists
    reset_counts(lj, ec)
    gsim, gout, _passed, verdict = probe.golden_run(dev)
    torch.cuda.synchronize()
    launches = lj.BF16_LAUNCHES
    others = {name: getattr(lj, name) for name in LJ_COUNTS if name != "BF16_LAUNCHES"}
    need = 2 * (gsim.params.ntimes + 1)  # the checked run and the timed one
    for line in probe.golden_lines(gsim, gout, verdict):
        print(line)
    print(f"bf16 golden run: buckets {gsim.buckets}, grows {gsim.grows or 'none'}; "
          f"bf16 launches {launches} (>= {need} force evaluations); other LJ "
          f"kernels {others}; EAM {dict(ec.LAUNCHES)}; the gate's verdict is the "
          f"probe's finding", flush=True)
    if launches < need:
        fail(f"the bf16 run launched the bf16 kernel {launches} times, fewer than "
             f"its {need} force evaluations")
    if gsim.buckets is not None or any(others.values()) or any(ec.LAUNCHES.values()):
        fail("the bf16 run planned buckets or launched another force kernel")
    if not np.isfinite(gout.temps).all():
        fail("the bf16 run's temperatures are not finite")
    return kernel_row(BF16_KERNEL, launches, err, t["bf16"], plain_ms, bound)


def run_fetch_phase(torch, dev, smi: str) -> list:
    """Phase 26: the row-fetch probe (T1). Returns the four variants' JSON
    rows."""
    from mdbench_tpu_torch.ops import row_fetch as rf
    from mdbench_tpu_torch.probes import dma

    phase(26)
    for line in kernel_ptxas_lines("row_fetch_tma_kernel"):
        print(line)
    table, idx, idx8 = dma.make_inputs(dev)
    for mode in rf.MODES:  # id lists that end inside a stage
        for rows_per_id, ids in ((1, idx[:37]), (8, idx8[:5])):
            got = rf.row_fetch(table, ids, rows_per_id, mode)
            if not torch.equal(got, rf.row_fetch_ref(table, ids, rows_per_id)):
                fail(f"{rf.variant(mode, rows_per_id)} on {ids.numel()} ids differs "
                     "from index_select")
    equal = dma.equal_to_index_select(table, idx, idx8)
    if not all(equal.values()):
        fail(f"a row-fetch variant differs from index_select: {equal}")
    for name in rf.LAUNCHES:
        rf.LAUNCHES[name] = 0
    rows = dma.measure(table, idx, idx8)
    torch.cuda.synchronize()
    for line in dma.report(rows, equal, smi):
        print(line)
    out = []
    for r in rows:
        meta = {"name": r["name"], "route": "cuda",
                "source": "mdbench_tpu_torch/csrc/row_fetch.cu",
                "replaces": ROW_FETCH_REPLACES[r["rows_per_id"]]}
        out.append(kernel_row(meta, rf.LAUNCHES[r["name"]], 0.0, r["ms"],
                              r["library_ms"], (r["bound_ms"], "bytes"),
                              library_ms=r["library_ms"]))
    print(f"row fetch launches {dict(rf.LAUNCHES)}", flush=True)
    return out


VERLET_KERNELS = {
    "flat": {**KERNEL, "name": "lj_cluster_ilist (verlet rows)"},
    "bucketed": {**BUCKET_KERNELS["lj_cluster_ilist_buckets"],
                 "name": "lj_cluster_ilist_buckets (verlet rows)"},
}


def sync_sites(torch, fn) -> dict:
    """Host synchronisations of the stream in fn() (torch.cuda's sync debug
    mode), counted by the innermost frame of the port's package that made
    each: {"path/in/package.py:line": count} (a call from outside the
    package under its own file:line)."""
    import traceback
    import warnings

    sites: dict = {}

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if "mdbench_tpu_torch/" in f.filename.replace("\\", "/")]
        where = (f"{ours[-1].filename.replace(chr(92), '/').split('mdbench_tpu_torch/')[-1]}"
                 f":{ours[-1].lineno}" if ours else f"{filename}:{lineno}")
        sites[where] = sites.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def sync_count(torch, fn) -> int:
    """Host synchronisations of the stream in fn() (sync_sites, summed)."""
    return sum(sync_sites(torch, fn).values())


def rowlist_kernel_row(torch, lj, p, x, nl, nlocal_pad: int, rbuckets, smi: str,
                       launches: int, bucketed: bool, tag: str, meta: dict) -> dict:
    """K1 (flat) or K1b (bucketed) on 16-atom row lists `nl` of the rows x
    (a verlet run's or a slab's final state): the planes x[:, d].reshape(-1,
    8) and the row lists (share 2), against the plain twin in float32 and
    float64 (exact and with approx_rcp, the main path's form), K1b also
    bit-equal to K1 on the same lists; median times back to back and on
    the device alone, the sweep counts and the bound. Returns the JSON row
    (float32, approx_rcp)."""
    from mdbench_tpu_torch.probes import graph_ms

    npad = nlocal_pad // 8
    cut = (p.cutforce**2, p.sigma6, p.epsilon)
    planes32 = [x[:, k].reshape(-1, 8).contiguous() for k in range(3)]
    if bucketed:
        lists, kw = nl.brows, dict(buckets=(rbuckets, nl.bcrows))
    else:
        lists, kw = nl.rows, {}
    c = lj.ilist_sweep_counts(*planes32, lists, nl.numrows, 2, p.cutforce**2, **kw)
    evaluated, inside = int(c["listed"].sum()), int(c["inside"].sum())
    print(f"{tag} at 131k ({'buckets ' + str(rbuckets) if bucketed else 'flat'}, "
          f"{nl.rows.shape[0]} units x rcap {nl.rows.shape[1]}, numrows mean "
          f"{float(nl.numrows.float().mean()):.2f} max {int(nl.numrows.max())}): "
          + sweep_line(torch, lj, planes32, lists, nl.numrows, 2, p.cutforce**2, **kw),
          flush=True)
    res = {}
    for dtype in (torch.float32, torch.float64):
        planes = [q.to(dtype) for q in planes32]

        def flat(approx=False):
            return lj.lj_cluster_force_ilist(*planes, nl.rows, nl.numrows, npad, *cut,
                                             share=2, approx_rcp=approx)

        if bucketed:
            maps = (nl.brows, nl.bcrows, nl.binv)

            def kern(approx=False):
                return lj.lj_cluster_force_buckets(*planes, *maps, nl.numrows, npad,
                                                   rbuckets, *cut, share=2,
                                                   approx_rcp=approx)

            def plain():
                return lj.lj_cluster_force_buckets_ref(*planes, *maps, npad,
                                                       rbuckets, *cut, share=2)
        else:
            kern = flat

            def plain():
                return lj.lj_cluster_force_ilist_ref(*planes, nl.rows, npad, *cut,
                                                     share=2)

        out, want = kern(), plain()
        err, rel = rel_err(torch, out, want)
        err_a, rel_a = rel_err(torch, kern(True), want)
        same = all(torch.equal(a, b) for a, b in zip(out, flat()))
        ms, ms_a = median_ms(torch, kern, 50), median_ms(torch, lambda: kern(True), 50)
        dev_a = graph_ms(lambda: kern(True), 50)
        plain_ms = median_ms(torch, plain, 5)
        bound = bound_of(lj_ops(evaluated, inside),
                         nbytes_of(*planes, lists, nl.numrows, *out)
                         + (nbytes_of(nl.bcrows) if bucketed else 0), dtype)
        res[dtype] = (err_a, ms_a, plain_ms, bound, ms, dev_a)
        tol = tol_of(torch, dtype)
        print(f"{tag} at 131k ({str(dtype)[6:]}): max abs err {err:.3e}, rel {rel:.3e} "
              f"(tol {tol:.0e}); with approx_rcp (the main path's form) max abs err "
              f"{err_a:.3e}, rel {rel_a:.3e}; equal to K1 on the same lists: {same}; "
              f"median {ms:.4f} ms exact, {ms_a:.4f} ms with approx_rcp, on the device "
              f"(CUDA graph) {dev_a:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{bound[0]:.4f} ms ({bound[1]}; {evaluated} listed pairs, {inside} "
              f"inside) on {smi}", flush=True)
        if not (rel <= tol and rel_a <= tol and same):
            fail(f"{tag} on the verlet lists disagrees with its plain version or K1 "
                 f"({dtype})")
    copies = median_ms(torch, lambda: [x[:, k].reshape(-1, 8).contiguous()
                                       for k in range(3)], 50)
    print(f"{tag}: the three plane copies x[:, d].reshape(-1, 8).contiguous() of the "
          f"{tuple(x.shape)} state: {copies:.4f} ms per force call on {smi}",
          flush=True)
    r = res[torch.float32]
    return kernel_row(meta, launches, *r[:4], exact_ms=r[4], device_ms=r[5])


def run_verlet_phases(torch, dev, smi: str, ec) -> list:
    """Phases 27-29 (the verlet scheme's LJ path). Returns the JSON rows of
    K1 and K1b on the verlet lists."""
    from mdbench_tpu_torch.bench import root_bench, run_bench_verlet
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine import FlatSimulation, Simulation
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj

    def run_flat():
        """run_bench_verlet's run on FlatSimulation (no capacity buckets)."""
        params = Params(precision="sp", scheme="verlet", dense_thermo=False)
        sim = FlatSimulation(params, device=dev)
        out = sim.run(repeats=SEC_REPEATS, chain=SEC_CHAIN)
        root_bench().check_golden(out.temps, params.reneigh_every)
        return sim, out, sim.natoms * params.ntimes / out.total_time

    phase(27)
    # 27. the verlet 131k/200 SP run, flat and bucketed, golden-gated
    runs = {}
    for side in ("flat", "bucketed"):
        reset_counts(lj, ec)
        t0 = time.perf_counter()
        sim, out, rate = (run_flat() if side == "flat"
                          else run_bench_verlet(repeats=SEC_REPEATS, chain=SEC_CHAIN))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: getattr(lj, name) for name in LJ_COUNTS}
        p = sim.params
        need = (1 + SEC_REPEATS * SEC_CHAIN) * (p.ntimes + 1)
        print(f"verlet {side}: {sim.natoms} atoms, {p.ntimes} steps, {p.precision}, "
              f"caps {tuple(sim.caps)}, rcap {sim.rcap}, ccap {sim.ccap}, ucl "
              f"{sim.ucl}, ukr {sim.ukr}, buckets {sim.rbuckets}; golden gate passed; "
              f"TOTAL {out.total_time:.6f} s per run, {rate:.6e} atom-updates/s, run() "
              f"wall {wall:.2f} s; launches {counts}; EAM {dict(ec.LAUNCHES)} on {smi}",
              flush=True)
        k1, k1b = counts["LAUNCHES"], counts["BUCKET_LAUNCHES"]
        others = {k: v for k, v in counts.items()
                  if k not in ("LAUNCHES", "BUCKET_LAUNCHES") and v}
        if others or any(ec.LAUNCHES.values()):
            fail(f"the verlet run launched another force kernel: {others}")
        if side == "flat" and (sim.rbuckets is not None or k1b or k1 < need):
            fail(f"the flat verlet run launched K1 {k1} (>= {need}) and K1b {k1b} "
                 "(0) times")
        if side == "bucketed" and (sim.rbuckets is None or k1 < 1 or k1b < need):
            fail(f"the bucketed verlet run planned {sim.rbuckets} and launched K1 {k1} "
                 f"(set-up) and K1b {k1b} (>= {need}) times")
        if not np.isfinite(out.temps).all() or not bool(torch.isfinite(out.state.v).all()):
            fail("the verlet run's state is not finite")
        print(f"verlet {side} temps: " + " ".join(
            f"{s_}:{out.temps[s_ - 1]:.6e}" for s_ in range(20, p.ntimes + 1, 20)))
        runs[side] = (sim, out.state, k1b if side == "bucketed" else k1, out.total_time)

    phase(28)
    # 28. K1 and K1b on the verlet run's final lists; a small box card vs CPU
    rows = []
    for side, tag in (("flat", "K1"), ("bucketed", "K1b")):
        sim, st, launches = runs[side][:3]
        rows.append(rowlist_kernel_row(
            torch, lj, sim.params, st.x, st.nlist, sim.caps.nlocal_pad, sim.rbuckets,
            smi, launches, side == "bucketed", f"{tag} (verlet rows)",
            VERLET_KERNELS[side]))
    for extra in ({"kernel": "auto"}, {"kernel": "xla"}, {"half_neigh": 1}):
        kw = dict(nx=6, ny=6, nz=6, ntimes=40, reneigh_every=10, precision="dp",
                  **extra)
        x, v, _ = create_fcc_lattice(Params(**kw))
        x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
        f_c, f_g = (Simulation(Params(**kw), x=x, v=v, device=d).first_force()
                    for d in ("cpu", dev))
        frel = np.abs(f_g - f_c).max() / np.abs(f_c).max()
        r_c, r_g = (Simulation(Params(**kw), device=d).run(repeats=0)
                    for d in ("cpu", dev))
        trel = float(np.max(np.abs(r_g.temps - r_c.temps) / np.abs(r_c.temps)))
        print(f"verlet small input 6^3 dp {extra}: step-0 force rel err {frel:.3e} (tol "
              f"1e-10), 40-step temperature rel err {trel:.3e} (tol 1e-9)", flush=True)
        if not (frel <= 1e-10 and trel <= 1e-9):
            fail(f"the card's verlet run {extra} disagrees with the CPU plain path")

    phase(29)
    # 29. FORCE/NEIGH, host synchronisations, the profile of one run
    sim, st = runs["bucketed"][:2]
    t_force, t_neigh = sim.measure_phases(st)
    n_run = sync_count(torch, lambda: sim._run_steps(sim.initial_state(), 40))
    n_ren = sync_count(torch, lambda: sim._reneighbor(st.x, st.types))
    prof = device_profile(torch, lambda: sim._run_steps(sim.initial_state(), 200))
    top = sorted(prof["ms"].items(), key=lambda kv: -kv[1])[:12]
    total_ms = sum(prof["ms"].values())
    print(f"verlet measure_phases at 131k (buckets {sim.rbuckets}): FORCE "
          f"{t_force * 1e3:.4f} ms per call, NEIGH {t_neigh * 1e3:.4f} ms per rebuild; "
          f"host synchronisations: {n_run} in a 40-step _run_steps (initial state "
          f"included), {n_ren} in one rebuild; on {smi}", flush=True)
    total = runs["bucketed"][3]
    print(f"verlet TOTAL {total:.6f} s against 200 FORCE + 10 NEIGH = "
          f"{(200 * t_force + 10 * t_neigh):.6f} s on {smi}", flush=True)
    print(f"verlet profile of one 200-step _run_steps: wall {prof['wall_s']:.4f} s "
          f"(profiled), device busy {prof['busy']:.4f}, {prof['spans']} spans, device "
          f"ms {total_ms:.4f}; top kernels (ms): " + "; ".join(
              f"{name[:110]} {ms:.4f}" for name, ms in top), flush=True)
    if not (0 < t_force < 1 and 0 < t_neigh < 10):
        fail("verlet measure_phases gave no plausible times")
    return rows, {side: r[3] for side, r in runs.items()}


def eam_verlet_bounds(torch, sim, st, dtype, poly: bool) -> tuple:
    """(K5 bound, K6 bound, the whole force's bound, listed pairs, pairs
    inside) of one verlet EAM force in `dtype` on `st`'s lists. Operations:
    8 a listed pair (each list up to min(numneigh, K)); inside the cutoff 6 +
    2d (density) and 10 + 2(d1 + d2) (force) for the polynomials' degrees;
    the spline form counts its rows as polynomials of degree 3 (density)
    and 2 + 2 + 3 (force), and 8 more for the force's 1/r chain. Bytes: x,
    numneigh, the listed entries and the tables each pass reads, once; K5
    writes fp, K6 reads fp and writes f; the whole force reads border_map
    and writes f."""
    p, nl = sim.params, st.nlist
    n = sim.caps.nlocal_pad
    k = nl.neighbors.shape[1]
    valid = torch.arange(k, device=st.x.device)[None, :] < nl.numneigh[:, None]
    xi, xj = st.x[:n].double(), st.x.double()[nl.neighbors]
    rsq = ((xi[:, None, :] - xj) ** 2).sum(-1)
    listed = int(valid.sum())
    inside = int((valid & (rsq < p.cutforce**2)).sum())
    del xj, rsq
    if poly:
        deg = {name: len(getattr(sim.eam_poly, name)) - 1 for name in ("dens", "g1", "g2")}
        in5, in6 = 6 + 2 * deg["dens"], 10 + 2 * (deg["g1"] + deg["g2"])
        names5, names6 = ("frho",), ()
    else:
        in5, in6 = 6 + 2 * 3, 10 + 2 * (2 + 2 + 3) + 8
        names5, names6 = ("frho", "rhor"), ("rhor", "z2r")
    ops5, ops6 = 8 * listed + in5 * inside, 8 * listed + in6 * inside
    x = st.x.to(dtype)
    fp = torch.empty((x.shape[0],), dtype=dtype, device=x.device)
    f = torch.empty((n, 3), dtype=dtype, device=x.device)
    tab = {name: getattr(sim.eam_dev, name).to(dtype) for name in ("frho", "rhor", "z2r")}
    # the lists: numneigh and the listed entries (the kernels read no others)
    lists = nbytes_of(nl.numneigh) + listed * nl.neighbors.element_size()
    both = sorted(set(names5 + names6))
    return (bound_of(ops5, lists + nbytes_of(x, *(tab[q] for q in names5), fp), dtype),
            bound_of(ops6, lists + nbytes_of(x, *(tab[q] for q in names6), fp, f), dtype),
            bound_of(ops5 + ops6, lists + nbytes_of(x, st.halo.border_map,
                                                    *(tab[q] for q in both), f), dtype),
            listed, inside)


def verlet_eam_pair(torch, x, nb, nn, npad, cutsq, eam, poly, border_map=None) -> dict:
    """K5 twice and K6 twice against their plain versions on one set of
    operands: K6 takes the plain pass 1's fp with its ghost rows refreshed
    through `border_map` (left 0 without one). Returns the outputs by
    name, each (kernel, second launch, plain)."""
    from mdbench_tpu_torch.ops import eam as ev

    fp_r, rho_r = ev.eam_rho_nlist_ref(x, nb, nn, npad, cutsq, eam, poly)
    k5 = [ev.eam_rho_nlist(x, nb, nn, npad, cutsq, eam, poly, want_rho=True)
          for _ in range(2)]
    fp = fp_r.clone() if border_map is None else ev.ghost_fp_refresh(
        fp_r.clone(), border_map, npad)
    f_r = ev.eam_force_nlist_ref(x, nb, nn, fp[:npad], fp, cutsq, eam, poly)
    f_k = [ev.eam_force_nlist(x, nb, nn, fp[:npad], fp, cutsq, eam, poly)
           for _ in range(2)]
    torch.cuda.synchronize()
    return {"rho": (k5[0][1], k5[1][1], rho_r), "fp": (k5[0][0], k5[1][0], fp_r),
            "f": (*f_k, f_r), "fp_in": fp}


def check_verlet_eam_pair(torch, outs: dict, dtype, what: str) -> dict:
    """Each output equal to its plain version bit for bit (torch's row sum
    on the card adds a row of fewer than 128 entries in the kernels'
    order, and every pair's arithmetic is the same), so within tol_of(dtype)
    of max |plain| too, and the same bits from both launches; returns name
    -> (max abs err, rel)."""
    errs = {}
    for name in ("rho", "fp", "f"):
        got, again, want = outs[name]
        errs[name] = rel_err(torch, (got,), (want,))
        if not torch.equal(got, again):
            fail(f"{what}: two launches gave different {name} bits")
        if not errs[name][1] <= tol_of(torch, dtype):
            fail(f"{what}: {name} disagrees with its plain version (rel {errs[name][1]:.3e})")
        if not torch.equal(got, want):
            fail(f"{what}: {name} is not its plain version bit for bit (rel "
                 f"{errs[name][1]:.3e})")
    return errs


def check_verlet_eam_edges(torch, dev, eam_file: str) -> None:
    """Phase 30's edge cases (verlet_eam_edge_cases): K5 and K6 against
    their plain versions on the card in float32 and float64, spline and
    poly, bit for bit; rows without a listed pair inside the cutoff get rho
    and force exactly 0, the row with a pair just inside does not, two
    launches the same bits."""
    from mdbench_tpu_torch.models.eam_tables import fit_eam_poly, load_eam
    from mdbench_tpu_torch.ops.eam import EamDevice

    t = load_eam(eam_file)
    for np_dtype, dtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
        for case_name, case in verlet_eam_edge_cases(np_dtype).items():
            x, nb, nn, bmap = (torch.tensor(case[k], device=dev)
                               for k in ("x", "neighbors", "numneigh", "border_map"))
            eam = EamDevice.from_tables(t, dev, dtype)
            for form, poly in (("spline", None), ("poly", fit_eam_poly(t))):
                what = f"K5/K6 edge case {case_name} ({form}, {str(dtype)[6:]})"
                outs = verlet_eam_pair(torch, x, nb, nn, case["nlocal_pad"],
                                       VERLET_EAM_CUTSQ, eam, poly, bmap)
                errs = check_verlet_eam_pair(torch, outs, dtype, what)
                rho, f = outs["rho"][0], outs["f"][0]
                empty, inside = case["empty"], case["inside"]
                if bool((rho[empty] != 0).any()) or bool((f[empty] != 0).any()):
                    fail(f"{what}: a row without a pair inside got a density or a force")
                if not (float(rho[inside]) > 0 and float(f[inside, 1]) != 0):
                    fail(f"{what}: the pair inside the cutoff was dropped")
                print(f"{what} ({case['nlocal_pad']} rows x k {nb.shape[1]}): max abs err "
                      f"rho {errs['rho'][0]:.3e}, fp {errs['fp'][0]:.3e}, f "
                      f"{errs['f'][0]:.3e} (bit for bit); empty rows exactly 0, the pair "
                      f"inside kept, two launches equal", flush=True)


def verlet_eam_kernel_rows(torch, sim, st, launches: dict, smi: str,
                           at: str = "131k") -> list:
    """Phase 30's kernel check on the final 131k SP state's lists (phase
    47's on the 1M state's: `at` names the size, and the rows' names end
    with it when it is not 131k): K5 and
    K6 against their plain versions in float32 and float64, poly (the main
    path's form) and spline, bit for bit, two launches the same bits;
    median ms back to back and on the device alone; bounds, the share of
    them on the device and the listed int64 entries' rate (the list
    stream); the blocks an SM holds (the kernels use no shared memory and
    read the spline tables through the read-only cache); the -Xptxas -v
    lines. Returns the JSON rows of K5 and K6 (the float32 poly form's
    numbers; the f64 and spline times beside)."""
    from mdbench_tpu_torch.ops import eam as ev
    from mdbench_tpu_torch.probes import graph_ms

    p, nl, npad = sim.params, st.nlist, sim.caps.nlocal_pad
    cutsq, nb, nn = p.cutforce**2, nl.neighbors, nl.numneigh
    res = {}
    for dtype in (torch.float32, torch.float64):
        x = st.x.to(dtype).contiguous()
        eam = ev.EamDevice.from_tables(sim.eam_tables, x.device, dtype)
        for form, poly in (("poly", sim.eam_poly), ("spline", None)):
            what = f"K5/K6 at {at} ({form}, {str(dtype)[6:]})"
            outs = verlet_eam_pair(torch, x, nb, nn, npad, cutsq, eam, poly,
                                   st.halo.border_map)
            errs = check_verlet_eam_pair(torch, outs, dtype, what)
            fp = outs["fp_in"]
            calls = {
                "K5": (lambda: ev.eam_rho_nlist(x, nb, nn, npad, cutsq, eam, poly),
                       lambda: ev.eam_rho_nlist_ref(x, nb, nn, npad, cutsq, eam, poly)),
                "K6": (lambda: ev.eam_force_nlist(x, nb, nn, fp[:npad], fp, cutsq, eam, poly),
                       lambda: ev.eam_force_nlist_ref(x, nb, nn, fp[:npad], fp, cutsq, eam,
                                                      poly)),
            }
            b5, b6, _, listed, inside = eam_verlet_bounds(torch, sim, st, dtype,
                                                          poly is not None)
            times = {kid: (median_ms(torch, kern, 50), graph_ms(kern, 50),
                           median_ms(torch, plain, 3))
                     for kid, (kern, plain) in calls.items()}
            stream = {kid: listed * nb.element_size() / (times[kid][1] * 1e-3) / 1e12
                      for kid in times}
            blocks = {kid: ev.nlist_blocks_per_sm(name, dtype, poly is not None)
                      for kid, name in (("K5", "eam_rho_nlist"), ("K6", "eam_force_nlist"))}
            print(f"{what} ({npad} rows x K {nb.shape[1]}, {listed} listed pairs, {inside} "
                  f"inside): max abs err rho {errs['rho'][0]:.3e}, fp {errs['fp'][0]:.3e}, f "
                  f"{errs['f'][0]:.3e} (bit for bit), two launches equal; K5 "
                  f"{times['K5'][0]:.4f} ms back to back, {times['K5'][1]:.4f} on the device, "
                  f"plain {times['K5'][2]:.4f}, bound {b5[0]:.4f} ({b5[1]}, "
                  f"{b5[0] / times['K5'][1]:.1%} of it), list stream {stream['K5']:.3f} TB/s, "
                  f"{blocks['K5']} blocks of 8 warps an SM; K6 {times['K6'][0]:.4f} / "
                  f"{times['K6'][1]:.4f} ms, plain {times['K6'][2]:.4f}, bound {b6[0]:.4f} "
                  f"({b6[1]}, {b6[0] / times['K6'][1]:.1%} of it), list stream "
                  f"{stream['K6']:.3f} TB/s, {blocks['K6']} blocks an SM; no shared memory, "
                  f"the spline tables through the read-only cache; on {smi}", flush=True)
            res[dtype, form] = (errs, times, {"K5": b5, "K6": b6}, stream)
    for kernel in ("eam_rho_nlist_kernel", "eam_force_nlist_kernel"):
        for line in kernel_ptxas_lines(kernel):
            print("  " + line)
    rows = []
    for kid, name, out in (("K5", "eam_rho_nlist", "fp"), ("K6", "eam_force_nlist", "f")):
        errs, times, bounds, stream = res[torch.float32, "poly"]
        meta = VERLET_EAM_KERNELS[name]
        if at != "131k":
            meta = {**meta, "name": f"{name} ({at})"}
        row = kernel_row(meta, launches[kid], errs[out][0],
                         times[kid][0], times[kid][2], bounds[kid], device_ms=times[kid][1])
        row["f64_ms"] = res[torch.float64, "poly"][1][kid][0]
        row["spline_ms"] = res[torch.float32, "spline"][1][kid][0]
        row["spline_f64_ms"] = res[torch.float64, "spline"][1][kid][0]
        row["list_tb_s"] = stream[kid]
        rows.append(row)
    return rows


def run_verlet_eam_phases(torch, dev, smi: str, ec, eam_dp) -> tuple:
    """Phases 30-32 (the verlet scheme's EAM force and the verlet stub).
    `eam_dp` is phase 8's cluster DP run (sim, result) on the same box.
    Returns phase 30's verlet DP poly run (sim, result) and the JSON rows
    of K5 and K6."""
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import run_bench_eam
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.engine import Simulation
    from mdbench_tpu_torch.models.eam_tables import apply_eam_overrides, load_eam
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.stub import run_stub

    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")  # phase 8's

    phase(30)
    # 30. verlet EAM at full width: SP auto (poly on the card), SP spline,
    # DP poly and spline; K5 then K6 for every force evaluation
    check_verlet_eam_edges(torch, dev, eam_file)
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    with counted(Simulation, "_force") as n_force:
        sim, out, rate = run_bench_eam(eam_file, "sp", repeats=SEC_REPEATS,
                                       chain=SEC_CHAIN, scheme="verlet")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_verlet_eam_launches(lj, ec, n_force[0], "the verlet EAM run")
    st, p = out.state, sim.params
    if sim.eam_poly is None:
        fail("eam_eval auto did not take the polynomials in SP on the card")
    if not (np.isfinite(out.temps).all() and bool(torch.isfinite(st.v).all())):
        fail("the verlet EAM run's state is not finite")
    t_force, t_neigh = sim.measure_phases(st)
    bound, listed, inside = eam_verlet_bounds(torch, sim, st, p.dtype, True)[2:]
    nn = st.nlist.numneigh[: sim.nlocal].float()
    print(f"verlet EAM main path: {sim.natoms} atoms, {p.ntimes} steps, {p.precision}, "
          f"poly, cutforce {p.cutforce}, cutneigh {p.cutneigh}, caps {tuple(sim.caps)} "
          f"(K = {sim.caps.maxneighs} after the calibration; numneigh mean "
          f"{float(nn.mean()):.2f} max {int(nn.max())}); TOTAL {out.total_time:.6f} s "
          f"per run, {rate:.6e} atom-updates/s, run() wall {wall:.2f} s; FORCE "
          f"{t_force * 1e3:.4f} ms per call, NEIGH {t_neigh * 1e3:.4f} ms per rebuild "
          f"({p.ntimes + 1} forces and {p.ntimes // p.reneigh_every} rebuilds a run); "
          f"force bound {bound[0]:.4f} ms ({bound[1]}; {listed} listed pairs, {inside} "
          f"inside); K5 {launches['K5']} and K6 {launches['K6']} launches for "
          f"{n_force[0]} force evaluations, no other hand kernel; on {smi}", flush=True)
    prof = device_profile(torch, lambda: sim._run_steps(sim.initial_state(), p.ntimes))
    top = sorted(prof["ms"].items(), key=lambda kv: -kv[1])[:8]
    print(f"verlet EAM profile of one {p.ntimes}-step _run_steps (initial state "
          f"included): wall {prof['wall_s']:.4f} s (profiled), device busy "
          f"{prof['busy']:.4f}, {prof['spans']} spans, device ms "
          f"{sum(prof['ms'].values()):.4f}; top kernels (ms): " + "; ".join(
              f"{name[:110]} {ms:.4f}" for name, ms in top) + f" on {smi}", flush=True)
    kw = dict(scheme="verlet", dense_thermo=False, force_field=FF_EAM, eam_file=eam_file,
              ntimes=60)
    runs = {("sp", "poly"): (sim, out)}
    for prec, ev in (("sp", "spline"), ("dp", "poly"), ("dp", "spline")):
        reset_counts(lj, ec)
        with counted(Simulation, "_force") as n_force:
            s_ = Simulation(Params(precision=prec, eam_eval=ev, **kw), device=dev)
            runs[prec, ev] = (s_, s_.run(repeats=1, chain=1))
        k56 = check_verlet_eam_launches(lj, ec, n_force[0], f"the verlet EAM {prec} {ev} run")
        print(f"verlet EAM {prec} {ev}: TOTAL {runs[prec, ev][1].total_time:.6f} s (one "
              f"timed run), K5 {k56['K5']} and K6 {k56['K6']} launches for {n_force[0]} force "
              f"evaluations on {smi}", flush=True)
    for step, tol in EAM_SP_TOL.items():
        for ev in ("poly", "spline"):
            t_sp = float(runs["sp", ev][1].temps[step - 1])
            t_dp = float(runs["dp", ev][1].temps[step - 1])
            rel = abs(t_sp - t_dp) / abs(t_dp)
            print(f"verlet EAM step {step} {ev}: SP {t_sp:.6e} against DP {t_dp:.6e}, rel "
                  f"{rel:.3e} (tol {tol:.0e})", flush=True)
            if not rel <= tol:
                fail(f"verlet EAM SP {ev} departs from DP at step {step}")
    sim_dp, out_dp = runs["dp", "poly"]
    sim_c, out_c = eam_dp
    st_c, st_v = sim_c.initial_state(), sim_dp.initial_state()
    t0_c = float(sim_c._thermo(st_c.vxc, st_c.vyc, st_c.vzc)[0])
    t0_v = float(sim_dp._thermo(st_v.v)[0])
    rel0 = abs(t0_v - t0_c) / t0_c
    print(f"verlet against cluster EAM DP: step 0 {t0_v:.15e} / {t0_c:.15e} (rel "
          f"{rel0:.3e})", flush=True)
    if not rel0 <= 1e-14:
        fail("verlet and cluster EAM start from different temperatures")
    for step in range(20, 61, 20):
        a, b = float(out_dp.temps[step - 1]), float(out_c.temps[step - 1])
        rel = abs(a - b) / abs(b)
        print(f"verlet against cluster EAM DP step {step}: {a:.9e} / {b:.9e}, rel "
              f"{rel:.3e} (tol 1e-6)", flush=True)
        if not rel <= 1e-6:
            fail(f"verlet EAM DP departs from the cluster DP run at step {step}")
    rows = verlet_eam_kernel_rows(torch, sim, st, launches, smi)

    phase(31)
    # 31. verlet EAM card against CPU, float64, 8^3; K5/K6 on every card
    # force; no host synchronisation
    for eam_eval in ("spline", "poly"):
        kw = dict(nx=8, ny=8, nz=8, ntimes=20, reneigh_every=10, precision="dp",
                  force_field=FF_EAM, eam_file=eam_file, eam_eval=eam_eval)
        x, v, _ = create_fcc_lattice(apply_eam_overrides(Params(**kw),
                                                         load_eam(eam_file)))
        x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
        reset_counts(lj, ec)
        with counted(Simulation, "_force") as n_force:
            f_g = Simulation(Params(**kw), x=x, v=v, device=dev).first_force()
            r_g = Simulation(Params(**kw), device=dev).run(repeats=0)
        k56 = check_verlet_eam_launches(lj, ec, n_force[0], f"verlet EAM 8^3 {eam_eval}")
        f_c = Simulation(Params(**kw), x=x, v=v, device="cpu").first_force()
        r_c = Simulation(Params(**kw), device="cpu").run(repeats=0)
        frel = np.abs(f_g - f_c).max() / np.abs(f_c).max()
        trel = float(np.max(np.abs(r_g.temps - r_c.temps) / np.abs(r_c.temps)))
        sim8 = Simulation(Params(**kw), device=dev)
        n_sync = sync_count(torch, lambda: sim8._run_steps(sim8.initial_state(), 20))
        print(f"verlet EAM 8^3 dp {eam_eval}: step-0 force rel err {frel:.3e} (tol "
              f"1e-12), 20-step temperature rel err {trel:.3e} (tol 1e-12), host "
              f"synchronisations in a 20-step run {n_sync}; K5 {k56['K5']} and K6 "
              f"{k56['K6']} launches for the card's {n_force[0]} force evaluations",
              flush=True)
        if not (frel <= 1e-12 and trel <= 1e-12):
            fail(f"the card's verlet EAM ({eam_eval}) disagrees with the CPU")
        if n_sync:
            fail("a verlet EAM run synchronises the host with the card")

    phase(32)
    # 32. the verlet stub on the card (EAM: K5 and K6 on each of its 2 x 200
    # forces); first force against the CPU in float64
    stubs = {"LJ full": {}, "LJ half": {"half": True},
             "EAM spline": {"force_field": "eam", "eam_file": eam_file},
             "EAM poly": {"force_field": "eam", "eam_file": eam_file, "eam_eval": "poly"}}
    for name, kw in stubs.items():
        reset_counts(lj, ec)
        res = run_stub(natoms=65536, nneighs=76, ntimes=200, device=dev, **kw)
        if name.startswith("EAM"):
            counts = check_verlet_eam_launches(lj, ec, 2 * 200, f"the verlet stub {name}")
        else:
            counts = hand_launches(lj, ec)
            if any(counts.values()):
                fail(f"the verlet stub {name} launched a hand kernel: {counts}")
        f = [run_stub(natoms=65536, nneighs=76, ntimes=1, precision="dp", device=d,
                      **kw)["first_force"].cpu() for d in (dev, "cpu")]
        fin = torch.isfinite(f[1])
        same_nf = torch.equal(torch.isfinite(f[0]), fin)
        err = float((f[0][fin] - f[1][fin]).abs().max() / f[1][fin].abs().max())
        print(f"verlet stub {name} (65536 atoms, 76 neighbours, 200 SP steps): "
              f"{res['mega_updates']:.4f} Mega atom updates/s, {res['total']:.6f} s, "
              f"{res['cycles_per_neighbor']:.4f} cycles per neighbour at 2.4 GHz; DP "
              f"first force card against CPU rel {err:.3e} (tol 1e-12), non-finite "
              f"entries equal: {same_nf}; hand-kernel launches "
              f"{ {k: v for k, v in counts.items() if v} }; on {smi}", flush=True)
        if not (err <= 1e-12 and same_nf and bool(fin.any())):
            fail(f"the verlet stub's {name} first force on the card disagrees")
    return runs["dp", "poly"], rows


DOMAIN_KERNELS = {
    "flat": {**KERNEL, "name": "lj_cluster_ilist (slab rows)"},
    "bucketed": {**BUCKET_KERNELS["lj_cluster_ilist_buckets"],
                 "name": "lj_cluster_ilist_buckets (slab rows)"},
}


def run_domain_phases(torch, dev, smi: str, ec, verlet_totals: dict, eam_verlet_dp
                      ) -> list:
    """Phases 34-36 (the slab engine, parallel/verlet_domain, on an
    in-process mesh on the card). `eam_verlet_dp` is phase 30's
    single-engine verlet DP poly run (sim, result) on phase 36's box.
    Returns the JSON rows of K1b on the 1-slab run's row lists and K1 on
    the 4-slab run's."""
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import run_bench_domain
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.parallel.dryrun import dryrun_multichip
    from mdbench_tpu_torch.parallel.staged import StagedDomainEngine
    from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation

    # 34. one slab; 35. two and four slabs: 131k/200 SP, golden-gated
    runs = {}
    for ndev in (1, 2, 4):
        phase(34 if ndev == 1 else 35)
        reset_counts(lj, ec)
        t0 = time.perf_counter()
        reps, chain = SEC_REPEATS, SEC_CHAIN
        sim, out, rate = run_bench_domain(ndev=ndev, repeats=reps, chain=chain)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: getattr(lj, name) for name in LJ_COUNTS}
        k1, k1b = counts["LAUNCHES"], counts["BUCKET_LAUNCHES"]
        others = {k: v for k, v in counts.items()
                  if k not in ("LAUNCHES", "BUCKET_LAUNCHES") and v}
        p, st = sim.params, out.state
        nloc = [int(n) for n in st.nlocal]
        print(f"domain mesh({ndev}): {sim.natoms} atoms, slab width {sim.slab_w:.4f} "
              f"(cutneigh {p.cutneigh}), {p.ntimes} steps, {p.precision}, acap "
              f"{sim.acap}, gcap {sim.gcap}, bcap {sim.bcap}, rcap {sim.rcap}, ccap "
              f"{sim.ccap}, buckets {sim.rbuckets}, grows {sim.grows or 'none'}; atoms per "
              f"slab {nloc}; golden gate "
              f"passed; TOTAL {out.total_time:.6f} s per run ({reps} x {chain} timed), "
              f"{rate:.6e} atom-updates/s (single-engine verlet, phase 27: TOTAL flat "
              f"{verlet_totals['flat']:.6f} s, bucketed {verlet_totals['bucketed']:.6f} "
              f"s), run() wall {wall:.2f} s; launches K1 {k1}, K1b {k1b}, others "
              f"{others}, EAM {dict(ec.LAUNCHES)} on {smi}", flush=True)
        if k1 + k1b == 0 or others or any(ec.LAUNCHES.values()):
            fail(f"the domain run launched K1 {k1}, K1b {k1b}, others {others}")
        if sum(nloc) != sim.natoms:
            fail(f"the slabs hold {sum(nloc)} atoms, not {sim.natoms}")
        if not (np.isfinite(out.temps).all()
                and all(bool(torch.isfinite(v).all()) for v in st.v)):
            fail("the domain run's state is not finite")
        print(f"domain mesh({ndev}) temps: " + " ".join(
            f"{s_}:{out.temps[s_ - 1]:.6e}" for s_ in range(20, p.ntimes + 1, 20)),
            flush=True)
        # one more run of the timed region's kind: its launches and host
        # synchronisations (the initial state built before)
        s0 = sim.initial_state()
        torch.cuda.synchronize()
        reset_counts(lj, ec)
        n_sync = sync_count(torch, lambda: sim._run_steps(s0, p.ntimes))
        k1_t, k1b_t = lj.LAUNCHES, lj.BUCKET_LAUNCHES
        need = ndev * p.ntimes
        want = (0, need) if sim.rbuckets is not None else (need, 0)
        print(f"domain mesh({ndev}) timed run: K1 {k1_t}, K1b {k1b_t} launches (want "
              f"{want}); host synchronisations {n_sync}", flush=True)
        if (k1_t, k1b_t) != want:
            fail(f"the timed domain run launched K1 {k1_t} and K1b {k1b_t} times, not "
                 f"{want}")
        if n_sync:
            fail("a timed domain run synchronises the host with the card")
        if ndev != 2:
            prof = device_profile(torch, lambda: sim._run_steps(sim.initial_state(),
                                                                p.ntimes))
            top = sorted(prof["ms"].items(), key=lambda kv: -kv[1])[:8]
            print(f"domain mesh({ndev}) profile of one {p.ntimes}-step _run_steps (initial "
                  f"state included): wall {prof['wall_s']:.4f} s (profiled), device busy "
                  f"{prof['busy']:.4f}, {prof['spans']} spans, device ms "
                  f"{sum(prof['ms'].values()):.4f}; top kernels (ms): " + "; ".join(
                      f"{name[:90]} {ms:.4f}" for name, ms in top) + f" on {smi}",
                  flush=True)
        runs[ndev] = (sim, out, k1b if sim.rbuckets is not None else k1)
    if runs[1][0].rbuckets is None or runs[4][0].rbuckets is not None:
        fail("the 1-slab run must plan capacity buckets and the 4-slab run none")
    # the dry run on the card: 1, 4 and 8 slabs of a box thinner than 2
    # cutneigh in y and z (1024-atom local blocks, mostly padding, on the
    # verlet leg), against the single engines (it raises on a mismatch)
    # (with phase 41: the cluster slab engine's leg; with phase 45: the
    # pencil leg at 4 and 8 domains, the brick leg at 8)
    for n in (1, 4, 8):
        t0 = time.perf_counter()
        dryrun_multichip(n, device=dev)
        legs = ("verlet, cluster" + (", pencils" if n >= 4 else "")
                + (", bricks" if n >= 8 else ""))
        print(f"dryrun_multichip({n}) on the card ({legs} legs): OK "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    rows = []
    for ndev, bucketed in ((1, True), (4, False)):
        sim, out, launches = runs[ndev]
        st = out.state
        # the lists of the final atoms (one rebuild of the final state)
        d = sim.initial_state(list(st.x), list(st.v), list(st.nlocal))[0]
        rows.append(rowlist_kernel_row(
            torch, lj, sim.params, d.x, d.nlist, sim.acap, sim.rbuckets, smi, launches,
            bucketed, f"{'K1b' if bucketed else 'K1'} (slab rows, mesh({ndev}))",
            DOMAIN_KERNELS["bucketed" if bucketed else "flat"]))

    phase(36)
    # 36. EAM on two slabs, 131k/60 on the stand-in potential: SP poly
    # against DP poly, DP poly against phase 30's single engine (no slab
    # code on that side); an 8^3 DP box card against CPU
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")  # phase 8's
    kw = dict(scheme="verlet", dense_thermo=False, force_field=FF_EAM, eam_file=eam_file,
              ntimes=60)
    eruns = {}
    for prec in ("sp", "dp"):
        reset_counts(lj, ec)
        with counted(StagedDomainEngine, "_forces", len) as n_force:
            sim = DomainSimulation(Params(precision=prec, eam_eval="poly", **kw), ndev=2,
                                   device=dev)
            out = sim.run(repeats=1, chain=1)
        k56 = check_verlet_eam_launches(lj, ec, n_force[0], f"the domain EAM run ({prec})")
        nloc = sum(int(n) for n in out.state.nlocal)
        print(f"domain EAM mesh(2) {prec} poly: {sim.natoms} atoms, {sim.params.ntimes} "
              f"steps, maxneighs {sim.maxneighs}, TOTAL {out.total_time:.6f} s (one timed "
              f"run), K5 {k56['K5']} and K6 {k56['K6']} launches for {n_force[0]} slab "
              f"forces on {smi}", flush=True)
        if nloc != sim.natoms or not np.isfinite(out.temps).all():
            fail(f"the domain EAM run ({prec}) lost atoms ({nloc}) or is not finite")
        eruns[prec] = out
    for step, tol in EAM_SP_TOL.items():
        t_sp = float(eruns["sp"].temps[step - 1])
        t_dp = float(eruns["dp"].temps[step - 1])
        rel = abs(t_sp - t_dp) / abs(t_dp)
        print(f"domain EAM step {step}: SP {t_sp:.6e} against DP {t_dp:.6e}, rel "
              f"{rel:.3e} (tol {tol:.0e})", flush=True)
        if not rel <= tol:
            fail(f"domain EAM SP departs from DP at step {step}")
    # the ghost fp exchange and the migrations against the single engine's
    # border_map refresh, same Params: phase 30 held that run to the
    # cluster DP run at 1e-6 (it matched to the 9 digits printed)
    out_v = eam_verlet_dp[1]
    for step in range(20, 61, 20):
        a, b = float(eruns["dp"].temps[step - 1]), float(out_v.temps[step - 1])
        rel = abs(a - b) / abs(b)
        print(f"domain EAM mesh(2) against verlet EAM DP poly step {step}: {a:.12e} / "
              f"{b:.12e}, rel {rel:.3e} (tol 1e-6)", flush=True)
        if not rel <= 1e-6:
            fail(f"the domain EAM DP run departs from the single engine at step {step}")
    for eam_eval in ("spline", "poly"):
        kw8 = dict(nx=8, ny=8, nz=8, ntimes=20, reneigh_every=10, precision="dp",
                   force_field=FF_EAM, eam_file=eam_file, eam_eval=eam_eval)
        reset_counts(lj, ec)
        with counted(StagedDomainEngine, "_forces", len) as n_force:
            r_g = DomainSimulation(Params(**kw8), ndev=2, device=dev).run(repeats=0)
        k56 = check_verlet_eam_launches(lj, ec, n_force[0], f"domain EAM 8^3 {eam_eval}")
        r_c = DomainSimulation(Params(**kw8), ndev=2, device="cpu").run(repeats=0)
        trel = float(np.max(np.abs(r_g.temps - r_c.temps) / np.abs(r_c.temps)))
        print(f"domain EAM 8^3 dp {eam_eval} mesh(2): 20-step temperature rel err "
              f"{trel:.3e} (tol 1e-12); K5 {k56['K5']} and K6 {k56['K6']} launches for "
              f"{n_force[0]} slab forces", flush=True)
        if not trel <= 1e-12:
            fail(f"the card's domain EAM ({eam_eval}) disagrees with the CPU")
    return rows, {ndev: out.total_time for ndev, (_, out, _) in runs.items()}


# the cluster slab engine's kernels on one slab's final lists (phases 37-40)
CLUSTER_DOMAIN_KERNELS = {
    "K1": {**KERNEL, "name": "lj_cluster_ilist (cluster slab lists)"},
    "K1b": {**BUCKET_KERNELS["lj_cluster_ilist_buckets"],
            "name": "lj_cluster_ilist_buckets (cluster slab lists)"},
    "K4": {**STREAM_KERNEL, "name": "lj_cluster_stream (cluster slab lists)"},
    "K2": {**EAM_KERNELS["eam_rho_ilist"], "name": "eam_rho_ilist (cluster slab lists)"},
    "K3": {**EAM_KERNELS["eam_force_ilist"],
           "name": "eam_force_ilist (cluster slab lists)"},
    "K2b": {**BUCKET_KERNELS["eam_rho_buckets"],
            "name": "eam_rho_buckets (cluster slab lists)"},
    "K3b": {**BUCKET_KERNELS["eam_force_buckets"],
            "name": "eam_force_buckets (cluster slab lists)"},
}


def domain_first_forces(sim) -> list:
    """The step-0 forces of every held domain of a cluster slab engine, in
    the order of its atom window (rows [0, nloc)), float64 numpy."""
    out = []
    for d in sim.initial_state():
        aid = d.cl.atom_id.reshape(-1).cpu().numpy()
        f = np.stack([q.double().cpu().numpy().reshape(-1) for q in (d.fxc, d.fyc, d.fzc)],
                     axis=1)
        n = int(d.nloc)
        fa = np.zeros((sim.acap, 3))
        m = aid >= 0
        fa[aid[m]] = f[m]
        out.append(fa[:n])
    return out


def slab_list_rows(torch, sim, d, launches: dict, smi: str, tag: str, tables=None) -> list:
    """The kernels of one cluster slab's final lists (`d`, a CDomain of
    the engine `sim`): K1 or K1b on exact lists, K4 on group windows, K2/K3
    or K2b/K3b with an EAM `tables`; each against its plain version in
    float32 (<= 1e-5 of max |value|) and float64 (<= 1e-12), the bucketed
    kernels also equal to the flat ones on the same lists; median ms back
    to back and on the device alone (CUDA graph), the plain version's ms
    and the bound from the lists' work (compute_cluster_stats). Returns the
    float32 JSON rows (K1/K1b: the error and time with approx_rcp, the
    run's form, and the exact time as exact_ms); `launches` {id: count in
    the run}."""
    from mdbench_tpu_torch.engine_cluster import GROUP
    from mdbench_tpu_torch.ops import eam_cluster as ec
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops.eam import EamDevice
    from mdbench_tpu_torch.probes import graph_ms
    from mdbench_tpu_torch.stats import compute_cluster_stats

    p, cl, pr = sim.params, d.cl, d.pairs
    npad, share = sim.ncl_pad, sim.ishare
    cut2 = p.cutforce**2
    bucketed = pr.bijlist is not None
    buckets = sim.buckets if bucketed else None
    cs = compute_cluster_stats(cl, pr, npad, GROUP, cut2, p.cutneigh**2, buckets=buckets)
    inside = cs["pairs_within_cutforce"]
    maps = (pr.bijlist, pr.bcrows, pr.binv)
    lists = (nbytes_of(pr.bijlist, pr.bcrows, pr.nji) if bucketed else
             nbytes_of(pr.ijlist, pr.nji) if pr.ijlist is not None else
             nbytes_of(pr.jlist, pr.ranges))
    shape = (f"{pr.ijlist.shape[0]} units x icap {pr.ijlist.shape[1]}"
             if pr.ijlist is not None else
             f"{pr.jlist.shape[0]} groups x L {pr.jlist.shape[1]}")
    print(f"{tag}: {shape}, buckets {buckets}, {inside} pairs inside the cutoff"
          + ("; " + sweep_line(torch, lj, (cl.xc, cl.yc, cl.zc),
                               pr.bijlist if bucketed else pr.ijlist, pr.nji, share, cut2,
                               **({"buckets": (buckets, pr.bcrows)} if bucketed else {}))
             if pr.ijlist is not None else ""), flush=True)

    def calls(planes, dtype):
        """{id: (kernel(approx), plain, flat kernel or None, ops, extra bytes)}"""
        if tables is not None:
            eam = EamDevice.from_tables(tables, planes[0].device, dtype)
            args = (npad, cut2, sim.eam_poly)
            deg = {k: len(getattr(sim.eam_poly, k)) - 1 for k in ("dens", "g1", "g2")}
            ev = ilist_pairs(cs, share)
            rho = ec.eam_rho_ilist_ref(*planes, pr.ijlist, *args, share=share)
            fp = ec.fp_plane_from_rho(rho, eam, d.halo.border_map, planes[0].shape[0])
            ops = (8 * ev + (6 + 2 * deg["dens"]) * inside,
                   8 * ev + (10 + 2 * (deg["g1"] + deg["g2"])) * inside)
            if bucketed:
                return {
                    "K2b": (lambda a=False: (ec.eam_rho_buckets(
                        *planes, *maps, pr.nji, *args, buckets, share=share),),
                        lambda: (ec.eam_rho_buckets_ref(*planes, *maps, *args, buckets,
                                                        share),),
                        lambda: (ec.eam_rho_ilist(*planes, pr.ijlist, pr.nji, *args,
                                                  share=share),), ops[0], 0),
                    "K3b": (lambda a=False: ec.eam_force_buckets(
                        *planes, fp, *maps, pr.nji, *args, buckets, share=share),
                        lambda: ec.eam_force_buckets_ref(*planes, fp, *maps, *args,
                                                         buckets, share),
                        lambda: ec.eam_force_ilist(*planes, fp, pr.ijlist, pr.nji, *args,
                                                   share=share), ops[1], nbytes_of(fp))}
            return {
                "K2": (lambda a=False: (ec.eam_rho_ilist(*planes, pr.ijlist, pr.nji, *args,
                                                         share=share),),
                       lambda: (ec.eam_rho_ilist_ref(*planes, pr.ijlist, *args,
                                                     share=share),), None, ops[0], 0),
                "K3": (lambda a=False: ec.eam_force_ilist(*planes, fp, pr.ijlist, pr.nji,
                                                          *args, share=share),
                       lambda: ec.eam_force_ilist_ref(*planes, fp, pr.ijlist, *args,
                                                      share=share), None, ops[1],
                       nbytes_of(fp))}
        cut = (cut2, p.sigma6, p.epsilon)
        if pr.ijlist is None:
            return {"K4": (
                lambda a=False: lj.lj_cluster_force_stream(*planes, pr.jlist, pr.ranges,
                                                           npad, *cut),
                lambda: lj.lj_cluster_force_group_ref(*planes, pr.jlist, npad, *cut,
                                                      ranges=pr.ranges),
                None, lj_ops(cs["padded_pairs"], inside), 0)}
        ops = lj_ops(ilist_pairs(cs, share), inside)

        def flat(a=False):
            return lj.lj_cluster_force_ilist(*planes, pr.ijlist, pr.nji, npad, *cut,
                                             share=share, approx_rcp=a)

        if bucketed:
            return {"K1b": (
                lambda a=False: lj.lj_cluster_force_buckets(
                    *planes, *maps, pr.nji, npad, buckets, *cut, share=share,
                    approx_rcp=a),
                lambda: lj.lj_cluster_force_buckets_ref(*planes, *maps, npad, buckets,
                                                        *cut, share=share),
                flat, ops, 0)}
        return {"K1": (flat, lambda: lj.lj_cluster_force_ilist_ref(
            *planes, pr.ijlist, npad, *cut, share=share), None, ops, 0)}

    rows = {}
    for dtype in (torch.float32, torch.float64):
        planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]
        for kid, (kern, plain, flat, ops, extra) in calls(planes, dtype).items():
            approx = kid in ("K1", "K1b")
            out, want = kern(), plain()
            err, rel = rel_err(torch, out, want)
            err_a, rel_a = rel_err(torch, kern(True), want) if approx else (err, rel)
            same = flat is None or all(torch.equal(a, b) for a, b in zip(out, flat()))
            ms = median_ms(torch, kern, 50)
            ms_a = median_ms(torch, lambda: kern(True), 50) if approx else ms
            dev_ms = graph_ms(lambda: kern(approx), 50)
            plain_ms = median_ms(torch, plain, 5)
            bound = bound_of(ops, nbytes_of(*planes, *out) + lists + extra, dtype)
            tol = tol_of(torch, dtype)
            print(f"{kid} ({tag}, {str(dtype)[6:]}): max abs err {err:.3e}, rel {rel:.3e} "
                  f"(tol {tol:.0e})" + (f", with approx_rcp (the run's form) {err_a:.3e}, "
                                        f"rel {rel_a:.3e}" if approx else "")
                  + (f"; equal to the flat kernel: {same}" if flat is not None else "")
                  + f"; median {ms:.4f} ms back to back" + (
                      f" exact, {ms_a:.4f} ms with approx_rcp" if approx else "")
                  + f", on the device (CUDA graph) {dev_ms:.4f} ms; plain {plain_ms:.4f} "
                  f"ms; bound {bound[0]:.4f} ms ({bound[1]}); launches in the run "
                  f"{launches.get(kid, 0)} on {smi}", flush=True)
            if not (rel <= tol and rel_a <= tol and same):
                fail(f"{kid} on the cluster slab lists ({tag}) disagrees with its plain "
                     f"version or its flat kernel ({dtype})")
            if dtype == torch.float32:
                rows[kid] = kernel_row(CLUSTER_DOMAIN_KERNELS[kid], launches.get(kid, 0),
                                       err_a, ms_a, plain_ms, bound,
                                       exact_ms=ms if approx else None, device_ms=dev_ms)
    return list(rows.values())


def run_cluster_domain_phases(torch, dev, smi: str, ec, single_total: float,
                              eam_dp) -> list:
    """Phases 37-41 (the cluster slab engine, parallel/cluster_domain, on
    an in-process mesh on the card). `single_total` is phase 4's
    single-engine TOTAL; `eam_dp` phase 8's single-engine cluster DP EAM run
    (sim, result). Returns the JSON rows of the kernels on the slab
    lists."""
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import run_bench_domain
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.models.eam_tables import apply_eam_overrides, load_eam
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation

    kid_of = {"LAUNCHES": "K1", "BUCKET_LAUNCHES": "K1b", "STREAM_LAUNCHES": "K4"}
    # 37. one slab; 38. two and four slabs;
    # 39. kernel="pallas" on two slabs (one timed run each): 131k/200 SP,
    # golden-gated
    runs = {}
    for ndev, kernel, reps, chain in ((1, "auto", SEC_REPEATS, SEC_CHAIN),
                                      (2, "auto", 1, 1),
                                      (4, "auto", 1, 1), (2, "pallas", 1, 1)):
        phase(37 if ndev == 1 else 39 if kernel == "pallas" else 38)
        tag = f"cluster mesh({ndev}){' pallas' if kernel == 'pallas' else ''}"
        reset_counts(lj, ec)
        t0 = time.perf_counter()
        sim, out, rate = run_bench_domain(ndev=ndev, kernel=kernel, repeats=reps,
                                          chain=chain, scheme="cluster")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: getattr(lj, name) for name in LJ_COUNTS}
        p = sim.params
        need = ndev * (1 + reps * chain) * (p.ntimes + 1)
        main = ("STREAM_LAUNCHES" if kernel == "pallas" else
                "BUCKET_LAUNCHES" if sim.buckets is not None else "LAUNCHES")
        setup = "LAUNCHES" if main == "BUCKET_LAUNCHES" else None
        others = {k: v for k, v in counts.items() if k not in (main, setup) and v}
        units = sim.ncl_pad // sim.ishare
        print(f"{tag}: {sim.natoms} atoms, slab width {sim.slab_w:.4f} (cutneigh "
              f"{p.cutneigh}), {p.ntimes} steps, {p.precision}, ncl_pad {sim.ncl_pad} "
              f"({units} units a slab), acap {sim.acap}, gcap_rows {sim.gcap_rows}, "
              f"xcap16 {sim.xcap16}, icap {sim.icap}, list_cap {sim.list_cap}, buckets "
              f"{sim.buckets}, grows {sim.grows or 'none'}; atoms per slab "
              f"{[int(n) for n in out.nlocal]}; golden gate passed; TOTAL "
              f"{out.total_time:.6f} s per run ({reps} x {chain} timed), {rate:.6e} "
              f"atom-updates/s (single engine, phase 4: TOTAL {single_total:.6f} s; "
              f"mesh / single {out.total_time / single_total:.4f}), run() wall "
              f"{wall:.2f} s; launches {kid_of[main]} {counts[main]} (>= {need} force "
              f"evaluations of the checked and timed runs), set-up K1 "
              f"{counts['LAUNCHES'] if setup else 0}, others {others}, EAM "
              f"{dict(ec.LAUNCHES)} on {smi}", flush=True)
        if kernel == "auto" and sim.buckets is None:
            print(f"{tag}: no bucket plan: {units} units a slab, below the planner's "
                  f"4096 (ops/cluster.plan_capacity_buckets); K1 runs every force",
                  flush=True)
        if counts[main] < need or others or any(ec.LAUNCHES.values()):
            fail(f"{tag} launched {counts} (EAM {dict(ec.LAUNCHES)}): {kid_of[main]} "
                 f"must cover its {need} force evaluations, and nothing else launch")
        if setup and not 0 < counts[setup] < ndev * (p.ntimes + 1):
            fail(f"{tag}: K1 launched {counts[setup]} times, not only for the set-up "
                 f"forces before the plan")
        if int(out.nlocal.sum()) != sim.natoms:
            fail(f"{tag}: the slabs hold {int(out.nlocal.sum())} atoms, not {sim.natoms}")
        if not (np.isfinite(out.temps).all()
                and all(bool(torch.isfinite(d.vxc).all()) for d in out.state)):
            fail(f"{tag}: the state is not finite")
        print(f"{tag} temps: " + " ".join(f"{s_}:{out.temps[s_ - 1]:.6e}"
                                          for s_ in range(20, p.ntimes + 1, 20)),
              flush=True)
        # one more run of the timed region's kind (the initial state built
        # before): its launches and host synchronisations by site
        s0 = sim.initial_state()
        torch.cuda.synchronize()
        reset_counts(lj, ec)
        sites = sync_sites(torch, lambda: sim._run_steps(s0, p.ntimes))
        got = {k: getattr(lj, k) for k in LJ_COUNTS if getattr(lj, k)}
        own = {w: n for w, n in sites.items() if w.startswith("parallel/")}
        shared = {w: n for w, n in sites.items() if w not in own}
        print(f"{tag} timed run: launches {got} (want {kid_of[main]} {ndev * p.ntimes}); "
              f"host synchronisations: the domain engine's own {sum(own.values())} "
              f"{own}, the shared cluster ops' {sum(shared.values())} {shared}",
              flush=True)
        if got != {main: ndev * p.ntimes}:
            fail(f"{tag}: the timed run launched {got}")
        if own:
            fail(f"{tag}: the domain engine synchronises the host with the card")
        if ndev == 1:
            prof = device_profile(torch, lambda: sim._run_steps(sim.initial_state(),
                                                                p.ntimes))
            top = sorted(prof["ms"].items(), key=lambda kv: -kv[1])[:8]
            print(f"{tag} profile of one {p.ntimes}-step _run_steps (initial state "
                  f"included): wall {prof['wall_s']:.4f} s (profiled), device busy "
                  f"{prof['busy']:.4f}, {prof['spans']} spans, device ms "
                  f"{sum(prof['ms'].values()):.4f}; top kernels (ms): " + "; ".join(
                      f"{name[:90]} {ms:.4f}" for name, ms in top) + f" on {smi}",
                  flush=True)
        runs[(ndev, kernel)] = (sim, out, {kid_of[k]: v for k, v in counts.items()
                                           if k in kid_of})
    if runs[(1, "auto")][0].buckets is None:
        fail("the 1-slab cluster run must plan capacity buckets")
    rows = []
    for key in ((1, "auto"), (4, "auto"), (2, "pallas")):
        sim, out, launches = runs[key]
        rows += slab_list_rows(torch, sim, out.state[0], launches, smi,
                               f"cluster mesh({key[0]}) {key[1]}, slab 0's final lists")

    phase(40)
    # 40. cluster EAM on two slabs, 131k/60 on phase 8's stand-in potential
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")
    tables = load_eam(eam_file)
    kw = dict(scheme="cluster", dense_thermo=False, force_field=FF_EAM, eam_file=eam_file,
              ntimes=60)
    eruns = {}
    for prec in ("sp", "dp"):
        reset_counts(lj, ec)
        sim = ClusterDomainSimulation(Params(precision=prec, **kw), ndev=2, device=dev)
        out = sim.run(repeats=1, chain=1)
        hand = {n: getattr(lj, n) for n in LJ_COUNTS if getattr(lj, n)}
        e = dict(ec.LAUNCHES)
        need = 2 * 2 * (sim.params.ntimes + 1)
        pair = (("eam_rho_buckets", "eam_force_buckets") if sim.buckets is not None
                else ("eam_rho_ilist", "eam_force_ilist"))
        setup_ok = sim.buckets is None or all(
            0 < e[n] < 2 * (sim.params.ntimes + 1) for n in ("eam_rho_ilist",
                                                              "eam_force_ilist"))
        print(f"cluster EAM mesh(2) {prec}: {sim.natoms} atoms, {sim.params.ntimes} "
              f"steps, ncl_pad {sim.ncl_pad}, icap {sim.icap}, buckets {sim.buckets}, "
              f"grows {sim.grows or 'none'}; TOTAL {out.total_time:.6f} s (one timed "
              f"run); launches {e} (want {pair} >= {need}), LJ {hand}; atoms per slab "
              f"{[int(n) for n in out.nlocal]} on {smi}", flush=True)
        if (hand or any(e[n] < need for n in pair) or not setup_ok
                or int(out.nlocal.sum()) != sim.natoms or not np.isfinite(out.temps).all()):
            fail(f"the cluster EAM mesh(2) run ({prec}) launched {e}, LJ {hand}, or lost "
                 f"atoms")
        eruns[prec] = (sim, out, {"K2b" if sim.buckets is not None else "K2": e[pair[0]],
                                  "K3b" if sim.buckets is not None else "K3": e[pair[1]]})
    out_single = eam_dp[1]
    for step, tol in EAM_SP_TOL.items():
        t_sp = float(eruns["sp"][1].temps[step - 1])
        t_dp = float(eruns["dp"][1].temps[step - 1])
        t_1 = float(out_single.temps[step - 1])
        rel, rel1 = abs(t_sp - t_dp) / abs(t_dp), abs(t_dp - t_1) / abs(t_1)
        print(f"cluster EAM mesh(2) step {step}: SP {t_sp:.6e} against DP {t_dp:.12e}, "
              f"rel {rel:.3e} (tol {tol:.0e}); DP against the single engine's DP "
              f"(phase 8) {t_1:.12e}, rel {rel1:.3e} (tol 1e-6)", flush=True)
        if not (rel <= tol and rel1 <= 1e-6):
            fail(f"the cluster EAM mesh(2) run departs at step {step}")
    sim, out, launches = eruns["sp"]
    rows += slab_list_rows(torch, sim, out.state[0], launches, smi,
                           "cluster EAM mesh(2), slab 0's final lists", tables=tables)

    phase(41)
    # 41. small input on two slabs, card against the CPU plain path: a
    # jittered 6^3 DP LJ box and a 6^3 DP EAM box, full and cheap rebuilds
    for what, kw in (("LJ 6^3", dict(nx=6, ny=6, nz=6)),
                     ("EAM 6^3", dict(nx=6, ny=6, nz=6, force_field=FF_EAM,
                                      eam_file=eam_file))):
        kw.update(ntimes=40, reneigh_every=10, resort_every=20, precision="dp",
                  scheme="cluster")
        p0 = Params(**kw)
        if "eam_file" in kw:
            apply_eam_overrides(p0, tables)
        x, v, _ = create_fcc_lattice(p0)
        x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
        f = {d: domain_first_forces(ClusterDomainSimulation(Params(**kw), ndev=2, x=x,
                                                            v=v, device=d))
             for d in ("cpu", dev)}
        scale = max(np.abs(a).max() for a in f["cpu"])
        frel = max(np.abs(a - b).max() for a, b in zip(f[dev], f["cpu"])) / scale
        r = {d: ClusterDomainSimulation(Params(**kw), ndev=2, device=d).run(repeats=0)
             for d in ("cpu", dev)}
        trel = float(np.max(np.abs(r[dev].temps - r["cpu"].temps)
                            / np.abs(r["cpu"].temps)))
        print(f"cluster mesh(2) small input {what} dp: step-0 force rel err {frel:.3e} "
              f"(tol 1e-12), 40-step temperature rel err {trel:.3e} (tol 1e-9); atoms "
              f"per slab {[int(n) for n in r[dev].nlocal]}", flush=True)
        if not (frel <= 1e-12 and trel <= 1e-9
                and list(r[dev].nlocal) == list(r["cpu"].nlocal)):
            fail(f"the card's cluster mesh(2) run ({what}) disagrees with the CPU")
    return rows


def mesh_tag(dims) -> str:
    return f"{'pencil' if len(dims) == 2 else 'brick'} mesh{tuple(dims)}"


def run_mesh_domain_phases(torch, dev, smi: str, ec, verlet_totals: dict,
                           slab_totals: dict, eam_verlet_dp) -> list:
    """Phases 42-45 (the pencil and brick engines, parallel/verlet_domain2d
    and parallel/verlet_domain3d, on in-process meshes on the card).
    `verlet_totals` are phase 27's single-engine TOTALs, `slab_totals`
    phases 34-35's slab TOTALs by slab count, `eam_verlet_dp` phase 30's
    single-engine verlet DP poly run (sim, result). Returns the JSON rows
    of K1 (or K1b) on one pencil's and one brick's final row lists."""
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import run_bench_domain
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.parallel.staged import StagedDomainEngine
    from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation
    from mdbench_tpu_torch.parallel.verlet_domain3d import Domain3DSimulation

    def engine(dims):
        return Domain2DSimulation if len(dims) == 2 else Domain3DSimulation

    # 42. pencils (2, 2); 43. bricks (2, 2, 2) and (2, 2, 1), whose z axis
    # of size 1 sends to itself: 131k/200 SP on the row lists, one timed
    # run each, golden-gated
    runs = {}
    for dims in ((2, 2), (2, 2, 2), (2, 2, 1)):
        phase(42 if len(dims) == 2 else 43)
        tag = mesh_tag(dims)
        reset_counts(lj, ec)
        t0 = time.perf_counter()
        sim, out, rate = run_bench_domain(mesh=dims, repeats=1, chain=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: getattr(lj, name) for name in LJ_COUNTS}
        p, st = sim.params, out.state
        main = "BUCKET_LAUNCHES" if sim.rbuckets is not None else "LAUNCHES"
        setup = "LAUNCHES" if main == "BUCKET_LAUNCHES" else None
        others = {k: v for k, v in counts.items() if k not in (main, setup) and v}
        need = sim.ndev * 2 * (p.ntimes + 1)  # the checked and the timed run's forces
        nloc = [int(n) for n in st.nlocal]
        units = sim.acap // 16
        print(f"{tag}: {sim.natoms} atoms, domain "
              f"{' x '.join(f'{w:.4f}' for w in sim.w)} (cutneigh {p.cutneigh}), "
              f"{p.ntimes} steps, {p.precision}, acap {sim.acap} ({units} units a "
              f"domain), gcap {sim.gcap}, bcaps {sim.bcaps}, migcap {sim.migcap}, rcap "
              f"{sim.rcap}, ccap {sim.ccap}, buckets {sim.rbuckets}, grows "
              f"{sim.grows or 'none'}; atoms per domain {nloc}; golden gate passed; "
              f"TOTAL {out.total_time:.6f} s (one timed run), {rate:.6e} atom-updates/s "
              f"(single-engine verlet, phase 27: TOTAL flat {verlet_totals['flat']:.6f} "
              f"s, bucketed {verlet_totals['bucketed']:.6f} s; four slabs, phase 35: "
              f"{slab_totals[4]:.6f} s; mesh / single flat "
              f"{out.total_time / verlet_totals['flat']:.4f}), run() wall {wall:.2f} s; "
              f"launches K1 {counts['LAUNCHES']}, K1b {counts['BUCKET_LAUNCHES']} (>= "
              f"{need} force evaluations of the checked and timed runs), others "
              f"{others}, EAM {dict(ec.LAUNCHES)} on {smi}", flush=True)
        if sim.rbuckets is None:
            print(f"{tag}: no bucket plan: {units} units a domain, below the planner's "
                  f"4096 (ops/cluster.plan_capacity_buckets); K1 runs every force",
                  flush=True)
        if counts[main] < need or others or any(ec.LAUNCHES.values()):
            fail(f"{tag} launched {counts} (EAM {dict(ec.LAUNCHES)}): K1/K1b must cover "
                 f"its {need} force evaluations, and nothing else launch")
        if setup and counts[setup] < 1:
            fail(f"{tag}: K1 never ran the set-up forces before the plan")
        if sum(nloc) != sim.natoms:
            fail(f"{tag}: the domains hold {sum(nloc)} atoms, not {sim.natoms}")
        if not (np.isfinite(out.temps).all()
                and all(bool(torch.isfinite(v).all()) for v in st.v)):
            fail(f"{tag}: the state is not finite")
        print(f"{tag} temps: " + " ".join(f"{s_}:{out.temps[s_ - 1]:.6e}"
                                          for s_ in range(20, p.ntimes + 1, 20)),
              flush=True)
        if dims == (2, 2, 1):
            sent = st.x[0].shape[0] - 1
            nz = [int((m != sent).sum()) for m in st.maps[0][2]]
            every = slice(p.reneigh_every - 1, None, p.reneigh_every)
            a, b = out.temps[every], runs[(2, 2)][1].temps[every]
            print(f"{tag}: the z stage's self-send carries {nz} rows (left, right) "
                  f"on domain 0; temperatures at the rebuild steps against the (2, 2) "
                  f"pencils' max rel "
                  f"{float(np.max(np.abs(a - b) / np.abs(b))):.3e} (SP, other summation "
                  f"orders)", flush=True)
            if sim.exchange.shape[2] != 1 or min(nz) == 0:
                fail(f"{tag}: the z seam did not go through the self-send")
        # one more run of the timed region's kind (the initial state built
        # before): its launches and host synchronisations by site
        s0 = sim.initial_state()
        torch.cuda.synchronize()
        reset_counts(lj, ec)
        sites = sync_sites(torch, lambda: sim._run_steps(s0, p.ntimes))
        got = {k: getattr(lj, k) for k in LJ_COUNTS if getattr(lj, k)}
        own = {w: n for w, n in sites.items() if w.startswith("parallel/")}
        shared = {w: n for w, n in sites.items() if w not in own}
        print(f"{tag} timed run: launches {got} (want {main} {sim.ndev * p.ntimes}); "
              f"host synchronisations: the domain engine's own {sum(own.values())} "
              f"{own}, the shared ops' {sum(shared.values())} {shared}", flush=True)
        if got != {main: sim.ndev * p.ntimes} or any(ec.LAUNCHES.values()):
            fail(f"{tag}: the timed run launched {got}")
        if own:
            fail(f"{tag}: the domain engine synchronises the host with the card")
        if dims != (2, 2, 1):
            prof = device_profile(torch, lambda: sim._run_steps(sim.initial_state(),
                                                                p.ntimes))
            top = sorted(prof["ms"].items(), key=lambda kv: -kv[1])[:8]
            print(f"{tag} profile of one {p.ntimes}-step _run_steps (initial state "
                  f"included): wall {prof['wall_s']:.4f} s (profiled), device busy "
                  f"{prof['busy']:.4f}, {prof['spans']} spans, device ms "
                  f"{sum(prof['ms'].values()):.4f}; top kernels (ms): " + "; ".join(
                      f"{name[:90]} {ms:.4f}" for name, ms in top) + f" on {smi}",
                  flush=True)
        runs[dims] = (sim, out, counts[main])

    phase(44)
    # 44. EAM 131k/60 on phase 8's stand-in potential, pencils (2, 2) and
    # bricks (2, 2, 2): SP poly against DP poly, DP poly against phase 30's
    # single engine; K5 and K6 for every domain force
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")
    kw = dict(scheme="verlet", dense_thermo=False, force_field=FF_EAM, eam_file=eam_file,
              ntimes=60)
    out_v = eam_verlet_dp[1]
    for dims in ((2, 2), (2, 2, 2)):
        tag = f"EAM {mesh_tag(dims)}"
        eruns = {}
        for prec in ("sp", "dp"):
            reset_counts(lj, ec)
            with counted(StagedDomainEngine, "_forces", len) as n_force:
                sim = engine(dims)(Params(precision=prec, eam_eval="poly", **kw), *dims,
                                   device=dev)
                out = sim.run(repeats=1, chain=1)
            k56 = check_verlet_eam_launches(lj, ec, n_force[0], f"the {tag} run ({prec})")
            nloc = sum(int(n) for n in out.state.nlocal)
            print(f"{tag} {prec} poly: {sim.natoms} atoms, {sim.params.ntimes} steps, "
                  f"maxneighs {sim.maxneighs}, acap {sim.acap}, bcaps {sim.bcaps}, grows "
                  f"{sim.grows or 'none'}, TOTAL {out.total_time:.6f} s (one timed run), "
                  f"K5 {k56['K5']} and K6 {k56['K6']} launches for {n_force[0]} domain forces "
                  f"on {smi}", flush=True)
            if nloc != sim.natoms or not np.isfinite(out.temps).all():
                fail(f"the {tag} run ({prec}) lost atoms ({nloc}) or is not finite")
            eruns[prec] = out
        for step, tol in EAM_SP_TOL.items():
            t_sp = float(eruns["sp"].temps[step - 1])
            t_dp = float(eruns["dp"].temps[step - 1])
            t_1 = float(out_v.temps[step - 1])
            rel, rel1 = abs(t_sp - t_dp) / abs(t_dp), abs(t_dp - t_1) / abs(t_1)
            print(f"{tag} step {step}: SP {t_sp:.6e} against DP {t_dp:.12e}, rel "
                  f"{rel:.3e} (tol {tol:.0e}); DP against the single engine's verlet "
                  f"EAM DP poly (phase 30) {t_1:.12e}, rel {rel1:.3e} (tol 1e-6)",
                  flush=True)
            if not (rel <= tol and rel1 <= 1e-6):
                fail(f"the {tag} run departs at step {step}")

    phase(45)
    # 45. small inputs, card against the CPU: a jittered 6^3 DP box on the
    # row lists; then K1 (K1b after a plan) on one pencil's and one
    # brick's final row lists of phases 42-43
    kw8 = dict(nx=6, ny=6, nz=6, ntimes=20, reneigh_every=10, precision="dp")
    x, v, _ = create_fcc_lattice(Params(**kw8))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    for dims in ((2, 2), (2, 2, 2)):
        r = {d: engine(dims)(Params(**kw8), *dims, x=x, v=v, device=d).run(repeats=0)
             for d in ("cpu", dev)}
        trel = float(np.max(np.abs(r[dev].temps - r["cpu"].temps)
                            / np.abs(r["cpu"].temps)))
        n_dev = [int(n) for n in r[dev].state.nlocal]
        n_cpu = [int(n) for n in r["cpu"].state.nlocal]
        print(f"{mesh_tag(dims)} small input: jittered 6^3 dp on the row lists, 20-step "
              f"temperature rel err {trel:.3e} (tol 1e-12); atoms per domain {n_dev} "
              f"(CPU {n_cpu})", flush=True)
        if not (trel <= 1e-12 and n_dev == n_cpu):
            fail(f"the card's {mesh_tag(dims)} run disagrees with the CPU")
    rows = []
    for dims, what in (((2, 2), "pencil"), ((2, 2, 2), "brick")):
        sim, out, launches = runs[dims]
        st = out.state
        bucketed = sim.rbuckets is not None
        # the lists of the final atoms (one rebuild of the final state)
        d = sim.initial_state(list(st.x), list(st.v), list(st.nlocal))[0]
        kid = "K1b" if bucketed else "K1"
        meta = (BUCKET_KERNELS["lj_cluster_ilist_buckets"] if bucketed else KERNEL)
        rows.append(rowlist_kernel_row(
            torch, lj, sim.params, d.x, d.nlist, sim.acap, sim.rbuckets, smi, launches,
            bucketed, f"{kid} ({what} rows, {mesh_tag(dims)})",
            {**meta, "name": f"{kid} on {what} rows"}))
    return rows


def run_cli_phase(torch, smi: str) -> None:
    """Phase 33: the command line (mdbench_tpu_torch.cli): verlet and
    cluster LJ at 131k/200 SP with nstat 20, golden-gated; the output
    options on 8^3; EAM on both schemes. The first run is `python -m
    mdbench_tpu_torch.cli` in a subprocess (the machine has no jax, so it
    shows that the entry point needs none); the others call cli.main in
    this process, which saves a process start (~10 s) each."""
    phase(33)
    import io
    import shutil
    from pathlib import Path

    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch import cli as cli_module
    from mdbench_tpu_torch.bench import root_bench

    kind = torch.cuda.get_device_name(0)
    root = Path(__file__).resolve().parent
    work = _build.BUILD_DIR / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "nstat20.conf").write_text("nstat 20\n")
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")

    def cli(args: str, *files: str, fresh: bool = False) -> str:
        t0 = time.perf_counter()
        if fresh:
            res = subprocess.run([sys.executable, "-m", "mdbench_tpu_torch.cli",
                                  *args.split()], cwd=root, capture_output=True,
                                 text=True, timeout=600)
            out, rc, err = res.stdout, res.returncode, res.stderr
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_module.main(args.split())
            out, err = buf.getvalue(), ""
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"cli {args} exited {rc}: {err[-2000:]}")
        missing = [f for f in files if not (work / f).exists()]
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("Device:", "TOTAL", "Performance:"))]
        print(f"cli {args}: {wall:.1f} s wall; " + "; ".join(lines), flush=True)
        if missing or f"Device: {kind}, force: " not in out:
            fail(f"cli {args}: no device line naming the card, or files {missing} "
                 "missing")
        if "million atom updates per second" not in out or "Statistics:" not in out:
            fail(f"cli {args}: no Performance line or statistics")
        return out

    for scheme, force in (("verlet", "K1b (approx_rcp)"), ("cluster", "K1b (approx_rcp)")):
        out = cli(f"-p {work / 'nstat20.conf'} --precision sp --scheme {scheme}",
                  fresh=scheme == "verlet")
        temps = np.full(200, np.nan)
        for ln in out.splitlines():
            f = ln.split("\t")
            if len(f) == 3 and f[0].isdigit() and int(f[0]) > 0:
                temps[int(f[0]) - 1] = float(f[1])
        root_bench().check_golden(temps, 20)
        print(f"cli {scheme} 131k/200 SP: golden gate passed "
              f"({', '.join(f'{s}:{temps[s - 1]:.6e}' for s in range(20, 201, 20))})",
              flush=True)
        if f"force: {force}" not in out:
            fail(f"cli {scheme} did not run {force}")
    small = "-nx 8 -ny 8 -nz 8 -n 40 --precision dp"
    cli(f"{small} --vtk {work}/t --xtc {work}/t.xtc -w {work}/atoms.in "
        f"--checkpoint {work}/ck.npz", "t_0.vtk", "t_20.vtk", "t_40.vtk", "t.xtc",
        "atoms.in", "ck.npz")
    out = cli(f"{small} --scheme cluster --trace-index {work}/ti_ --trace-mem "
              f"{work}/tm_ --timers diff", *(f"t{k}_{n}_tracer_{s}.out"
                                             for k, n in (("i", "index"), ("m", "mem"))
                                             for s in (0, 20, 40)))
    if "(timers: diff" not in out:
        fail("cli --timers diff printed no differential timers")
    out = cli(f"{small} --restore {work}/ck.npz")
    if "restored 2048 atoms at step 40" not in out:
        fail("cli --restore did not resume from the checkpoint")
    for scheme, force in (("verlet", "K5/K6 (EAM poly)"), ("cluster", "K2b/K3b")):
        out = cli(f"-f eam -e {eam_file} -n 60 --precision sp --scheme {scheme}")
        if f"force: {force}" not in out:
            fail(f"cli EAM {scheme} did not run {force}")
    print(f"cli runs on {smi}", flush=True)


# the scale runs (phases 46-48): at 1M each SP run meets a DP run of the
# same box at steps 20 and 40 within the golden gate's early tolerance
# (bench.py: rel 1e-3 through step 60); the verlet EAM run meets its DP
# run within EAM_SP_TOL; at 10.1M the 8 slabs meet the single engine
SCALE_STEPS = (20, 40)
SCALE_SP_TOL = (1e-3, 1e-3)
SLAB_TOL = (1e-4, 1e-4)


def chunk_counts(verlet, fn) -> list:
    """The number of chunks of each ops/verlet._chunks loop that fn() runs,
    in call order (the loops read the module's _chunks at each call)."""
    real, counts = verlet._chunks, []

    def wrapped(n, per_item, max_elems=None):
        slices = real(n, per_item, max_elems)
        counts.append(len(slices))
        return slices

    verlet._chunks = wrapped
    try:
        fn()
    finally:
        verlet._chunks = real
    return counts


def rebuild_line(torch, what: str, fn, chunks=None) -> str:
    """A rebuild fn() at scale, run twice: first for its peak bytes above
    what was allocated before it and, with `chunks` (ops.verlet), the
    chunk count of each chunked loop; then for its host synchronisations
    by site (sync_sites)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n = None
    if chunks is None:
        fn()
    else:
        n = chunk_counts(chunks, fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    sites = sync_sites(torch, fn)
    return (f"{what}: host synchronisations {sum(sites.values())} {sites}, peak "
            f"{peak} bytes ({peak / 2**30:.3f} GiB) above the state"
            + (f", chunks per loop {n}" if n is not None else ""))


def scale_kernel_row(torch, meta, what: str, kern, plain, launches: int, ops: int,
                     bytes_in: int, smi: str, same=None) -> dict:
    """A kernel on a scale run's final lists (phases 46-48), float32: one
    launch against its plain version (max abs error over max |value| <=
    1e-5; `same`, if given, another form that must give the same bits);
    median ms back to back (10 launches, 3 batches) and on the device
    alone (CUDA graph), the plain version's ms (one call); the bound of
    `ops` operations and `bytes_in` plus the output's bytes. Returns the
    JSON row."""
    from mdbench_tpu_torch.probes import graph_ms

    out = kern()
    err, rel = rel_err(torch, out, plain())
    equal = same is None or all(torch.equal(a, b) for a, b in zip(out, same()))
    ms = median_ms(torch, kern, 10, batches=3, warm=1)
    dev_ms = graph_ms(kern, 10, batches=3)
    plain_ms = median_ms(torch, plain, 1, batches=1, warm=0)
    bound = bound_of(ops, bytes_in + nbytes_of(*out), torch.float32)
    print(f"{what}: max abs err {err:.3e}, rel {rel:.3e} (tol 1e-05)"
          + ("" if same is None else f", the same bits as its other form: {equal}")
          + f"; median {ms:.4f} ms back to back, {dev_ms:.4f} ms on the device (CUDA "
          f"graph); plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}; "
          f"{ops} operations); {launches} launches on the main path; on {smi}",
          flush=True)
    if not (rel <= 1e-5 and equal):
        fail(f"{what} disagrees with its plain version or its other form")
    return kernel_row(meta, launches, err, ms, plain_ms, bound, device_ms=dev_ms)


def plain_ilist_by_units(torch, lj, planes, ijlist, share: int, cut, xi=None,
                        max_elems: int = 1 << 26) -> tuple:
    """ops/lj_cluster.lj_cluster_force_ilist_ref in chunks of units (its
    (units, i-atoms, listed atoms) blocks for a whole 10.1M box would take
    tens of GB): each chunk the plain version on its units' lists with
    their i-rows as `xi` (default the planes' first rows), the j rows from
    the whole planes; the rows concatenated."""
    nu, icap = ijlist.shape
    xi = tuple(q[: nu * share] for q in planes) if xi is None else xi
    per = max(1, max_elems // (share * 8 * icap * 16))
    parts = []
    for u0 in range(0, nu, per):
        r0, r1 = u0 * share, min(u0 + per, nu) * share
        parts.append(lj.lj_cluster_force_ilist_ref(
            *planes, ijlist[u0 : u0 + per], r1 - r0, *cut, share=share,
            xi=tuple(q[r0:r1] for q in xi)))
    return tuple(torch.cat(fs) for fs in zip(*parts))


def plain_buckets_by_units(torch, lj, planes, maps, buckets, share: int, cut) -> tuple:
    """lj_cluster_force_buckets_ref with each bucket's plain force in
    chunks of units (plain_ilist_by_units): the i rows permuted through
    bcrows, the buckets' rows gathered back through binv."""
    bijlist, bcrows, binv = maps
    xi = [q[bcrows.long()] for q in planes]
    return lj.per_bucket(
        3, bijlist, binv, buckets, share, planes[0],
        lambda jl, n, r0, r1: plain_ilist_by_units(
            torch, lj, planes, jl, share, cut, xi=tuple(q[r0:r1] for q in xi)))


def exact_list_rows(torch, lj, planes, lists: dict, npad: int, share: int, p,
                    rbuckets, launches: dict, tag: str, smi: str) -> list:
    """K1b (the bucketed form) and K1 (the flat form, on the same lists:
    the same bits) with approx_rcp, the main path's form, on a scale run's
    final exact lists or row lists: `lists` holds ijlist, nji and the bucket
    maps bijlist, bcrows, binv. The plain versions run in chunks of units
    (plain_ilist_by_units, plain_buckets_by_units). Bound: 8 operations a
    listed pair and 15 more inside the cutoff (ilist_sweep_counts).
    Returns the two rows."""
    cut = (p.cutforce**2, p.sigma6, p.epsilon)
    ijl, nji = lists["ijlist"], lists["nji"]
    maps = (lists["bijlist"], lists["bcrows"], lists["binv"])
    c = lj.ilist_sweep_counts(*planes, maps[0], nji, share, cut[0],
                              buckets=(rbuckets, maps[1]))
    ops = lj_ops(int(c["listed"].sum()), int(c["inside"].sum()))

    def k1b():
        return lj.lj_cluster_force_buckets(*planes, *maps, nji, npad, rbuckets, *cut,
                                           share=share, approx_rcp=True)

    def k1():
        return lj.lj_cluster_force_ilist(*planes, ijl, nji, npad, *cut, share=share,
                                         approx_rcp=True)

    print(f"K1b/K1 on the {tag}: {ijl.shape[0]} units x cap {ijl.shape[1]}, list "
          f"length mean {float(nji.float().mean()):.2f} max {int(nji.max())}, buckets "
          f"{rbuckets}", flush=True)
    return [
        scale_kernel_row(
            torch, {**BUCKET_KERNELS["lj_cluster_ilist_buckets"],
                    "name": f"lj_cluster_ilist_buckets ({tag})"},
            f"K1b on the {tag}", k1b,
            lambda: plain_buckets_by_units(torch, lj, planes, maps, rbuckets, share,
                                           cut),
            launches["BUCKET_LAUNCHES"], ops,
            nbytes_of(*planes, maps[0], maps[1], nji), smi, same=k1),
        scale_kernel_row(
            torch, {**KERNEL, "name": f"lj_cluster_ilist ({tag})"}, f"K1 on the {tag}",
            k1, lambda: plain_ilist_by_units(torch, lj, planes, ijl, share, cut),
            launches["LAUNCHES"], ops, nbytes_of(*planes, ijl, nji), smi),
    ]


def run_scale_phases(torch, dev, smi: str, ec) -> list:
    """Phases 46-48: the JAX package's scale configurations through
    bench.run_bench_scale (tools/r3_scale.py's 1M run on both schemes,
    verlet EAM at 1M, and tests/test_parallel.py's 10.1M box on the verlet
    single engine and on 8 slabs of an in-process mesh). Returns their
    kernels' JSON rows."""
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import check_trace, root_bench, run_bench_scale
    from mdbench_tpu_torch.engine import Simulation
    from mdbench_tpu_torch.engine_cluster import GROUP
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops import verlet
    from mdbench_tpu_torch.ops.cluster import M, N_J
    from mdbench_tpu_torch.parallel.verlet_domain import plan_capacities
    from mdbench_tpu_torch.stats import compute_cluster_stats

    golden = root_bench().GOLDEN_TEMP_131K

    def temps_line(temps, steps) -> str:
        return " ".join(f"{s}:{float(temps[s - 1]):.6e}" for s in steps)

    def scale_run(what: str, **kw):
        """run_bench_scale on the card with every count reset before it;
        prints the run and returns (sim, result, counts of the kernels
        that launched)."""
        reset_counts(lj, ec)
        t0 = time.perf_counter()
        sim, out, rate, peak = run_bench_scale(device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in hand_launches(lj, ec).items() if v}
        p = sim.params
        if not np.isfinite(out.temps).all():
            fail(f"{what}: the temperatures are not finite")
        timed = kw.get("repeats", 1) * kw.get("chain", 1)
        print(f"{what}: {sim.natoms} atoms, {p.ntimes} steps, {p.precision}; TOTAL "
              + (f"{out.total_time:.6f} s per run ({timed} timed), {rate:.6e} "
                 "atom-updates/s" if timed else "not timed (the reference trace)")
              + f"; set-up: construction {sim.construct_time:.2f} s (lattice, host "
              f"sort, upload), run()'s {sim.setup_time:.2f} s (initial state, "
              f"calibrations); run_bench_scale wall {wall:.2f} s; peak {peak} bytes "
              f"({peak / 2**30:.3f} GiB); launches {counts} on {smi}", flush=True)
        print(f"{what} temps: {temps_line(out.temps, range(20, p.ntimes + 1, 20))}"
              f" (GOLDEN_TEMP_131K, for reference only: "
              f"{' '.join(f'{s}:{golden[s]:.6e}' for s in range(20, p.ntimes + 1, 20))})",
              flush=True)
        return sim, out, counts

    def need_launches(what, counts, main: str, setup, need: int):
        others = {k: v for k, v in counts.items() if k not in (main, setup)}
        if counts.get(main, 0) < need or (setup and counts.get(setup, 0) < 1) or others:
            fail(f"{what} launched {counts}: {main} >= {need}"
                 + (f" and {setup} at set-up" if setup else "") + ", nothing else")

    def gate(what, temps, ref, steps, tols):
        for s, tol in zip(steps, tols):
            t, r = float(temps[s - 1]), float(ref[s - 1])
            print(f"{what} step {s}: {t:.9e} against {r:.9e}, rel "
                  f"{abs(t - r) / abs(r):.3e} (tol {tol:.0e})", flush=True)
        check_trace(temps, ref, steps, tols)

    rows = []
    phase(46)
    # 46. 1M LJ (64^3 cells), 40 steps: a DP verlet run is the reference
    # trace; SP cluster auto (K1, then K1b), cluster pallas (K4) and verlet
    # auto (K1, then K1b) must meet it
    lj1m = dict(nx=64, ntimes=40)
    sim_r, out_r, counts = scale_run("1M LJ verlet DP (reference)", scheme="verlet",
                                     precision="dp", repeats=0, **lj1m)
    if counts.keys() - {"LAUNCHES", "BUCKET_LAUNCHES"} or sum(counts.values()) < 41:
        fail(f"the 1M DP reference run launched {counts}: K1 or K1b for its 41 "
             "forces, nothing else")
    ref = out_r.temps
    del sim_r, out_r
    need = 2 * (lj1m["ntimes"] + 1)  # the checked run and one timed run
    runs = {}
    for scheme, kernel, main, setup in (("cluster", "auto", "BUCKET_LAUNCHES", "LAUNCHES"),
                                        ("cluster", "pallas", "STREAM_LAUNCHES", None),
                                        ("verlet", "auto", "BUCKET_LAUNCHES", "LAUNCHES")):
        what = f"1M LJ {scheme} {kernel} SP"
        sim, out, counts = scale_run(what, scheme=scheme, kernel=kernel, **lj1m)
        need_launches(what, counts, main, setup, need)
        gate(f"{what} against DP", out.temps, ref, SCALE_STEPS, SCALE_SP_TOL)
        if kernel == "auto":
            t_force, t_neigh = sim.measure_phases(out.state)
            print(f"{what}: FORCE {t_force * 1e3:.4f} ms per call, NEIGH "
                  f"{t_neigh * 1e3:.4f} ms per rebuild (measure_phases); TOTAL "
                  f"{out.total_time:.6f} s against {lj1m['ntimes']} FORCE + "
                  f"{lj1m['ntimes'] // 20} NEIGH = "
                  f"{lj1m['ntimes'] * t_force + lj1m['ntimes'] // 20 * t_neigh:.6f} s "
                  f"on {smi}", flush=True)
        runs[scheme, kernel] = (sim, out, counts)

    # the kernels on the final 1M lists: K1b and K1 on the cluster exact
    # lists, K4 on the group windows, K1b and K1 on the verlet rows
    sim, out, counts = runs["cluster", "auto"]
    cl, pr, p = out.state.clusters, out.state.pairs, sim.params
    L = pr.jlist.shape[1]
    per = max(1, (1 << 25) // (GROUP * M * L * N_J))
    print(rebuild_line(torch, "1M cluster full rebuild (_reneighbor_from_flat)",
                       lambda: sim._reneighbor_from_flat(sim.x_flat0, sim.v_flat0))
          + f"; derive_ilists chunks {-(-pr.jlist.shape[0] // per)} of {per} groups "
          f"(L {L})", flush=True)
    rows += exact_list_rows(
        torch, lj, (cl.xc, cl.yc, cl.zc),
        dict(ijlist=pr.ijlist, nji=pr.nji, bijlist=pr.bijlist, bcrows=pr.bcrows,
             binv=pr.binv), sim.n_clusters_pad, sim.ishare, p, sim.buckets, counts,
        "cluster lists, 1M", smi)
    sim, out, counts = runs["cluster", "pallas"]
    cl, pr, p = out.state.clusters, out.state.pairs, sim.params
    npad, cut = sim.n_clusters_pad, (p.cutforce**2, p.sigma6, p.epsilon)
    cs = compute_cluster_stats(cl, pr, npad, GROUP, p.cutforce**2, p.cutneigh**2)
    planes = (cl.xc, cl.yc, cl.zc)
    rows.append(scale_kernel_row(
        torch, {**STREAM_KERNEL, "name": "lj_cluster_stream (1M)"},
        f"K4 on the 1M group windows ({pr.jlist.shape[0]} groups x L "
        f"{pr.jlist.shape[1]}, {cs['padded_pairs']} window pairs)",
        lambda: lj.lj_cluster_force_stream(*planes, pr.jlist, pr.ranges, npad, *cut),
        lambda: lj.lj_cluster_force_group_ref(*planes, pr.jlist, npad, *cut,
                                              ranges=pr.ranges),
        counts["STREAM_LAUNCHES"], lj_ops(cs["padded_pairs"], cs["pairs_within_cutforce"]),
        nbytes_of(*planes, pr.jlist, pr.ranges), smi))
    sim, out, counts = runs["verlet", "auto"]
    st = out.state
    if sim.rbuckets is None:
        fail("the 1M verlet run planned no capacity buckets")
    print(rebuild_line(torch, "1M verlet rebuild (_reneighbor)",
                       lambda: sim._reneighbor(st.x, st.types), verlet), flush=True)
    rows += verlet_row_rows(torch, lj, sim.params, st.x, st.nlist, sim.caps.nlocal_pad,
                            sim.rbuckets, counts, "verlet rows, 1M", smi)
    del runs, sim, out, st, cl, pr, planes
    torch.cuda.empty_cache()

    phase(47)
    # 47. 1M verlet EAM (64^3 cells on the stand-in potential), 60 steps:
    # SP poly against DP poly; K5 then K6 on every force
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")
    write_standin_funcfl(eam_file)
    eam = {}
    for prec in ("dp", "sp"):
        what = f"1M verlet EAM {prec} poly"
        with counted(Simulation, "_force") as n_force:
            sim, out, _ = scale_run(what, nx=64, ntimes=60, scheme="verlet",
                                    force_field="eam", eam_file=eam_file,
                                    eam_eval="poly", precision=prec,
                                    repeats=0 if prec == "dp" else 1)
        launches = check_verlet_eam_launches(lj, ec, n_force[0], what)
        print(f"{what}: K5 {launches['K5']} and K6 {launches['K6']} launches for "
              f"{n_force[0]} force evaluations", flush=True)
        eam[prec] = (sim, out, launches)
    sim, out, launches = eam["sp"]
    gate("1M verlet EAM SP against DP", out.temps, eam["dp"][1].temps,
         tuple(EAM_SP_TOL), tuple(EAM_SP_TOL.values()))
    del eam["dp"]
    t_force, t_neigh = sim.measure_phases(out.state)
    print(f"1M verlet EAM SP: FORCE {t_force * 1e3:.4f} ms per call, NEIGH "
          f"{t_neigh * 1e3:.4f} ms per rebuild (measure_phases), K = "
          f"{sim.caps.maxneighs}; on {smi}", flush=True)
    print(rebuild_line(torch, "1M verlet EAM rebuild (_reneighbor)",
                       lambda: sim._reneighbor(out.state.x, out.state.types), verlet),
          flush=True)
    rows += verlet_eam_kernel_rows(torch, sim, out.state, launches, smi, at="1M")
    del eam, sim, out
    torch.cuda.empty_cache()

    phase(48)
    # 48. 10.1M LJ (136^3 cells), SP, 40 steps: the verlet single engine,
    # then 8 slabs of an in-process mesh on the same card
    big = dict(nx=136, ntimes=40, scheme="verlet")
    sim, out, counts = scale_run("10.1M LJ verlet SP, single engine", **big)
    need_launches("10.1M single engine", counts, "BUCKET_LAUNCHES", "LAUNCHES",
                  2 * (big["ntimes"] + 1))
    p, st = sim.params, out.state
    t0 = float((sim.v0.double() ** 2).sum()) * p.mass * sim.scales.t_scale
    print(f"10.1M single engine: step-0 temperature {t0:.9e} (float64 sum of the "
          f"float32 velocities) against Params.temp {p.temp} (rel "
          f"{abs(t0 - p.temp) / p.temp:.3e}, tol 1e-06)", flush=True)
    if not abs(t0 - p.temp) <= 1e-6 * p.temp:
        fail("the 10.1M run does not start at Params.temp")
    plan1 = plan_capacities(p, 1, sim.natoms)
    print(f"10.1M single engine: caps {tuple(sim.caps)}, rcap {sim.rcap}, ccap "
          f"{sim.ccap}, buckets {sim.rbuckets}; plan_capacities(p, 1, natoms) "
          f"{plan1['bytes_per_device']} bytes ({plan1['bytes_per_device'] / 2**30:.3f} "
          f"GiB)", flush=True)
    if sim.rbuckets is None:
        fail("the 10.1M verlet run planned no capacity buckets")
    print(rebuild_line(torch, "10.1M verlet rebuild (_reneighbor)",
                       lambda: sim._reneighbor(st.x, st.types), verlet), flush=True)
    rows += verlet_row_rows(torch, lj, p, st.x, st.nlist, sim.caps.nlocal_pad,
                            sim.rbuckets, counts, "verlet rows, 10.1M", smi)
    single_total, single_temps = out.total_time, out.temps
    del sim, out, st
    torch.cuda.empty_cache()
    ndev = 8
    sim, out, counts = scale_run(f"10.1M LJ verlet SP, {ndev} slabs", ndev=ndev, **big)
    p, st = sim.params, out.state
    need_launches(f"10.1M on {ndev} slabs", counts, "BUCKET_LAUNCHES", "LAUNCHES",
                  ndev * 2 * (big["ntimes"] + 1))
    nloc = [int(n) for n in st.nlocal]
    t0 = (float(sum((v.double() ** 2).sum() for v in sim.v0)) * p.mass
          * sim.scales.t_scale)
    plan8 = plan_capacities(p, ndev, sim.natoms)
    print(f"10.1M on {ndev} slabs: atoms per slab {nloc} (sum {sum(nloc)}); step-0 "
          f"temperature {t0:.9e} (rel {abs(t0 - p.temp) / p.temp:.3e} to Params.temp); "
          f"TOTAL {out.total_time:.6f} s against the single engine's {single_total:.6f} "
          f"s ({out.total_time / single_total:.3f}x); acap {sim.acap}, gcap {sim.gcap}, "
          f"bcap {sim.bcap}, rcap {sim.rcap}, buckets {sim.rbuckets}, grows "
          f"{sim.grows or 'none'}; plan_capacities(p, {ndev}, natoms) bytes_per_device "
          f"x {ndev} = {plan8['bytes_per_device'] * ndev} bytes "
          f"({plan8['bytes_per_device'] * ndev / 2**30:.3f} GiB) on {smi}", flush=True)
    if sum(nloc) != sim.natoms:
        fail(f"the slabs hold {sum(nloc)} atoms, not {sim.natoms}")
    if not abs(t0 - p.temp) <= 1e-6 * p.temp:
        fail("the 10.1M slab run does not start at Params.temp")
    gate(f"10.1M {ndev} slabs against the single engine", out.temps, single_temps,
         SCALE_STEPS, SLAB_TOL)
    d = sim.initial_state(list(st.x), list(st.v), list(st.nlocal))[0]
    if sim.rbuckets is None:
        fail(f"the 10.1M {ndev}-slab run planned no capacity buckets")
    rows += verlet_row_rows(torch, lj, p, d.x, d.nlist, sim.acap, sim.rbuckets,
                            counts, f"slab rows, {ndev} slabs, 10.1M", smi)
    return rows


def list_members(torch, a, na, b, nb):
    """(units, cap_a) bool: entry k of row u of list `a` (k < na[u]) is
    among the first nb[u] entries of row u of list `b`."""
    pos_a = torch.arange(a.shape[1], device=a.device)[None, :]
    pos_b = torch.arange(b.shape[1], device=b.device)[None, :]
    live_b = torch.where(pos_b < nb[:, None], b.long(), torch.iinfo(torch.int64).max)
    sb = live_b.sort(dim=1).values
    idx = torch.searchsorted(sb, a.long().contiguous()).clamp(max=b.shape[1] - 1)
    return (sb.gather(1, idx) == a.long()) & (pos_a < na[:, None])


def planned_lists(torch, pairs, npad: int, share: int, total_rows: int):
    """An exact-list derive at the group lists' width cut to the engine's
    calibrated capacity (ClusterSimulation._calibrate_list_cap: max nji x
    1.15 + 2, to a multiple of 8) with the bucket plan of its nji
    (_plan_buckets: margin 2, zero tier) and its maps: (pairs, icap, plan,
    padded pairs of the plan)."""
    from mdbench_tpu_torch.ops.cluster import M, N_J, attach_bucket_maps, plan_capacity_buckets

    icap = max((int(int(pairs.nji.max()) * 1.15) + 2 + 7) // 8 * 8, 16)
    pr = pairs._replace(ijlist=pairs.ijlist[:, :icap].contiguous())
    plan = plan_capacity_buckets(pr.nji.cpu().numpy(), icap, share, margin=2,
                                 zero_tier=True)
    if plan is None:
        fail("no bucket plan for the 131k lists")
    pr = attach_bucket_maps(pr, npad, share, total_rows, *plan)
    return pr, icap, plan, sum(n * c for n, c in zip(*plan)) * share * M * N_J


def run_bf16_derive_phase(torch, dev, smi: str, ec, lj_main, single: tuple,
                          eam_dp) -> list:
    """Phase 49: the bf16 derive (Params.derive_bf16). `lj_main` is phase
    4's (sim, final state, K1b launches), `single` its (TOTAL,
    temperatures), `eam_dp` phase 8's DP run (sim, result). Returns the
    JSON row of K1b on the bf16-derived lists."""
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import run_bench, run_bench_eam
    from mdbench_tpu_torch.engine_cluster import GROUP
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops.cluster import (
        bf16_cutoff,
        bf16_extents,
        bf16_reach,
        derive_ilists,
    )
    from mdbench_tpu_torch.probes import graph_ms

    phase(49)
    # 49a. both derives on phase 4's final state, at the group lists' width
    sim, st, _ = lj_main
    cl, p, share, npad = st.clusters, sim.params, sim.ishare, sim.n_clusters_pad
    L = st.pairs.jlist.shape[1]
    derive = {b: (lambda b=b: derive_ilists(cl, st.pairs, npad, GROUP, p.cutneigh, L,
                                            share=share, bf16=b)) for b in (False, True)}
    ex, bf = derive[False](), derive[True]()
    sentinel = cl.xc.shape[0] // 2 - 1
    pos = torch.arange(L, device=dev)[None, :]
    dropped = int((~list_members(torch, ex.ijlist, ex.nji, bf.ijlist, bf.nji)
                   & (pos < ex.nji[:, None])).sum())
    extra = (~list_members(torch, bf.ijlist, bf.nji, ex.ijlist, ex.nji)
             & (pos < bf.nji[:, None]))
    early_sentinel = int(((bf.ijlist == sentinel) & (pos < bf.nji[:, None])).sum())
    u, k = extra.nonzero(as_tuple=True)
    j = bf.ijlist[u, k].long()
    planes = [q.double() for q in (cl.xc, cl.yc, cl.zc)]
    ia = [q[:npad].reshape(-1, share * 8)[u] for q in planes]  # (extras, i-atoms)
    ja = [q.reshape(-1, 16)[j] for q in planes]  # (extras, 16)
    ok = ((torch.stack(ia).abs() < 5e29).all(0)[:, :, None]
          & (torch.stack(ja).abs() < 5e29).all(0)[:, None, :])
    d2 = sum((a[:, :, None] - b[:, None, :]) ** 2 for a, b in zip(ia, ja))
    dist = torch.where(ok, d2, torch.inf).amin((1, 2)).sqrt()
    ext = bf16_extents(cl, npad, GROUP, share)
    reach = bf16_reach(ext, p.cutneigh)[u]
    cut_eff, err_r = bf16_cutoff([b.double() for b in ext], p.cutneigh)
    shell = (torch.sqrt(cut_eff) + err_r)[u]
    n_extra = int(u.numel())
    worst = float((dist / reach).max()) if n_extra else 0.0
    worst_shell = float((dist / shell).max()) if n_extra else 0.0
    inside = int((dist <= p.cutneigh).sum())
    lists = {}
    for name, d in (("f32", ex), ("bf16", bf)):
        lists[name] = planned_lists(torch, d, npad, share, cl.xc.shape[0])
    print(f"bf16 derive lists on phase 4's final state ({npad // share} units, share "
          f"{share}, group lists L {L}): nji sum f32 {int(ex.nji.sum())}, bf16 "
          f"{int(bf.nji.sum())} (+{int(bf.nji.sum() - ex.nji.sum())}, "
          f"{float(bf.nji.sum() / ex.nji.sum() - 1) * 100:.3f}%), max f32 "
          f"{int(ex.nji.max())}, bf16 {int(bf.nji.max())}; exact entries dropped "
          f"{dropped}; extra entries {n_extra}, at most {float(dist.max()) if n_extra else 0:.6f} "
          f"from their unit (cutneigh {p.cutneigh}), max distance / reach {worst:.6f}, "
          f"/ (sqrt(cut_eff) + err_r) {worst_shell:.6f}, {inside} within cutneigh; "
          f"sentinel j16s before nji {early_sentinel}; calibrated icap f32 "
          f"{lists['f32'][1]}, bf16 {lists['bf16'][1]}; bucket plans f32 "
          f"{lists['f32'][2]}, bf16 {lists['bf16'][2]}; padded pairs f32 "
          f"{lists['f32'][3]}, bf16 {lists['bf16'][3]}", flush=True)
    if dropped or early_sentinel or inside or not (worst <= 1.0 and worst_shell <= 1.0):
        fail("the bf16 lists are not a superset of the exact lists within the shell")

    # 49c. the 131k/200 SP run with derive_bf16 through the entry point:
    # K1 at set-up, K1b after the plan, nothing else
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    sim_b, out_b, rate = run_bench(repeats=SEC_REPEATS, chain=SEC_CHAIN, derive_bf16=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in hand_launches(lj, ec).items() if v}
    need = (1 + SEC_REPEATS * SEC_CHAIN) * (p.ntimes + 1)
    stb = out_b.state
    taken = single[1] != 0  # dense_thermo off: the rebuild steps' temperatures
    trel = float(np.max(np.abs(out_b.temps - single[1])[taken] / np.abs(single[1][taken])))
    again = derive_ilists(stb.clusters, stb.pairs, npad, GROUP, p.cutneigh, sim_b.icap,
                          share=share, bf16=True)
    print(f"bf16 derive run 131k/200 SP (run_bench(derive_bf16=True)): golden gate "
          f"passed; TOTAL {out_b.total_time:.6f} s (one timed run; phase 4's "
          f"{single[0]:.6f} s), {rate:.6e} atom-updates/s, run_bench wall {wall:.2f} s; "
          f"temperatures against phase 4's: max rel {trel:.3e}; icap {sim_b.icap} "
          f"(phase 4: {sim.icap}), buckets {sim_b.buckets}, grows "
          f"{sim_b.grows or 'none'} (phase 4: {sim.grows or 'none'}); launches {counts}; "
          f"final lists the bf16 derive's: {torch.equal(again.nji, stb.pairs.nji)}; on "
          f"{smi}", flush=True)
    if not sim_b._derive_bf16 or sim_b.buckets is None:
        fail("the bf16 derive run took no bf16 derive or planned no buckets")
    if (set(counts) != {"LAUNCHES", "BUCKET_LAUNCHES"} or counts["BUCKET_LAUNCHES"] < need):
        fail(f"the bf16 derive run launched {counts}: K1 at set-up and K1b for its "
             f"{need} force evaluations, nothing else")
    if not torch.equal(again.nji, stb.pairs.nji):
        fail("the bf16 derive run's final lists are not the bf16 derive's")
    if not np.isfinite(out_b.temps).all():
        fail("the bf16 derive run's temperatures are not finite")

    # 49b. the A/B of tools/r3_derive16.py on phase 4's final state, in
    # turns: the derive alone (event-fenced, as the run pays it, and from a
    # CUDA graph, the device's share), NEIGH of the two engines, K1b on both
    # lists' plans; the verdict
    turns = ("f32", "bf16", "bf16", "f32") * 2
    ms_derive, dev_derive = {}, {}
    for name in turns:
        ms_derive.setdefault(name, []).append(
            median_ms(torch, derive[name == "bf16"], 1, batches=11, warm=2))
    for name in turns[:4]:
        dev_derive.setdefault(name, []).append(graph_ms(derive[name == "bf16"], 3))
    t_force, t_neigh = {}, {}
    for name, s_, st_ in (("f32", sim, st), ("bf16", sim_b, stb)):
        t_force[name], t_neigh[name] = s_.measure_phases(st_)
    cut = (p.cutforce**2, p.sigma6, p.epsilon)
    xyz = (cl.xc, cl.yc, cl.zc)

    def k1b(name):
        pr, _, plan, _ = lists[name]
        return lambda: lj.lj_cluster_force_buckets(
            *xyz, pr.bijlist, pr.bcrows, pr.binv, pr.nji, npad, plan, *cut,
            share=share, approx_rcp=True)

    same = all(torch.equal(a, b) for a, b in zip(k1b("f32")(), k1b("bf16")()))
    ms_k1b, dev_k1b = {}, {}
    for name in turns[:4]:
        ms_k1b.setdefault(name, []).append(median_ms(torch, k1b(name), 50))
        dev_k1b.setdefault(name, []).append(graph_ms(k1b(name), 50))
    med, dmed, mk, dk = ({n: float(np.median(v)) for n, v in d.items()}
                         for d in (ms_derive, dev_derive, ms_k1b, dev_k1b))
    extra_pairs = lists["bf16"][3] - lists["f32"][3]
    per_pair = dk["f32"] / lists["f32"][3]
    rhs = extra_pairs * per_pair
    print(f"bf16 derive A/B at 131k (phase 4's final state; in turns f32, bf16, bf16, "
          f"f32): derive_ilists alone f32 {med['f32']:.4f} ms, bf16 {med['bf16']:.4f} "
          f"ms (median of the turns' medians of 11 event-fenced calls: f32 "
          f"{ms_derive['f32']}, bf16 {ms_derive['bf16']}); from a CUDA graph (the "
          f"device alone) f32 {dmed['f32']:.4f} ms, bf16 {dmed['bf16']:.4f} ms (f32 "
          f"{dev_derive['f32']}, bf16 {dev_derive['bf16']}); measure_phases NEIGH f32 "
          f"{t_neigh['f32'] * 1e3:.4f} ms, bf16 {t_neigh['bf16'] * 1e3:.4f} ms, FORCE "
          f"f32 {t_force['f32'] * 1e3:.4f} ms, bf16 {t_force['bf16'] * 1e3:.4f} ms; K1b "
          f"(approx_rcp) on the f32 lists {mk['f32']:.4f} ms back to back, "
          f"{dk['f32']:.4f} ms on the device, on the bf16 lists {mk['bf16']:.4f} ms, "
          f"{dk['bf16']:.4f} ms on the device, the same forces on both: {same}; on {smi}",
          flush=True)
    for what, saved in (("event-fenced", med["f32"] - med["bf16"]),
                        ("device alone", dmed["f32"] - dmed["bf16"])):
        lhs = saved / p.reneigh_every
        print(f"bf16 derive verdict, {what} (tools/r3_derive16.py: adopt iff saved "
              f"derive ms / reneigh_every > extra padded pairs x kernel ms a pair): "
              f"{saved:.4f} / {p.reneigh_every} = {lhs:.5f} ms against {extra_pairs} x "
              f"{per_pair:.4e} = {rhs:.5f} ms (K1b's device time on the f32 plan / its "
              f"padded pairs; measured K1b difference {dk['bf16'] - dk['f32']:.5f} ms a "
              f"step): {'ADOPT' if lhs > rhs else 'REJECT'} (printed only; "
              f"Params.derive_bf16 stays False)", flush=True)
    # a control: the exact derive's run again, against phase 4's trace
    ctrl = run_bench(repeats=0, chain=1)[1].temps
    crel = float(np.max(np.abs(ctrl - single[1])[taken] / np.abs(single[1][taken])))
    print(f"bf16 derive run against phase 4's temperatures: max rel {trel:.3e}; the "
          f"exact derive's run again (not timed) against phase 4's: max rel {crel:.3e}",
          flush=True)

    # 49d. K1b on the run's final (bf16-derived) lists against its plain
    # version, f32 with the approximate reciprocal as the run takes it
    planes_b = (stb.clusters.xc, stb.clusters.yc, stb.clusters.zc)
    maps = (stb.pairs.bijlist, stb.pairs.bcrows, stb.pairs.binv)
    c = lj.ilist_sweep_counts(*planes_b, maps[0], stb.pairs.nji, share, cut[0],
                              buckets=(sim_b.buckets, maps[1]))
    row = scale_kernel_row(
        torch, {**BUCKET_KERNELS["lj_cluster_ilist_buckets"],
                "name": "lj_cluster_ilist_buckets (bf16-derived lists)"},
        f"K1b on the bf16-derived 131k lists (buckets {sim_b.buckets})",
        lambda: lj.lj_cluster_force_buckets(*planes_b, *maps, stb.pairs.nji, npad,
                                            sim_b.buckets, *cut, share=share,
                                            approx_rcp=True),
        lambda: plain_buckets_by_units(torch, lj, planes_b, maps, sim_b.buckets, share,
                                       cut),
        counts["BUCKET_LAUNCHES"], lj_ops(int(c["listed"].sum()), int(c["inside"].sum())),
        nbytes_of(*planes_b, maps[0], maps[1], stb.pairs.nji), smi,
        same=lambda: lj.lj_cluster_force_ilist(*planes_b, stb.pairs.ijlist,
                                               stb.pairs.nji, npad, *cut, share=share,
                                               approx_rcp=True))

    # 49e. cluster EAM 131k/60 SP with derive_bf16 on phase 8's stand-in
    # potential: K2b and K3b for every force after the plan, SP against
    # phase 8's DP run
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")
    reset_counts(lj, ec)
    sim_e, out_e, _ = run_bench_eam(eam_file, "sp", repeats=SEC_REPEATS, chain=SEC_CHAIN,
                                    derive_bf16=True)
    torch.cuda.synchronize()
    counts = {k: v for k, v in hand_launches(lj, ec).items() if v}
    need = (1 + SEC_REPEATS * SEC_CHAIN) * (sim_e.params.ntimes + 1)
    print(f"bf16 derive cluster EAM 131k/60 SP: TOTAL {out_e.total_time:.6f} s (one "
          f"timed run), icap {sim_e.icap}, buckets {sim_e.buckets}, grows "
          f"{sim_e.grows or 'none'}; launches {counts} (K2 and K3 >= 1 at set-up, K2b "
          f"and K3b each >= {need}) on {smi}", flush=True)
    want = {"eam_rho_ilist": 1, "eam_force_ilist": 1, "eam_rho_buckets": need,
            "eam_force_buckets": need}
    if (not sim_e._derive_bf16 or sim_e.buckets is None or set(counts) != set(want)
            or any(counts[k] < n for k, n in want.items())):
        fail("the bf16 derive EAM run took another path or launched another kernel")
    for step, tol in EAM_SP_TOL.items():
        t_sp, t_dp = float(out_e.temps[step - 1]), float(eam_dp[1].temps[step - 1])
        rel = abs(t_sp - t_dp) / abs(t_dp)
        print(f"bf16 derive EAM step {step}: T sp {t_sp:.6e}, dp (phase 8) {t_dp:.6e}, "
              f"rel {rel:.3e} (tol {tol:.0e})", flush=True)
        if not rel <= tol:
            fail(f"the bf16 derive EAM run departs from the DP run at step {step}")
    return [row]


def run_prune_phase(torch, dev, smi: str) -> list:
    """Phase 50: the verlet row lists' exact prune (csrc/verlet_prune.cu).
    On prune_edge_cases in both types, then on the candidates of a rebuild from the final state
    of a 20-step SP run of the 131k and the 1M engine (their ranges
    builds; at 131k the cells build's too), the kernel must give
    exact_prune_ref's rows and counts bit for bit. At the engines' ranges
    candidates: ms back to back and on the device (CUDA graph), the plain
    version's ms, the kernel's launches in the run, and the bound by
    operations, 8 a distance (each real unit atom against the 16 atoms of
    each candidate other than the sentinel). Returns the JSON rows."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine import Simulation
    from mdbench_tpu_torch.ops import verlet
    from mdbench_tpu_torch.probes import graph_ms

    phase(50)

    def same(args, what: str):
        got, want = verlet._exact_prune(*args), verlet.exact_prune_ref(*args)
        torch.cuda.synchronize()
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"the prune kernel disagrees with exact_prune_ref on {what}")
        return got

    names = []
    for np_dtype in (np.float32, np.float64):
        for name, case in prune_edge_cases(np_dtype).items():
            names.append(f"{name} ({np_dtype.__name__})")
            same(prune_tensors(torch, case, dev), names[-1])
    print(f"prune kernel on the edge cases {names}: the same bits as exact_prune_ref",
          flush=True)
    rows = []
    for nx, tag in ((32, "131k"), (64, "1M")):
        verlet.PRUNE_LAUNCHES = 0
        sim = Simulation(Params(nx=nx, ny=nx, nz=nx, ntimes=20, precision="sp"),
                         device=dev)
        st = sim.run(repeats=0).state
        launches = verlet.PRUNE_LAUNCHES
        args = prune_operands(sim, st)
        same(args, f"the {tag} engine's ranges candidates")
        if nx == 32:
            sim._rowbuild_ranges = False
            same(prune_operands(sim, st), f"the {tag} engine's cells candidates")
        x, cand, _, validu, _, rcap, sent16 = args

        def kern():
            return verlet._exact_prune(*args)

        def plain():
            return verlet.exact_prune_ref(*args)

        out = kern()
        real = cand != sent16
        pairs = int((validu.sum(1) * real.sum(1)).sum()) * 16
        ms = median_ms(torch, kern, 20)
        dev_ms = graph_ms(kern, 20)
        plain_ms = median_ms(torch, plain, 1, batches=3, warm=1)
        bound = bound_of(8 * pairs, nbytes_of(x, cand, validu, *out), torch.float32)
        print(f"prune kernel at {tag} ({cand.shape[0]} units x {cand.shape[1]} candidates, "
              f"{int(real.sum())} real, {pairs} pairs; rcap {rcap}, {int(out[1].sum())} "
              f"rows kept): the same bits as exact_prune_ref; median {ms:.4f} ms back to "
              f"back, {dev_ms:.4f} ms on the device (CUDA graph); plain {plain_ms:.4f} ms; "
              f"bound {bound[0]:.4f} ms ({bound[1]}; {8 * pairs} operations, "
              f"{bound[0] / dev_ms:.1%} of it on the device); {launches} launches in the "
              f"20-step run; on {smi}", flush=True)
        rows.append(kernel_row({**PRUNE_KERNEL, "name": f"verlet_prune ({tag})"},
                               launches, 0.0, ms, plain_ms, bound, device_ms=dev_ms))
        del sim, st, args, x, cand, validu, out
        torch.cuda.empty_cache()
    for line in kernel_ptxas_lines("verlet_prune_kernel"):
        print("  " + line)
    return rows


def ranges_diff(torch, args) -> tuple:
    """The candidate kernel (_range_candidates on the card, one launch)
    against range_candidates_ref on the same operands: n_dc, nk and their
    maxima always; cand, total and the candidate maximum where no unit has
    more ranges than kcap (past it the ranges kept among equal starts are
    free); the three overflow flags. Returns (the kernel's outputs, the
    names of what differs)."""
    from mdbench_tpu_torch.ops import verlet

    before = verlet.RANGES_LAUNCHES
    got = verlet._range_candidates(*args)
    torch.cuda.synchronize()
    want = verlet.range_candidates_ref(*args)
    cand, total, n_dc, nk, stats = got
    ucol, kcap, ccap = args[-3:]
    kovf = bool((want[3] > kcap).any())
    checks = {
        "launches": verlet.RANGES_LAUNCHES == before + 1,
        "dtypes": all(a.dtype == torch.int64 for a in got),
        "n_dc": torch.equal(n_dc, want[2]),
        "nk": torch.equal(nk, want[3]),
        "stats": stats[1:].tolist() == [int(want[2].max()), int(want[3].max()), 0],
        "flags": [int(stats[0]) > ccap, int(stats[1]) > ucol, int(stats[2]) > kcap]
        == [bool((want[1] > ccap).any()), bool((want[2] > ucol).any()), kovf],
    }
    if not kovf:
        checks["cand"] = torch.equal(cand, want[0])
        checks["total"] = (torch.equal(total, want[1])
                           and int(stats[0]) == int(want[1].max()))
    return got, [k for k, ok in checks.items() if not ok]


def ranges_same(torch, args, what: str) -> tuple:
    """ranges_diff, failing on a difference; returns the kernel's outputs."""
    got, diff = ranges_diff(torch, args)
    if diff:
        fail(f"the ranges kernel disagrees with range_candidates_ref on {what}: {diff}")
    return got


def launches_of(torch, fn) -> int:
    """Device work one call of fn queues (kernel launches, copies, sets:
    the runtime calls portbench counts), from one torch.profiler pass after
    a call outside it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    queue = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
             "cudaMemcpy", "cudaMemset")
    return sum(e.name.startswith(queue) for e in prof.events())


def run_ranges_phase(torch, dev, smi: str) -> list:
    """Phase 51: the verlet ranges build's candidate stage
    (csrc/verlet_ranges.cu). On ranges_edge_cases in both types (with
    ccap at the random case's largest union and one below it), then on
    the inputs of a rebuild from the final state of a 20-step SP run of
    the 131k and the 1M engine, the kernel must give range_candidates_ref's
    outputs (ranges_same), and at 131k the card's
    derive_rowlists_from_ranges the CPU's rows, counts, stats and flag on
    the same x. At the engines' inputs: the kernel alone (on the bins and
    tables) ms back to back and on the device (CUDA graph), the whole
    stage (bins, tables, kernel) and the plain chunk loop's ms, the
    launches of one derive_rowlists_from_ranges call, the kernel's
    launches in the run, and the bound by bytes (the unit rows of x and
    their bins, both start tables, the candidates and counts written).
    Returns the JSON rows."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine import Simulation
    from mdbench_tpu_torch.ops import verlet
    from mdbench_tpu_torch.ops.cells import coord_to_bin
    from mdbench_tpu_torch.probes import graph_ms

    phase(51)
    names = []
    for np_dtype in (np.float32, np.float64):
        cases = ranges_edge_cases(np_dtype)
        args = ranges_tensors(torch, cases["random"], dev)
        top = int(verlet.range_candidates_ref(*args)[1].max())
        cases.update({"total ccap": dict(cases["random"], ccap=top),
                      "total ccap + 1": dict(cases["random"], ccap=top - 1)})
        for name, case in cases.items():
            names.append(f"{name} ({np_dtype.__name__})")
            ranges_same(torch, ranges_tensors(torch, case, dev), names[-1])
    print(f"ranges kernel on the edge cases {names}: range_candidates_ref's bits "
          f"(cand and total where no unit passes kcap)", flush=True)
    rows = []
    for nx, tag in ((32, "131k"), (64, "1M")):
        verlet.RANGES_LAUNCHES = 0
        sim = Simulation(Params(nx=nx, ny=nx, nz=nx, ntimes=20, precision="sp"),
                         device=dev)
        st = sim.run(repeats=0).state
        launches = verlet.RANGES_LAUNCHES
        x = prune_operands(sim, st)[0]
        c, cut = sim.caps, sim.params.cutneigh
        args = (sim.grid, x, sim.nlocal, c.nlocal_pad, c.ghost, cut, sim.ucl, sim.ukr,
                sim.ccap)
        cand = ranges_same(torch, args, f"the {tag} engine's rebuild")[0]
        derive = (sim.grid, x, sim.nlocal, c.nlocal_pad, c.ghost, sim.rcap, cut)
        caps = dict(ucol=sim.ucl, kcap=sim.ukr, ccap=sim.ccap)
        if nx == 32:  # the CPU's exact prune at 1M would take minutes
            card = verlet.derive_rowlists_from_ranges(*derive, **caps)
            threads = torch.get_num_threads()
            torch.set_num_threads(os.cpu_count() or 1)
            try:
                cpu = verlet.derive_rowlists_from_ranges(sim.grid, x.cpu(), *derive[2:],
                                                         **caps)
            finally:
                torch.set_num_threads(threads)
            if not (all(torch.equal(a.cpu(), b) for a, b in zip(card[:3], cpu[:3]))
                    and bool(card[3]) == bool(cpu[3]) is False):
                fail("derive_rowlists_from_ranges on the card differs from the CPU")
        bins = coord_to_bin(sim.grid, x[: c.nlocal_pad + c.ghost])
        q = torch.arange(sim.grid.nbins + 1, device=dev)
        tabs = (torch.searchsorted(bins[: sim.nlocal], q),
                torch.searchsorted(bins[c.nlocal_pad :], q))
        bins = bins[: c.nlocal_pad]

        def kern():
            return verlet._ranges_kernel(sim.grid, x, bins, *tabs, sim.nlocal, c.nlocal_pad,
                                         cut, sim.ucl, sim.ukr, sim.ccap)

        def stage():
            return verlet._range_candidates(*args)

        def plain():
            return verlet.range_candidates_ref(*args)

        out = kern()
        ms = median_ms(torch, kern, 20)
        dev_ms = graph_ms(kern, 20)
        stage_ms = median_ms(torch, stage, 20)
        plain_ms = median_ms(torch, plain, 1, batches=3, warm=1)
        n_derive = launches_of(torch, lambda: verlet.derive_rowlists_from_ranges(
            *derive, **caps))
        bound = bound_of(0, nbytes_of(x[: c.nlocal_pad], bins, *tabs, *out[:2]),
                         torch.float32)
        print(f"ranges kernel at {tag} ({cand.shape[0]} units, ccap {sim.ccap}, ucol "
              f"{sim.ucl}, kcap {sim.ukr}; {int(out[1][0].sum())} candidates, maxima "
              f"{out[2].tolist()}): range_candidates_ref's bits; median {ms:.4f} ms "
              f"back to back, {dev_ms:.4f} ms on the device (CUDA graph); the stage "
              f"with its bins and tables {stage_ms:.4f} "
              f"ms; plain {plain_ms:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}, "
              f"{bound[0] / dev_ms:.1%} of it on the device); {n_derive} launches a "
              f"derive_rowlists_from_ranges call; {launches} kernel launches in the "
              f"20-step run; on {smi}", flush=True)
        rows.append(kernel_row({**RANGES_KERNEL, "name": f"verlet_ranges ({tag})"},
                               launches, 0.0, ms, plain_ms, bound, device_ms=dev_ms))
        del sim, st, x, cand, out, bins, tabs
        torch.cuda.empty_cache()
    for line in kernel_ptxas_lines("verlet_ranges_kernel"):
        print("  " + line)
    return rows


def verlet_row_rows(torch, lj, p, x, nl, nlocal_pad: int, rbuckets, counts: dict,
                    tag: str, smi: str) -> list:
    """exact_list_rows on 16-atom row lists (share 2; planes
    x[:, d].reshape(-1, 8))."""
    planes = [x[:, k].reshape(-1, 8).contiguous() for k in range(3)]
    return exact_list_rows(
        torch, lj, planes, dict(ijlist=nl.rows, nji=nl.numrows, bijlist=nl.brows,
                                bcrows=nl.bcrows, binv=nl.binv),
        nlocal_pad // 8, 2, p, rbuckets, counts, tag, smi)


def main() -> int:
    import torch

    t_start = time.perf_counter()

    phase(1)
    # 1. device
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi, flush=True)

    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import run_bench
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import GROUP, ClusterSimulation
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import eam_cluster as ec
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.probes import graph_ms
    from mdbench_tpu_torch.stats import compute_cluster_stats

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase(2)
    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}",
          flush=True)
    log = _build.library_path().with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())

    phase(3)
    # 3. kernel on random planes and lists
    for dtype in (torch.float32, torch.float64):
        for share in (1, 2, 4):
            xc, yc, zc, ijl, nji, npad = random_case(torch, share, share, dtype, dev)
            args = (npad, 2.5**2, 1.0, 1.0)
            got = lj.lj_cluster_force_ilist(xc, yc, zc, ijl, nji, *args, share=share)
            torch.cuda.synchronize()
            want = lj.lj_cluster_force_ilist_ref(xc, yc, zc, ijl, *args, share=share)
            err, rel = rel_err(torch, got, want)
            pad_rows = slice(8, 12)
            if any(bool((f[pad_rows] != 0).any()) for f in got):
                fail(f"padding units got a force ({dtype}, share {share})")
            print(f"kernel random {str(dtype)[6:]} share {share}: max abs err {err:.3e}, "
                  f"rel {rel:.3e} (tol {tol_of(torch, dtype):.0e})", flush=True)
            if not rel <= tol_of(torch, dtype):
                fail(f"kernel disagrees with its plain version ({dtype}, share {share})")
    check_sweep_edges(torch, dev, ("K1", "K1t"), None)

    phase(4)
    # 4. main path: the benchmark run; count the kernels' launches in it:
    # the set-up forces before the bucket plan launch K1, every force
    # after it K1b
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    sim, out, rate = run_bench(repeats=REPEATS, chain=CHAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, b_launches = lj.LAUNCHES, lj.BUCKET_LAUNCHES
    others = {name: getattr(lj, name) for name in LJ_COUNTS
              if name not in ("LAUNCHES", "BUCKET_LAUNCHES")}
    p = sim.params
    runs = 1 + REPEATS * CHAIN  # the un-timed checked run + the timed ones
    need = runs * (p.ntimes + 1)  # initial state's force + one per step
    print(f"main path: {sim.natoms} atoms, {p.ntimes} steps, {p.precision}, "
          f"n_clusters_pad {sim.n_clusters_pad}, icap {sim.icap}, "
          f"ghost_cap {sim.ghost_cap}, list_cap {sim.list_cap}, grows {sim.grows or 'none'}, "
          f"buckets {sim.buckets}")
    single_total = out.total_time
    print(f"main path: golden gate passed; TOTAL {out.total_time:.6f} s per run, "
          f"{rate:.6e} atom-updates/s, run() wall {wall:.2f} s")
    print(f"main path: K1 launches {launches} (set-up, before the plan), K1b "
          f"{b_launches} (>= {need} force evaluations of the checked and timed "
          f"runs); other LJ kernels {others}; EAM {dict(ec.LAUNCHES)}", flush=True)
    if sim.buckets is None:
        fail("the 131k run planned no capacity buckets")
    if launches < 1 or b_launches < need:
        fail(f"the main path launched K1 {launches} and K1b {b_launches} times: "
             f"K1 before the plan and K1b for its {need} force evaluations")
    if any(others.values()) or any(ec.LAUNCHES.values()):
        fail("the main path launched another force kernel")
    temps = out.temps
    if temps.shape != (p.ntimes,) or not np.isfinite(temps).all():
        fail("temperature trace is not finite or has the wrong shape")
    st = out.state
    for t in (st.vxc, st.fxc, st.clusters.xc[: sim.n_clusters_pad]):
        if not bool(torch.isfinite(t).all()):
            fail("the final state is not finite")
    print("main path temps:", " ".join(
        f"{s}:{temps[s - 1]:.6e}" for s in range(p.reneigh_every, p.ntimes + 1,
                                                    p.reneigh_every)))

    phase(5)
    # 5. small input: card against the CPU plain path, float64
    kw = dict(nx=6, ny=6, nz=6, ntimes=40, reneigh_every=10, resort_every=20,
              precision="dp", scheme="cluster")
    x, v, _ = create_fcc_lattice(Params(**kw))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    f_cpu = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu").first_force_atoms()
    f_gpu = ClusterSimulation(Params(**kw), x=x, v=v, device=dev).first_force_atoms()
    frel = np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max()
    r_cpu = ClusterSimulation(Params(**kw), device="cpu").run(repeats=0)
    r_gpu = ClusterSimulation(Params(**kw), device=dev).run(repeats=0)
    trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
    print(f"small input 6^3 dp: step-0 force rel err {frel:.3e} (tol 1e-10), "
          f"40-step temperature rel err {trel:.3e} (tol 1e-9)", flush=True)
    if not (frel <= 1e-10 and trel <= 1e-9):
        fail("the card's run disagrees with the CPU plain path")

    phase(6)
    # 6. kernel at the main path's shapes: the run's final planes and lists
    cl, pr = st.clusters, st.pairs
    npad = sim.n_clusters_pad
    cut = (p.cutforce**2, p.sigma6, p.epsilon)
    cs = compute_cluster_stats(cl, pr, npad, GROUP, p.cutforce**2, p.cutneigh**2)
    evaluated, inside = ilist_pairs(cs, sim.ishare), cs["pairs_within_cutforce"]
    print("K1 at 131k (phase 4's final flat lists): " + sweep_line(
        torch, lj, (cl.xc, cl.yc, cl.zc), pr.ijlist, pr.nji, sim.ishare,
        p.cutforce**2), flush=True)
    res = {}
    for dtype in (torch.float32, torch.float64):
        planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]

        def kern():
            return lj.lj_cluster_force_ilist(
                *planes, pr.ijlist, pr.nji, npad, *cut, share=sim.ishare)

        def plain():
            return lj.lj_cluster_force_ilist_ref(
                *planes, pr.ijlist, npad, *cut, share=sim.ishare)

        def kern_approx():
            return lj.lj_cluster_force_ilist(
                *planes, pr.ijlist, pr.nji, npad, *cut, share=sim.ishare,
                approx_rcp=True)

        out, want = kern(), plain()
        err, rel = rel_err(torch, out, want)
        err_a, rel_a = rel_err(torch, kern_approx(), want)
        ms = median_ms(torch, kern, 50)
        ms_approx = median_ms(torch, kern_approx, 50)
        dev_ms, dev_approx = graph_ms(kern, 50), graph_ms(kern_approx, 50)
        plain_ms = median_ms(torch, plain, 5)
        bound = bound_of(lj_ops(evaluated, inside),
                         nbytes_of(*planes, pr.ijlist, pr.nji, *out), dtype)
        # the main path's form (approx_rcp) for the JSON row, the exact time beside
        res[dtype] = (err_a, ms_approx, plain_ms, bound, ms, dev_approx)
        padded = npad * 8 * pr.ijlist.shape[1] * 16
        print(f"kernel at 131k ({str(dtype)[6:]}, {pr.ijlist.shape[0]} units x icap "
              f"{pr.ijlist.shape[1]}, share {sim.ishare}, {padded} padded pairs = "
              f"{padded / (ms * 1e-3):.4e} pairs/s, {evaluated} evaluated, {inside} "
              f"inside the cutoff): max abs err {err:.3e}, rel {rel:.3e} (tol "
              f"{tol_of(torch, dtype):.0e}); median kernel {ms:.4f} ms exact, "
              f"{ms_approx:.4f} ms with approx_rcp (approx / exact "
              f"{ms_approx / ms:.4f}, max abs err {err_a:.3e}, rel {rel_a:.3e}); on "
              f"the device (CUDA graph) {dev_ms:.4f} ms exact, {dev_approx:.4f} ms with "
              f"approx_rcp; plain {plain_ms:.4f} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]}) on {smi}", flush=True)
        if not rel_a <= tol_of(torch, dtype):
            fail(f"K1 with approx_rcp disagrees with its plain version at 131k ({dtype})")
        if not rel <= tol_of(torch, dtype):
            fail(f"kernel disagrees with its plain version at 131k ({dtype})")
    for line in kernel_ptxas_lines("lj_cluster_ilist_kernel"):
        print("  " + line)

    # 7-10. the cluster EAM path
    eam_rows, eam_main, eam_dp = run_eam_phases(torch, dev, smi, ec)

    # 11-15. the group-window path
    stream_row = run_group_phases(torch, dev, smi, ec,
                                  {dt: r[4] for dt, r in res.items()})

    # 16-19. the typed path from an atom file
    typed_rows = run_typed_phases(torch, dev, smi, ec)

    # 20-23. capacity buckets on the exact-list path
    bucket_rows = run_bucket_phases(torch, dev, smi, ec, (sim, st, b_launches),
                                    eam_main)

    # 24. the approximate reciprocal in K1, K1t and K1b
    run_approx_phase(torch, dev)

    # 25. the bf16 probe (T2); 26. the row-fetch probe (T1)
    bf16_row = run_bf16_phase(torch, dev, smi, ec, (sim, st, b_launches))
    fetch_rows = run_fetch_phase(torch, dev, smi)

    # 27-29. the verlet scheme's LJ path
    verlet_rows, verlet_totals = run_verlet_phases(torch, dev, smi, ec)

    # 30-32. the verlet scheme's EAM path and the verlet stub
    eam_verlet_dp, verlet_eam_rows = run_verlet_eam_phases(torch, dev, smi, ec, eam_dp)

    # 33. the command line, as subprocesses
    run_cli_phase(torch, smi)

    # 34-36. the slab engine on an in-process mesh
    domain_rows, slab_totals = run_domain_phases(torch, dev, smi, ec, verlet_totals,
                                                 eam_verlet_dp)

    # 37-41. the cluster slab engine on an in-process mesh
    cluster_domain_rows = run_cluster_domain_phases(torch, dev, smi, ec, single_total,
                                                    eam_dp)

    # 42-45. the pencil and brick engines on in-process meshes
    mesh_rows = run_mesh_domain_phases(torch, dev, smi, ec, verlet_totals, slab_totals,
                                       eam_verlet_dp)

    # 46-48. the scale runs: 1M on both schemes, 1M verlet EAM, 10.1M on
    # the single engine and on 8 slabs
    scale_rows = run_scale_phases(torch, dev, smi, ec)

    # 49. the bf16 derive: lists, A/B, the 131k run, K1b on its lists, EAM
    derive_rows = run_bf16_derive_phase(torch, dev, smi, ec, (sim, st, b_launches),
                                        (single_total, temps), eam_dp)

    # 50. the verlet row lists' exact prune: edge cases, 131k and 1M
    prune_rows = run_prune_phase(torch, dev, smi)

    # 51. the ranges build's candidate stage: edge cases, 131k and 1M
    ranges_rows = run_ranges_phase(torch, dev, smi)
    phase(None)

    wall = time.perf_counter() - t_start
    print(f"chip_smoke wall {wall:.1f} s (limit 1200 s)", flush=True)
    print(json.dumps({"kernels": [
        kernel_row(KERNEL, launches, *res[torch.float32][:4],
                   exact_ms=res[torch.float32][4], device_ms=res[torch.float32][5]),
        *eam_rows, stream_row,
        *typed_rows, *bucket_rows, bf16_row, *fetch_rows, *verlet_rows, *verlet_eam_rows,
        *domain_rows, *cluster_domain_rows, *mesh_rows, *scale_rows, *derive_rows,
        *prune_rows, *ranges_rows,
    ]}))
    print(f"chip_smoke wall {wall:.1f} s", file=sys.stderr)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
