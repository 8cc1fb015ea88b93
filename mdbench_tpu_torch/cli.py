"""The command line of the port (the port of ``mdbench_tpu.cli``),
flag- and output-compatible with the reference (src/verletlist/main.c:
129-344): the same flags and parameter files, parameter banner, thermo
rows, and final System/TOTAL/Performance block, so MD-Bench result
parsers read it unchanged.

The port adds one flag, `--device cuda|cpu` (default cuda; no fallback:
without a card a cuda run raises), and one output line naming the device
and the force path the run launched. It prints no warning for DP runs:
the card runs float64 kernels.

Usage:  python -m mdbench_tpu_torch.cli [-p file] [-f lj|eam] [-n 200] ...
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from mdbench_tpu_torch.config import Params, print_parameters, read_parameter_file, str2ff
from mdbench_tpu_torch.stats import Stats, display_statistics

HLINE = "----------------------------------------------------------------------------\n"

HELP = """MD Bench (PyTorch/CUDA): A performance-oriented prototyping harness for MD algorithms
-p / --params <string>:     file to read parameters from (can be specified more than once)
-f <string>:                force field (lj or eam), default lj
-i <string>:                input file with atom positions (dump)
-e <string>:                input file for EAM
-n / --nsteps <int>:        set number of timesteps for simulation
-nx/-ny/-nz <int>:          set linear dimension of systembox in x/y/z direction
-half <int>:                use half (1) or full (0) neighbor lists
-r / --radius <real>:       set cutoff radius
-s / --skin <real>:         set skin (verlet buffer)
-w <file>:                  write input atoms to file
--freq <real>:              processor frequency (GHz)
--vtk <string>:             VTK file for visualization
--xtc <string>:             XTC trajectory output file
--scheme <verlet|cluster>:  neighbor scheme (reference OPT_SCHEME)
--precision <sp|dp>:        floating point precision (reference DATA_TYPE)
--kernel <auto|ilist|ilist_pl|xla|pallas|rowlist>: force path
                            (cluster: auto/ilist_pl = exact-list kernels,
                            pallas = group-window kernel, ilist/xla =
                            their plain torch versions; verlet:
                            auto/rowlist = 16-atom row lists and the
                            exact-list kernels, xla = planar torch)
--eam-eval <auto|spline|poly>: EAM per-pair evaluation (spline =
                            reference-exact gathered splines; poly =
                            fitted polynomials; auto = poly in SP on
                            the card)
--trace-index <prefix>:     dump INDEX_TRACER-style neighbor-index trace
                            at every reneighbor (reference tracing.h:47-123)
--timers <est|diff>:        FORCE/NEIGH timing: out-of-band estimates
                            (default) or in-loop differential runs
--trace-mem <prefix>:       dump MEM_TRACER-style address-stream trace
                            (reference tracing.h:24-45)
--profile <logdir>:         torch.profiler trace of the run (Chrome
                            trace in logdir; force/reneighbor spans)
--checkpoint <file>:        save the final state (positions+velocities+
                            types+step) as a binary npz checkpoint
--restore <file>:           resume from a checkpoint written by
                            --checkpoint (runs -n further steps)
--device <cuda|cpu>:        torch device (default cuda; cpu runs the
                            plain torch versions of the kernels)
"""


def split_device(argv):
    """(device, argv without `--device X`); the device defaults to cuda."""
    argv = list(argv)
    device = "cuda"
    while "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device needs cuda or cpu")
        device = argv[i + 1]
        del argv[i : i + 2]
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {device!r}")
    return device, argv


def parse_args(argv) -> Params:
    """Flag-compatible argument loop (reference: main.c:145-231); the
    same Params as mdbench_tpu's parse_args for the same flags."""
    p = Params()
    i = 0
    while i < len(argv):
        a = argv[i]

        def nxt():
            nonlocal i
            i += 1
            return argv[i]

        if a in ("-p", "--params"):
            read_parameter_file(p, nxt())
        elif a == "-f":
            ff = str2ff(nxt())
            if ff < 0:
                sys.stderr.write("Invalid force field!\n")
                sys.exit(-1)
            p.force_field = ff
        elif a == "-i":
            p.input_file = nxt()
        elif a == "-e":
            p.eam_file = nxt()
        elif a in ("-n", "--nsteps"):
            p.ntimes = int(nxt())
        elif a == "-nx":
            p.nx = int(nxt())
        elif a == "-ny":
            p.ny = int(nxt())
        elif a == "-nz":
            p.nz = int(nxt())
        elif a == "-half":
            p.half_neigh = int(nxt())
        elif a in ("-r", "--radius"):
            p.cutforce = float(nxt())
        elif a in ("-s", "--skin"):
            p.skin = float(nxt())
        elif a == "--freq":
            p.proc_freq = float(nxt())
        elif a == "--vtk":
            p.vtk_file = nxt()
        elif a == "--xtc":
            p.xtc_file = nxt()
        elif a == "-w":
            p.write_atom_file = nxt()
        elif a == "--scheme":
            p.scheme = nxt()
        elif a == "--precision":
            p.precision = nxt()
        elif a == "--kernel":
            p.kernel = nxt()
        elif a == "--eam-eval":
            p.eam_eval = nxt()
        elif a == "--trace-index":
            p.trace_index = nxt()
        elif a == "--trace-mem":
            p.trace_mem = nxt()
        elif a == "--profile":
            p.profile_dir = nxt()
        elif a == "--timers":
            p.timers = nxt()
        elif a == "--checkpoint":
            p.checkpoint_file = nxt()
        elif a == "--restore":
            p.restore_file = nxt()
        elif a in ("-h", "--help"):
            print(HELP)
            sys.exit(0)
        elif a.startswith("-"):
            # the reference mains skip unknown argv entries; warn, since a
            # typo such as "--prec sp" would silently run the DP default
            sys.stderr.write("WARNING: ignoring unknown flag %r\n" % a)
        i += 1
    p.finalize()
    return p


def force_path(sim) -> str:
    """The force the run launched: the kernel (with approx_rcp where the
    run takes it; "K5/K6 (EAM poly|spline)" for the verlet EAM passes) on
    the card, "torch ops (...)" for a path without a hand kernel, "plain
    torch" for every path on the CPU."""
    p = sim.params
    if sim.device.type != "cuda":
        return "plain torch"
    approx = " (approx_rcp)" if p.precision == "sp" and p.approx_rcp else ""
    if hasattr(sim, "n_clusters_pad"):  # the cluster engine
        if sim.eam_poly is not None:
            return "K2b/K3b" if sim.buckets is not None else "K2/K3"
        if p.half_neigh:
            return "torch ops (half lists)"
        typed = sim.tables is not None
        if sim._kmode == "ilist_pl":
            if typed:
                return "K1t" + approx
            return ("K1b" if sim.buckets is not None else "K1") + approx
        if sim._kmode == "pallas":
            return "K4t" if typed else "K4"
        return "plain torch"
    if sim.eam_tables is not None:
        return "K5/K6 (EAM %s)" % ("poly" if sim.eam_poly is not None else "spline")
    if sim._rowlist:
        return ("K1b" if sim.rbuckets is not None else "K1") + approx
    return "torch ops (%s lists)" % ("half" if p.half_neigh else "planar")


def _local_lists(sim, state):
    """(neighbors, numneigh) of the local atoms as numpy, for the tracers:
    the cluster scheme's group j16 lists (entries up to nj), or the verlet
    per-atom lists (built from the state on the row-list path)."""
    if hasattr(state, "clusters"):
        jl = state.pairs.jlist
        nn = torch.clamp(state.pairs.nj, max=jl.shape[1])
        return jl.cpu().numpy(), nn.cpu().numpy()
    nl = state.nlist
    if nl.neighbors.shape[0] < sim.nlocal:  # the row-list path
        nl = sim.per_atom_lists(state.x, state.types)
    return (nl.neighbors[: sim.nlocal].cpu().numpy(),
            nl.numneigh[: sim.nlocal].cpu().numpy())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device, argv = split_device(argv)
    params = parse_args(argv)

    if params.scheme == "cluster":
        from mdbench_tpu_torch.engine_cluster import ClusterSimulation as Engine
    else:
        from mdbench_tpu_torch.engine import Simulation as Engine

    step0 = 0
    if params.restore_file:
        # resume from a binary checkpoint: restored states are never
        # thermo-adjusted
        from mdbench_tpu_torch.io.checkpoint import load_checkpoint

        rx, rv, rtypes, meta = load_checkpoint(params.restore_file)
        step0 = int(meta.get("step", 0))
        sim = Engine(params, x=rx, v=rv, types=rtypes, adjust=False, device=device)
        print("restored %d atoms at step %d from %s"
              % (sim.natoms, step0, params.restore_file))
    else:
        sim = Engine(params, device=device)
    print(print_parameters(params))
    sys.stdout.write(HLINE)
    print("step\ttemp\t\tpressure")

    state0 = sim.initial_state()
    if params.scheme == "cluster":
        t0v, p0v = sim._thermo(state0.vxc, state0.vyc, state0.vzc)
    else:
        t0v, p0v = sim._thermo(state0.v)
    print("%i\t%e\t%e" % (0, float(t0v), float(p0v)))

    if params.write_atom_file:
        from mdbench_tpu_torch.io.writers import write_atom

        write_atom(params.write_atom_file, sim, state0)

    tracing_on = bool(params.trace_index or params.trace_mem)

    def dump_traces(state, step: int):
        """traceAddresses analogue (reference main.c:240-242 at step 0,
        main.c:269 at every reneighbor, tracing.h:20-22)."""
        from mdbench_tpu_torch import tracing

        nb, nn = _local_lists(sim, state)
        if params.trace_index:
            print("tracing index stream ->",
                  tracing.dump_index_trace(params.trace_index, nb, nn, step))
        if params.trace_mem:
            fs = 8 if params.precision == "dp" else 4
            print("tracing address stream ->",
                  tracing.dump_mem_trace(params.trace_mem, nb, nn, step,
                                         float_size=fs))

    if tracing_on:
        dump_traces(state0, 0)

    if params.vtk_file or params.xtc_file:
        # trajectory output at the x_out_every cadence (reference
        # main.c:282-284, both schemes)
        from mdbench_tpu_torch.io.trr import xtc_end, xtc_init
        from mdbench_tpu_torch.io.vtk import (
            write_atoms_to_vtk_file,
            write_cluster_vtk_files,
        )
        from mdbench_tpu_torch.io.writers import local_atoms

        writer = None
        if params.xtc_file:
            writer = xtc_init(params.xtc_file, (params.xprd, params.yprd, params.zprd))

        def emit(state, step):
            if params.vtk_file:
                if params.scheme == "cluster":
                    write_cluster_vtk_files(params.vtk_file, state.clusters,
                                            sim.n_clusters_pad,
                                            int(state.halo.nghost), step)
                else:
                    write_atoms_to_vtk_file(params.vtk_file,
                                            local_atoms(sim, state)[0], step)
            if writer is not None:
                writer.write(local_atoms(sim, state)[0], step, step * params.dt)

        chunk = params.x_out_every
        nchunks = params.ntimes // chunk
        out = sim.run_chunked(chunk, nchunks, emit, tail=params.ntimes - nchunks * chunk)
        if writer is not None:
            xtc_end(writer)
    elif tracing_on:
        # dump the fresh lists at every reneighbor (TRACER_CONDITION)
        def emit_traces(state, step):
            if step > 0:
                dump_traces(state, step)

        chunk = params.reneigh_every
        nchunks = params.ntimes // chunk
        out = sim.run_chunked(chunk, nchunks, emit_traces,
                              tail=params.ntimes - nchunks * chunk)
    elif params.profile_dir:
        from mdbench_tpu_torch.tracing import profile

        with profile(params.profile_dir):
            out = sim.run()
        print("profile trace ->", params.profile_dir)
    else:
        out = sim.run()

    # thermo rows at the nstat cadence (reference main.c:275-280, 289)
    for n in range(params.nstat, params.ntimes, params.nstat):
        print("%i\t%e\t%e" % (n, out.temps[n - 1], out.press[n - 1]))
    print("%i\t%e\t%e" % (params.ntimes, out.temps[-1], out.press[-1]))

    # the cluster halo counts 16-atom j-cluster images
    nghost = int(out.state.halo.nghost) * (16 if params.scheme == "cluster" else 1)
    if params.timers == "diff":
        # in-loop differential timing: FORCE = (T(run with one more chained
        # force a plain step) - T(run)) per plain step; NEIGH = (T(run at
        # half the reneighbor interval) - T(run)) per extra rebuild
        sim2 = Engine(params, device=device)
        sim2._force_reps = 2
        out2 = sim2.run()
        n_plain = params.ntimes - params.ntimes // params.reneigh_every
        t_force = max(out2.total_time - out.total_time, 0.0) / max(n_plain, 1)
        p3 = dataclasses.replace(params, reneigh_every=max(params.reneigh_every // 2, 1))
        extra = (params.ntimes // p3.reneigh_every
                 - params.ntimes // params.reneigh_every)
        out3 = Engine(p3, device=device).run()
        t_neigh = max(out3.total_time - out.total_time, 0.0) / max(extra, 1)
    else:
        t_force, t_neigh = sim.measure_phases(out.state)
    force_total = t_force * (params.ntimes + 1)
    neigh_total = t_neigh * (params.ntimes // params.reneigh_every)

    print("Device: %s, force: %s" % (
        torch.cuda.get_device_name() if device == "cuda" else "cpu", force_path(sim)))
    sys.stdout.write(HLINE)
    print("System: %d atoms %d ghost atoms, Steps: %d"
          % (sim.natoms, nghost, params.ntimes))
    print("TOTAL %.2fs FORCE %.2fs NEIGH %.2fs REST %.2fs"
          % (out.total_time, force_total, neigh_total,
             max(out.total_time - force_total - neigh_total, 0.0)))
    # which timing mode produced the FORCE/NEIGH split (TOTAL is measured
    # in both): the run is one loop without phase timers, so the default
    # split is out-of-band estimates
    print("(timers: diff — in-loop differential measurement)"
          if params.timers == "diff"
          else "(timers: est — FORCE/NEIGH are out-of-band per-call "
          "estimates x call counts; TOTAL is measured)")
    est = force_total + neigh_total
    if est > out.total_time * 1.15:
        print("(note: FORCE+NEIGH estimates exceed TOTAL by %.0f%% — the "
              "run overlaps phases the estimates time separately)"
              % (100.0 * (est / out.total_time - 1.0)))
    sys.stdout.write(HLINE)
    print("Performance: %.2f million atom updates per second"
          % (1e-6 * sim.natoms * params.ntimes / out.total_time))

    if params.compute_stats:
        stats = Stats()
        if params.scheme == "cluster":
            # exact cluster counters (reference clusterpair/stats.c:26-85)
            from mdbench_tpu_torch.stats import compute_cluster_stats

            cs = compute_cluster_stats(
                out.state.clusters, out.state.pairs, sim.n_clusters_pad, 16,
                params.cutforce**2, params.cutneigh**2, buckets=sim.buckets)
            stats.num_neighs = cs["clusters_processed"]
            stats.total_force_neighs = cs["pairs_within_cutforce"] * (params.ntimes + 1)
            stats.total_force_iters = cs["tiles"] * (params.ntimes + 1)
            print("\tCluster pairs processed: %d (within force cutoff: %d)"
                  % (cs["clusters_processed"], cs["clusters_within_cutoff"]))
            print("\tPadded pair lanes: %d, real pairs in cutoff: %d "
                  "(efficiency %.1f%%)"
                  % (cs["padded_pairs"], cs["pairs_within_cutforce"],
                     100.0 * cs["pairs_within_cutforce"] / max(cs["padded_pairs"], 1)))
        else:
            stats.accumulate_list(_local_lists(sim, out.state)[1], params.ntimes + 1)
        float_size = 8 if params.precision == "dp" else 4
        print(display_statistics(stats, sim.nlocal, params.ntimes, force_total,
                                 params.proc_freq, float_size))

    if params.checkpoint_file:
        from mdbench_tpu_torch.io.checkpoint import save_checkpoint

        save_checkpoint(params.checkpoint_file, sim, out.state, step0 + params.ntimes)
        print("checkpoint ->", params.checkpoint_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
