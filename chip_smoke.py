#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mdbench_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no result line) on failure:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile mdbench_tpu_torch/csrc/*.cu with nvcc for sm_90a;
  3. kernel: the exact-list LJ kernel against its plain torch version on
     random planes and lists holding sentinel ids and all-padding units,
     float32 (<= 1e-5 of max |f|) and float64 (<= 1e-12), share 1, 2, 4;
  4. main path: the benchmark run of `python -m mdbench_tpu_torch.bench`
     (131,072 atoms, 200 SP steps, cluster scheme), gated on the C
     reference's temperature trace; it must plan capacity buckets, the
     set-up forces before the plan launch the flat kernel (K1) and the
     bucketed form (K1b) must cover every force evaluation of the checked
     and timed runs; no other kernel launches;
  5. small input: a jittered 8^3 box in float64, step-0 forces and a
     40-step temperature trace with both rebuild kinds, card against the
     CPU plain path;
  6. kernel at the main path's shapes: the run's final 131k planes and
     lists, kernel against plain version, exact and with the approximate
     reciprocal that the main path takes (each within 1e-5 / 1e-12 of max
     |f|; median times);
  7. EAM kernels: the two EAM passes (density, force) against their plain
     torch versions on the same random lists plus a random fp plane,
     float32 (<= 1e-5 of max |value|) and float64 (<= 1e-12), share 1,
     2, 4; all-padding units get exactly zero density and force;
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
     lists and fp plane (error, median times);
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
 13. group-window small input: a jittered 8^3 box in float64, card
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
     lane-pairs; its -Xptxas -v lines);
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
     jittered 8^3 DP box with two types, card against the CPU plain path
     for "auto", "pallas" and half_neigh=1;
 19. K1t and K4t at the main path's shapes: phase 18's final SP states
     with their tables and phase 17's with the default ones (error
     against plain, against the untyped kernel with uniform tables;
     median times beside the untyped kernel's on the same lists); K1t
     also with the approximate reciprocal, as phase 17 runs it, against
     plain and timed on both states; K4t also on the device alone, its
     ratio to K1t exact, its work counts (culled against the tables'
     largest cutsq) and -Xptxas -v lines; phases 12, 17 and 18 launch no
     K1b;
 20. bucketed kernels: K1b, K2b and K3b against their plain bucketed
     twins on the random cases of phases 3 and 7 with hand-set plans (a
     zero tier, dummy units, and once a bucket whose cap is below its
     longest list), float32 (<= 1e-5) and float64 (<= 1e-12), share 1, 2,
     4; on untruncated plans equal to K1, K2 and K3 bit for bit;
 21. flat against bucketed: the 131k/200 SP run alternately without
     buckets (a subclass whose _plan_buckets returns False) and with them,
     F B B F F B B F, each golden-gated, AB_REPEATS timed regions of one
     run each (not the bench's 3 x 3, to keep the script short); median
     TOTALs; then a jittered 8^3 DP box with a hand-set plan, card against
     the CPU plain path (step-0 forces <= 1e-10, 40-step temperatures <=
     1e-9, both rebuild kinds), without and with the prune every 3 steps;
 22. K1b, K2b and K3b at the main paths' shapes: phases 4's and 8's final
     states beside K1, K2 and K3 on the same lists (bit-equal), error
     against the plain twins (K1b also with approx_rcp, as the main path
     runs it), median times, bound, and the j16 slots the blocks' tile
     loops run in unit order and in nji order;
 23. measure_phases on phase 4's final state (FORCE and NEIGH ms), and
     run_chunked(10, 4) at 131k with a rebuild every 10 steps, whose
     temperatures must equal run(ntimes=40)'s within rel 1e-6;
 24. the approximate reciprocal (Params.approx_rcp, which the main path
     takes): K1, K1t and K1b with approx_rcp on the random cases of phases
     3, 16 and 20, float32 within 1e-5 of max |f| of their plain twins
     (which divide), K1b equal to K1 bit for bit on untruncated plans when
     both take it; float64 bit-equal with the flag and without it;
 25. the bf16 probe (T2, probes/bf16.py): the bf16 kernel against its
     plain twin on phase 3's random cases (share 1, 2, 4) and on phase 4's
     final 131k flat lists, within BF16_TOL of max |f|; the probe's force
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

Every kernel count is set to 0 just before each main path (phases 4, 8,
12, both runs of 17, and the probes' runs in 25 and 26) and read just
after it. Then it prints a JSON line of the kernels, nvidia-smi's line,
and {"ok": true, "device": {...}} as the last line; the script's wall
time goes to standard error.

A kernel's bound (bound_ms) is the least time the card could take for
the work the main path's inputs need: the larger of its operations over
the card's peak (67 TFLOP/s float32, 34 TFLOP/s float64, non-tensor, H100
SXM data sheet) and its bytes over 3.35 TB/s, each input read once and
each output written once. An LJ pair costs 8 operations for the distance
test and 15 more inside the cutoff (the divide counted as one); an EAM
pair 8, and inside the cutoff 6 + 2d (density) or 10 + 4d (force) for
Horner polynomials of degree d. The pairs are the kernel's work on these
lists (stats.compute_cluster_stats): the exact-list kernels' listed
pairs, and for the group-window kernels the window pairs that their
contract asks for, whatever they cull (the pairs the kernel evaluates
are printed beside). The bf16 kernel evaluates
every listed pair without a branch: per pair 9 float32 operations
(subtracts, cutoff test, reciprocal, sums) and 16 bfloat16 ones, the latter
over 134 TFLOP/s (two per packed bf16x2 instruction at the float32 rate).
A row fetch moves bytes only. No single PyTorch call computes a force
kernel's function, so their library_ms is null; a row fetch's is
index_select's, which is also its plain version. The rows of K1, K1t and
K1b give the error and time of the form the main path launches, with the
approximate reciprocal (Params.approx_rcp), and the exact form's time as
exact_ms.
"""

from __future__ import annotations

import json
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
REPEATS, CHAIN = 3, 3  # as python -m mdbench_tpu_torch.bench
AB_REPEATS = 3  # phase 21: timed regions per run, each of one chained run
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
               exact_ms=None) -> dict:
    """A kernel's entry of the JSON line. The exact-list kernels that the
    main path runs with approx_rcp give that form's error and time, and
    their exact form's time as `exact_ms`."""
    row = {**meta, "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
           "library_ms": library_ms}
    if exact_ms is not None:
        row["exact_ms"] = exact_ms
    return row


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


def stream_ptxas_lines(typed: bool) -> list:
    """The -Xptxas -v lines (registers, shared memory, spills) of the
    group-window kernel's typed or untyped instantiations, from the
    build's log, each tagged with its own."""
    import re

    from mdbench_tpu_torch import _build

    log = _build.library_path().with_suffix(".log")
    out, tag = [], None
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry" in line:
            m = re.search(r"lj_cluster_stream_kernelI([fd])Lb([01])E", line)
            tag = m and m[2] == str(int(typed)) and (
                ("f32" if m[1] == "f" else "f64") + (" typed" if typed else " untyped"))
        elif tag and ("Used" in line or "spill" in line):
            out.append(f"lj_cluster_stream_kernel {tag}: {line.strip()}")
    return out


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
    for name in LJ_COUNTS:
        setattr(lj, name, 0)
    for name in ec.LAUNCHES:
        ec.LAUNCHES[name] = 0


def run_eam_phases(torch, dev, smi: str, ec) -> list:
    """Phases 7-10 (the cluster EAM path). Returns the kernels' JSON rows."""
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

    # 8. EAM main path at full width; count the kernels' launches in it:
    # K2 and K3 for the set-up forces before the bucket plan, K2b and K3b
    # for every force after it
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    sim, out, rate = run_bench_eam(eam_file, "sp", repeats=REPEATS, chain=CHAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ec.LAUNCHES)
    p = sim.params
    need = (1 + REPEATS * CHAIN) * (p.ntimes + 1)
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
    _, out_dp, _ = run_bench_eam(eam_file, "dp", repeats=1, chain=1)
    for step, tol in EAM_SP_TOL.items():
        t_sp, t_dp = float(temps[step - 1]), float(out_dp.temps[step - 1])
        rel = abs(t_sp - t_dp) / abs(t_dp)
        print(f"EAM step {step}: T sp {t_sp:.6e}, dp {t_dp:.6e}, rel {rel:.3e} "
              f"(tol {tol:.0e})", flush=True)
        if not rel <= tol:
            fail(f"EAM SP run departs from the DP run at step {step}")

    # 9. EAM small input: card against the CPU plain path, float64
    kw = dict(nx=6, ny=6, nz=6, ntimes=40, reneigh_every=10, resort_every=20,
              precision="dp", scheme="cluster", force_field=FF_EAM,
              eam_file=eam_file)
    x, v, _ = create_fcc_lattice(apply_eam_overrides(Params(**kw), tables))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    f_cpu = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu").first_force_atoms()
    f_gpu = ClusterSimulation(Params(**kw), x=x, v=v, device=dev).first_force_atoms()
    frel = np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max()
    r_cpu = ClusterSimulation(Params(**kw), device="cpu").run()
    r_gpu = ClusterSimulation(Params(**kw), device=dev).run()
    trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
    print(f"EAM small input 6^3 dp: step-0 force rel err {frel:.3e} (tol 1e-10), "
          f"40-step temperature rel err {trel:.3e} (tol 1e-9)", flush=True)
    if not (frel <= 1e-10 and trel <= 1e-9):
        fail("the card's EAM run disagrees with the CPU plain path")

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
          f"cutoff; Horner degrees {deg}", flush=True)
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
            ms = median_ms(torch, kern, 50)
            plain_ms = median_ms(torch, plain, 5)
            moved = nbytes_of(*planes, pr.ijlist, pr.nji, *out) + (
                nbytes_of(fp) if name == "eam_force_ilist" else 0)
            bound = bound_of(ops[name], moved, dtype)
            print(f"{name} at 131k ({str(dtype)[6:]}, {pr.ijlist.shape[0]} units x "
                  f"icap {pr.ijlist.shape[1]}, share {share}): max abs err {err:.3e}, "
                  f"rel {rel:.3e} (tol {tol_of(torch, dtype):.0e}); median kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]}) on {smi}", flush=True)
            if dtype == torch.float32:
                rows[name] = kernel_row(EAM_KERNELS[name], launches[name], err, ms,
                                        plain_ms, bound)
    return [rows[name] for name in EAM_KERNELS], (sim, st, launches)


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

    # 12. the group-window main path; count the kernels' launches in it
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    sim, out, rate = run_bench(repeats=REPEATS, chain=CHAIN, kernel="pallas")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lj.STREAM_LAUNCHES
    others = {name: getattr(lj, name) for name in LJ_COUNTS if name != "STREAM_LAUNCHES"}
    p = sim.params
    need = (1 + REPEATS * CHAIN) * (p.ntimes + 1)
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

    # 13. small input: card against the CPU plain path, float64
    base = dict(nx=8, ny=8, nz=8, ntimes=40, reneigh_every=10, resort_every=20,
                precision="dp", scheme="cluster")
    x, v, _ = create_fcc_lattice(Params(**base))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    for extra in ({"kernel": "pallas"}, {"kernel": "pallas", "prune_every": 3},
                  {"half_neigh": 1}):
        kw = {**base, **extra}
        f_cpu = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu").first_force_atoms()
        f_gpu = ClusterSimulation(Params(**kw), x=x, v=v, device=dev).first_force_atoms()
        frel = np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max()
        r_cpu = ClusterSimulation(Params(**kw), device="cpu").run()
        r_gpu = ClusterSimulation(Params(**kw), device=dev).run()
        trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
        print(f"group small input 8^3 dp {extra}: step-0 force rel err {frel:.3e} "
              f"(tol 1e-10), 40-step temperature rel err {trel:.3e} (tol 1e-9)",
              flush=True)
        if not (frel <= 1e-10 and trel <= 1e-9):
            fail(f"the card's run {extra} disagrees with the CPU plain path")

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
    for line in stream_ptxas_lines(typed=False):
        print("  " + line)

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

        # 18. non-uniform tables: SP against DP on both paths
        states18 = {}
        b_before = lj.BUCKET_LAUNCHES
        for kernel in ("auto", "pallas"):
            sim_sp, out_sp, rate_sp = run_bench_file(
                path, "sp", kernel, NONUNIFORM_TABLES, repeats=1, chain=1)
            _, out_dp, _ = run_bench_file(path, "dp", kernel, NONUNIFORM_TABLES,
                                          repeats=1, chain=1)
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

    base = dict(nx=8, ny=8, nz=8, ntimes=40, reneigh_every=10, resort_every=20,
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
        r_cpu, r_gpu = (sim_on(d).run() for d in ("cpu", dev))
        trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
        print(f"typed small input 8^3 dp {extra}: step-0 force rel err {frel:.3e} "
              f"(tol 1e-10), 40-step temperature rel err {trel:.3e} (tol 1e-9)",
              flush=True)
        if not (frel <= 1e-10 and trel <= 1e-9):
            fail(f"the card's typed run {extra} disagrees with the CPU plain path")

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
                res[dtype] = (err_a, ms_a, plain_ms, bound, ms)
                approx = (f"; with approx_rcp max abs err {err_a:.3e}, rel {rel_a:.3e}, "
                          f"median {ms_a:.4f} ms")
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
                               exact_ms=row[4] if len(row) > 4 else None))
    for line in stream_ptxas_lines(typed=True):
        print("  " + line)
    return rows


def slot_sums(torch, pairs, share: int, icap: int, buckets, per: int = 0) -> tuple:
    """(flat, sorted, listed) j16 slots of the exact-list kernels on these
    lists: a block holds upb = 16 / share units and its tile loop runs to
    its longest list, so it costs upb * max(n) slots; flat, a unit's n is
    min(nji, icap) in unit order; sorted (K1b), min(nji, its bucket's cap)
    in nji order, 0 for dummy units. listed is the sum of the flat n.
    With `per`, groups of `per` units take the place of blocks (per = 32 /
    (8 * share): the units of one warp, which is what idles when its own
    units' lists are done)."""
    from mdbench_tpu_torch.ops.lj_cluster import bucket_table

    upb = per or 128 // (8 * share)
    nji = pairs.nji.long()
    nu = nji.shape[0]
    n_flat = nji.clamp(max=icap)
    units = pairs.bcrows.long()[::share] // share
    ends, caps = (torch.as_tensor(a, dtype=torch.int64, device=nji.device)
                  for a in bucket_table(buckets))
    pos = torch.arange(units.shape[0], device=nji.device)
    cap = caps[torch.searchsorted(ends, pos, right=True)].clamp(max=icap)
    n_sorted = torch.where(units < nu, torch.minimum(nji[units.clamp(max=nu - 1)], cap), 0)

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
    from mdbench_tpu_torch.stats import compute_cluster_stats

    # 20. the bucketed kernels on random cases
    run_bucket_kernel_phase(torch, dev, ec)

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

    base = dict(nx=8, ny=8, nz=8, ntimes=40, reneigh_every=10, resort_every=20,
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
        r_cpu, r_gpu = (sim_on(d).run() for d in ("cpu", dev))
        trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
        n = lj.BUCKET_LAUNCHES - before
        print(f"bucketed small input 8^3 dp {extra}, plan {plan}: step-0 force rel err "
              f"{frel:.3e} (tol 1e-10), 40-step temperature rel err {trel:.3e} (tol "
              f"1e-9), {n} K1b launches", flush=True)
        if not (frel <= 1e-10 and trel <= 1e-9) or n < 41:
            fail(f"the card's bucketed run {extra} disagrees with the CPU plain path")

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
    slots = slot_sums(torch, pr, share, pr.ijlist.shape[1], buckets)
    warps = slot_sums(torch, pr, share, pr.ijlist.shape[1], buckets, per=4 // share or 1)
    print(f"K1b at 131k: phase 4's final lists, buckets {buckets}; j16 slots by block "
          f"flat {slots[0]}, nji-sorted {slots[1]} (sorted / flat "
          f"{slots[1] / slots[0]:.4f}), by warp flat {warps[0]}, nji-sorted {warps[1]} "
          f"({warps[1] / warps[0]:.4f}), listed {slots[2]}; bucketed padded pairs "
          f"{cs['padded_pairs']}", flush=True)
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
        plain_ms = median_ms(torch, plain, 5)
        bound = bound_of(lj_ops(evaluated, inside),
                         nbytes_of(*planes, *maps[:2], pr.nji, *out), dtype)
        # the main path's form (approx_rcp) for the JSON row, the exact time beside
        res[dtype] = (err_a, ms_approx, plain_ms, bound, ms)
        print(f"K1b at 131k ({str(dtype)[6:]}): max abs err {err:.3e}, rel {rel:.3e} "
              f"(tol {tol_of(torch, dtype):.0e}); equal to K1: {same}; with "
              f"approx_rcp (the main path's form) max abs err {err_a:.3e}, rel "
              f"{rel_a:.3e}; median K1b {ms:.4f} ms exact, {ms_approx:.4f} ms with "
              f"approx_rcp, K1 on the same lists {ms_flat:.4f} ms (K1b / K1 "
              f"{ms / ms_flat:.4f}), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}) on {smi}", flush=True)
        if not rel <= tol_of(torch, dtype) or not same:
            fail(f"K1b at 131k disagrees with its plain twin or with K1 ({dtype})")
        if not rel_a <= tol_of(torch, dtype):
            fail(f"K1b with approx_rcp disagrees with its plain twin at 131k ({dtype})")
    rows.append(kernel_row(BUCKET_KERNELS["lj_cluster_ilist_buckets"], b_launches,
                           *res[torch.float32][:4], exact_ms=res[torch.float32][4]))

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
    slots = slot_sums(torch, pr, share, pr.ijlist.shape[1], buckets)
    warps = slot_sums(torch, pr, share, pr.ijlist.shape[1], buckets, per=4 // share or 1)
    print(f"K2b/K3b at 131k: phase 8's final lists, buckets {buckets}; j16 slots by "
          f"block flat {slots[0]}, nji-sorted {slots[1]} (sorted / flat "
          f"{slots[1] / slots[0]:.4f}), by warp flat {warps[0]}, nji-sorted {warps[1]} "
          f"({warps[1] / warps[0]:.4f}), listed {slots[2]}", flush=True)
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
            plain_ms = median_ms(torch, plain, 5)
            moved = nbytes_of(*planes, *maps[:2], pr.nji, *out) + (
                nbytes_of(fp) if name == "eam_force_buckets" else 0)
            bound = bound_of(ops[name], moved, dtype)
            print(f"{name} at 131k ({str(dtype)[6:]}): max abs err {err:.3e}, rel "
                  f"{rel:.3e} (tol {tol_of(torch, dtype):.0e}); equal to the flat "
                  f"kernel: {same}; median {ms:.4f} ms, flat kernel on the same lists "
                  f"{ms_flat:.4f} ms (ratio {ms / ms_flat:.4f}), plain {plain_ms:.4f} "
                  f"ms, bound {bound[0]:.4f} ms ({bound[1]}) on {smi}", flush=True)
            if not rel <= tol_of(torch, dtype) or not same:
                fail(f"{name} at 131k disagrees with its plain twin or its flat "
                     f"kernel ({dtype})")
            if dtype == torch.float32:
                res[name] = kernel_row(BUCKET_KERNELS[name], launches_e[name], err, ms,
                                       plain_ms, bound)
    rows += [res["eam_rho_buckets"], res["eam_force_buckets"]]

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


def run_bf16_phase(torch, dev, smi: str, ec, lj_main) -> dict:
    """Phase 25: the bf16 probe (T2). `lj_main` is phase 4's (sim, final
    state, K1b launches). Returns the bf16 kernel's JSON row."""
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
    t_ops = 9 * pairs / PEAK_FLOPS["float32"] + 16 * pairs / PEAK_FLOPS["bfloat16"]
    t_mem = nbytes_of(*planes, pr.ijlist, pr.nji, *out) / HBM_BYTES_PER_S
    bound = (max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes")
    print(f"bf16 kernel at 131k (phase 4's final flat lists, {pairs} pairs): max abs "
          f"err {err:.3e}, rel {rel:.3e} (tol {BF16_TOL:.0e}) against its plain twin")
    print(f"bf16 force err: max/typ {mx:.3e}  mean/typ {mean:.3e} (against exact K1)")
    print(f"force K1 exact: {t['k1_exact']:.4f} ms   K1 approx-rcp: "
          f"{t['k1_approx']:.4f} ms   bf16: {t['bf16']:.4f} ms (bf16 / exact "
          f"{t['bf16'] / t['k1_exact']:.4f}, approx / exact "
          f"{t['k1_approx'] / t['k1_exact']:.4f}); bf16 plain {plain_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}) on {smi}", flush=True)
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


def main() -> int:
    import torch

    t_start = time.perf_counter()

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
    from mdbench_tpu_torch.stats import compute_cluster_stats

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}",
          flush=True)
    log = _build.library_path().with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())

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

    # 5. small input: card against the CPU plain path, float64
    kw = dict(nx=8, ny=8, nz=8, ntimes=40, reneigh_every=10, resort_every=20,
              precision="dp", scheme="cluster")
    x, v, _ = create_fcc_lattice(Params(**kw))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    f_cpu = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu").first_force_atoms()
    f_gpu = ClusterSimulation(Params(**kw), x=x, v=v, device=dev).first_force_atoms()
    frel = np.abs(f_gpu - f_cpu).max() / np.abs(f_cpu).max()
    r_cpu = ClusterSimulation(Params(**kw), device="cpu").run()
    r_gpu = ClusterSimulation(Params(**kw), device=dev).run()
    trel = float(np.max(np.abs(r_gpu.temps - r_cpu.temps) / np.abs(r_cpu.temps)))
    print(f"small input 8^3 dp: step-0 force rel err {frel:.3e} (tol 1e-10), "
          f"40-step temperature rel err {trel:.3e} (tol 1e-9)", flush=True)
    if not (frel <= 1e-10 and trel <= 1e-9):
        fail("the card's run disagrees with the CPU plain path")

    # 6. kernel at the main path's shapes: the run's final planes and lists
    cl, pr = st.clusters, st.pairs
    npad = sim.n_clusters_pad
    cut = (p.cutforce**2, p.sigma6, p.epsilon)
    cs = compute_cluster_stats(cl, pr, npad, GROUP, p.cutforce**2, p.cutneigh**2)
    evaluated, inside = ilist_pairs(cs, sim.ishare), cs["pairs_within_cutforce"]
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
        plain_ms = median_ms(torch, plain, 5)
        bound = bound_of(lj_ops(evaluated, inside),
                         nbytes_of(*planes, pr.ijlist, pr.nji, *out), dtype)
        # the main path's form (approx_rcp) for the JSON row, the exact time beside
        res[dtype] = (err_a, ms_approx, plain_ms, bound, ms)
        padded = npad * 8 * pr.ijlist.shape[1] * 16
        print(f"kernel at 131k ({str(dtype)[6:]}, {pr.ijlist.shape[0]} units x icap "
              f"{pr.ijlist.shape[1]}, share {sim.ishare}, {padded} padded pairs = "
              f"{padded / (ms * 1e-3):.4e} pairs/s, {evaluated} evaluated, {inside} "
              f"inside the cutoff): max abs err {err:.3e}, rel {rel:.3e} (tol "
              f"{tol_of(torch, dtype):.0e}); median kernel {ms:.4f} ms exact, "
              f"{ms_approx:.4f} ms with approx_rcp (approx / exact "
              f"{ms_approx / ms:.4f}, max abs err {err_a:.3e}, rel {rel_a:.3e}), "
              f"plain {plain_ms:.4f} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]}) on {smi}", flush=True)
        if not rel_a <= tol_of(torch, dtype):
            fail(f"K1 with approx_rcp disagrees with its plain version at 131k ({dtype})")
        if not rel <= tol_of(torch, dtype):
            fail(f"kernel disagrees with its plain version at 131k ({dtype})")

    # 7-10. the cluster EAM path
    eam_rows, eam_main = run_eam_phases(torch, dev, smi, ec)

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

    print(json.dumps({"kernels": [
        kernel_row(KERNEL, launches, *res[torch.float32][:4],
                   exact_ms=res[torch.float32][4]),
        *eam_rows, stream_row,
        *typed_rows, *bucket_rows, bf16_row, *fetch_rows,
    ]}))
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
