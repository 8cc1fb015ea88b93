"""Synthetic-workload force microbenchmark — the port of
``mdbench_tpu.stub`` (the reference's `-stub` variants,
src/verletlist/main-stub.c and src/clusterpair/main-stub.c): synthetic
atoms and synthetic lists with controlled access patterns replace the
whole data and list stack, so the force is measured alone.

Verlet scheme (the default): atoms at tiny increments and per-atom lists
of `nneighs` neighbors repeated `nreps` times (main-stub.c:60-105):
  seq  — neighbors of i are i+1, i+2, ... (mod natoms)
  fix  — every atom's neighbors are 0, 1, ..., nneighs-1
  rand — nneighs distinct random neighbors other than i
and the planar LJ force (full or half lists, ops/lj.py: torch ops) or the
two-pass EAM force (`-f eam -e <funcfl>`, spline or poly, ops/eam.py: the
kernels K5 and K6 on the card, their plain versions on the CPU).
Cluster scheme: synthetic cluster planes and group-shared j16 lists with
the same patterns (clusterpair/main-stub.c:61-120), every member's window
covering the whole list, and the group-window force kernel K4.
cutforce = 1e6, so every pair of distinct atoms interacts
(main-stub.c:46-47); EAM takes the potential's cutoff (initEam).

Metrics (main-stub.c:280-320): Mega atom updates/s, cycles/atom,
cycles/neighbor (at --freq GHz), optional CSV row.

    python -m mdbench_tpu_torch.stub [--scheme verlet|cluster] [-na N]
        [-nn NN] [-nr R] [--pattern seq|fix|rand] [-n steps] [--csv]
        [--precision sp|dp] [--freq GHz] [-half 0|1] [-f lj|eam]
        [-e funcfl] [--eam-eval spline|poly] [--device cuda|cpu]

It runs on the CUDA card unless `--device cpu` is given; without a card
it raises.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from mdbench_tpu_torch.models.eam_tables import fit_eam_poly, load_eam
from mdbench_tpu_torch.ops import lj_cluster
from mdbench_tpu_torch.ops.eam import (
    EamDevice,
    compute_force_eam,
    compute_force_eam_poly,
)
from mdbench_tpu_torch.ops.lj import compute_force_lj_full, compute_force_lj_half

GROUP = 16


def create_stub_atoms(natoms: int):
    """Synthetic positions at tiny increments, so that every pair interacts
    (reference main-stub.c), and zero velocities; float64 numpy."""
    i = np.arange(natoms, dtype=np.float64)
    x = np.stack([i * 1e-5, i * 1e-5, i * 1e-5], axis=1)
    return x, np.zeros_like(x)


def create_neighbors(natoms: int, pattern: str, nneighs: int, nreps: int,
                     seed: int = 42):
    """Synthetic fixed-width lists (reference createNeighbors,
    main-stub.c:60-105): (neighbors (natoms, nneighs*nreps), numneigh
    (natoms,)), int32 numpy, mdbench_tpu's arrays."""
    maxneighs = nneighs * nreps
    neigh = np.zeros((natoms, maxneighs), np.int32)
    if pattern == "rand" and natoms <= nneighs:
        raise ValueError(
            "random pattern requires natoms > nneighs (main-stub.c:67-71)"
        )
    rng = np.random.default_rng(seed)
    for i in range(natoms):
        if pattern == "seq":
            row = (i + 1 + np.arange(nneighs)) % natoms
        elif pattern == "fix":
            row = np.arange(nneighs) % nneighs
        elif pattern == "rand":
            row = rng.choice(natoms, size=nneighs + 1, replace=False)
            row = row[row != i][:nneighs]
        else:
            raise ValueError(f"unknown pattern {pattern}")
        neigh[i] = np.tile(row, nreps)
    numneigh = np.full(natoms, maxneighs, np.int32)
    return neigh, numneigh


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA device")
    return device


def _timed_loop(step, device: torch.device):
    """One un-timed pass of step() (warm-up), then a timed one fenced by
    torch.cuda.synchronize(). Returns (seconds, the warm-up's result)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    first = step()
    sync()
    t0 = time.perf_counter()
    step()
    sync()
    return time.perf_counter() - t0, first


def _report(result: dict, per_neighbor: int, total: float, proc_freq: float,
            csv: bool) -> dict:
    """Add the rates to `result` (a run's natoms, nneighs, nreps, ntimes,
    pattern) and print the reference's two result lines, or its CSV header
    and row (main-stub.c:280-320); cycles per neighbor divide by
    `per_neighbor` neighbors."""
    natoms, ntimes = result["natoms"], result["ntimes"]
    freq_hz = proc_freq * 1e9
    upd_per_s = natoms / total * ntimes
    cy_atom = total / natoms / ntimes * freq_hz
    cy_neigh = cy_atom / max(per_neighbor, 1)
    result.update(total=total, mega_updates=upd_per_s / 1e6,
                  cycles_per_atom=cy_atom, cycles_per_neighbor=cy_neigh)
    if csv:
        print("steps,pattern,natoms,nneighs,nreps,time(s),atom upds/s(M),"
              "cy/atom,cy/neigh")
        print("%d,%s,%d,%d,%d,%.4f,%.4f,%.4f,%.4f"
              % (ntimes, result["pattern"], natoms, result["nneighs"], result["nreps"],
                 total, upd_per_s / 1e6, cy_atom, cy_neigh))
    else:
        print("Total time: %.4f, Mega atom updates/s: %.4f" % (total, upd_per_s / 1e6))
        print("Cycles per atom: %.4f, Cycles per neighbor: %.4f" % (cy_atom, cy_neigh))
    return result


def run_stub(
    natoms: int = 65536,
    nneighs: int = 76,
    nreps: int = 1,
    pattern: str = "seq",
    ntimes: int = 200,
    half: bool = False,
    proc_freq: float = 2.4,
    csv: bool = False,
    precision: str = "sp",
    force_field: str = "lj",
    eam_file: str | None = None,
    eam_eval: str = "spline",
    device="cuda",
) -> dict:
    """Verlet-scheme force microbenchmark (reference
    verletlist/main-stub.c): synthetic atoms (plus a sentinel row) and
    lists, the force alone. Each step is one force call and x += 1e-30 *
    f on the atoms; one un-timed run of `ntimes` steps, then the timed run
    from the same atoms. LJ full or half lists, or EAM (the potential's
    cutoff, no ghosts: an empty fp refresh) with the gathered splines or
    (eam_eval "poly") the fitted polynomials (on a card: K5 and K6), on
    `device`. Prints the reference's two result lines (or the CSV row)
    and returns the numbers, with `first_force`, the (natoms, 3) forces
    of the first step."""
    device = _device(device)
    dtype = torch.float64 if precision == "dp" else torch.float32
    xh, _ = create_stub_atoms(natoms)
    neigh_h, numneigh_h = create_neighbors(natoms, pattern, nneighs, nreps)
    x0 = torch.tensor(np.concatenate([xh, [[1e30, 1e30, 1e30]]]), dtype=dtype,
                      device=device)
    neigh = torch.tensor(neigh_h, dtype=torch.int64, device=device)
    numneigh = torch.tensor(numneigh_h, dtype=torch.int64, device=device)
    cutsq = 1.0e6**2  # all pairs interact (main-stub.c:46)

    if force_field == "eam":
        # initEam sets cutforce to the potential's cutoff (eam_utils.c:22-40)
        if not eam_file:
            raise ValueError("-f eam requires -e <funcfl file>")
        t = load_eam(eam_file)
        eam = EamDevice.from_tables(t, device, dtype)
        cutsq = float(t.cut) ** 2
        args = (neigh, numneigh, torch.zeros((0,), dtype=torch.int64, device=device),
                natoms, natoms, cutsq, eam)
        if eam_eval == "poly":
            poly = fit_eam_poly(t)

            def force(x):
                return compute_force_eam_poly(x, *args, poly)[0]
        else:
            def force(x):
                return compute_force_eam(x, *args)[0]
    elif half:
        def force(x):
            return compute_force_lj_half(x, neigh, numneigh, natoms, natoms, cutsq,
                                         1.0, 1.0)
    else:
        def force(x):
            return compute_force_lj_full(x, neigh, numneigh, natoms, cutsq, 1.0, 1.0)

    def loop():
        x = x0.clone()
        first = None
        for _ in range(ntimes):
            f = force(x)
            first = f if first is None else first
            x[:natoms] += 1e-30 * f
        return first

    total, first = _timed_loop(loop, device)
    result = dict(force_field=force_field, pattern=pattern, natoms=natoms,
                  nneighs=nneighs, nreps=nreps, ntimes=ntimes, first_force=first)
    return _report(result, nneighs, total, proc_freq, csv)


def create_stub_clusters(n_clusters: int, group: int = 16):
    """Synthetic cluster planes (cluster-scheme stub, reference
    clusterpair/main-stub.c:61-120): 8-atom clusters at tiny coordinate
    increments so every pair interacts; padded to a multiple of
    8*group rows plus the sentinel pair. Returns (xc, yc, zc, n_pad),
    float64 numpy."""
    blk = 8 * group
    n_pad = (n_clusters + blk - 1) // blk * blk
    rows = n_pad + 2  # even total; last pair = all-sentinel
    idx = np.arange(n_pad * 8, dtype=np.float64).reshape(n_pad, 8)
    xc = np.full((rows, 8), 1e30)
    yc = np.full((rows, 8), 1e30)
    zc = np.full((rows, 8), 1e30)
    xc[:n_pad] = idx * 1e-5
    yc[:n_pad] = idx * 1e-5
    zc[:n_pad] = idx * 1e-5
    return xc, yc, zc, n_pad


def create_cluster_pair_list(
    n_pad: int, group: int, nneighs_j16: int, pattern: str, seed: int = 42
):
    """Synthetic per-group shared j16 lists with seq/fix/rand patterns
    (reference cluster stub createNeighbors, main-stub.c:61-120) and full
    per-member tile windows (imask = ALL). Returns (jlist (ng, 1, L),
    ranges (ng, 1, 2*group+1), nj (ng,)), int32 numpy, in mdbench_tpu's
    layout."""
    ng = n_pad // group
    n16 = n_pad // 2
    L = (nneighs_j16 + 7) // 8 * 8
    sentinel16 = (n_pad + 2) // 2 - 1
    jl = np.full((ng, 1, L), sentinel16, np.int32)
    rng = np.random.default_rng(seed)
    for g in range(ng):
        if pattern == "seq":
            row = (g * (group // 2) + 1 + np.arange(nneighs_j16)) % n16
        elif pattern == "fix":
            row = np.arange(nneighs_j16) % n16
        elif pattern == "rand":
            row = rng.choice(n16, size=nneighs_j16, replace=False)
        else:
            raise ValueError(f"unknown pattern {pattern}")
        jl[g, 0, :nneighs_j16] = row
    ranges = np.zeros((ng, 1, 2 * group + 1), np.int32)
    ranges[:, 0, group : 2 * group] = (nneighs_j16 + 7) // 8
    ranges[:, 0, 2 * group] = (nneighs_j16 + 7) // 8
    nj = np.full(ng, nneighs_j16, np.int32)
    return jl, ranges, nj


def run_cluster_stub(
    natoms: int = 65536,
    nneighs: int = 76,  # j16 clusters per group list
    nreps: int = 1,
    pattern: str = "seq",
    ntimes: int = 200,
    proc_freq: float = 2.4,
    csv: bool = False,
    precision: str = "sp",
    device="cuda",
) -> dict:
    """Cluster-scheme kernel microbenchmark (reference
    clusterpair/main-stub.c): synthetic cluster planes and group-shared
    j16 lists, the group-window force alone. Each step is one force call
    and xc += 1e-30 * fx; one un-timed run of `ntimes` steps, then the
    timed run from the same planes, fenced by torch.cuda.synchronize().
    On a CUDA device the force is the group-window kernel; on the CPU its
    plain version. Prints the reference's two result lines (or the CSV
    row) and returns the numbers, with `first_force`, the (fx, fy, fz)
    of the first step."""
    device = _device(device)
    dtype = torch.float64 if precision == "dp" else torch.float32
    n_clusters = (natoms + 7) // 8
    xch, ych, zch, n_pad = create_stub_clusters(n_clusters, GROUP)
    jlh, rgh, _nj = create_cluster_pair_list(
        n_pad, GROUP, nneighs * nreps, pattern
    )
    xc0, yc, zc = (torch.tensor(a, dtype=dtype, device=device)
                   for a in (xch, ych, zch))
    jl = torch.tensor(jlh.reshape(jlh.shape[0], -1), device=device)
    rg = torch.tensor(rgh.reshape(rgh.shape[0], -1), device=device)
    cutsq = 1.0e6**2

    def loop():
        xc = xc0.clone()
        first = None
        for _ in range(ntimes):
            f = lj_cluster.lj_cluster_force_stream(
                xc, yc, zc, jl, rg, n_pad, cutsq, 1.0, 1.0)
            first = f if first is None else first
            xc[:n_pad] += 1e-30 * f[0]
        return first

    total, first = _timed_loop(loop, device)
    result = dict(scheme="cluster", pattern=pattern, natoms=natoms,
                  nneighs=nneighs, nreps=nreps, ntimes=ntimes, first_force=first)
    return _report(result, nneighs * nreps, total, proc_freq, csv)


def main(argv=None) -> int:
    """mdbench_tpu.stub's command line, with the port's `--device` (default
    cuda; no fallback)."""
    argv = sys.argv[1:] if argv is None else argv
    kw = {}
    scheme = "verlet"
    i = 0
    while i < len(argv):
        a = argv[i]

        def nxt():
            nonlocal i
            i += 1
            return argv[i]

        if a == "--scheme":
            scheme = nxt()
        elif a == "-na":
            kw["natoms"] = int(nxt())
        elif a == "-nn":
            kw["nneighs"] = int(nxt())
        elif a == "-nr":
            kw["nreps"] = int(nxt())
        elif a == "--pattern":
            kw["pattern"] = nxt()
        elif a in ("-n", "--nsteps"):
            kw["ntimes"] = int(nxt())
        elif a == "-half":
            kw["half"] = bool(int(nxt()))
        elif a == "-f":
            kw["force_field"] = nxt()
        elif a == "-e":
            kw["eam_file"] = nxt()
        elif a == "--freq":
            kw["proc_freq"] = float(nxt())
        elif a == "--csv":
            kw["csv"] = True
        elif a == "--precision":
            kw["precision"] = nxt()
        elif a == "--eam-eval":
            kw["eam_eval"] = nxt()
        elif a == "--device":
            kw["device"] = nxt()
        i += 1
    if scheme == "cluster":
        # half lists and EAM are verlet-stub axes (the reference's cluster
        # EAM is a dead stub, clusterpair/force_eam.c:20-37), as in
        # mdbench_tpu
        for k in ("half", "force_field", "eam_file", "eam_eval"):
            kw.pop(k, None)
        run_cluster_stub(**kw)
    else:
        run_stub(**kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
