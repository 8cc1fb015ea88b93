"""Synthetic-workload kernel microbenchmark, cluster scheme — the port of
``mdbench_tpu.stub`` (the reference's `-stub` variant,
src/clusterpair/main-stub.c): synthetic cluster planes and synthetic
group-shared j16 lists with controlled access patterns replace the whole
data and list stack, so the group-window force kernel is measured alone.

Patterns (main-stub.c:61-120), per group list of `nneighs` j16:
  seq  — j16 g*8+1, g*8+2, ... (mod the j16 count)
  fix  — j16 0, 1, ..., nneighs-1 for every group
  rand — nneighs distinct random j16
every member's window covering the whole list; cutforce = 1e6, so every
pair of distinct atoms interacts (main-stub.c:46-47).

Metrics (main-stub.c:280-320): Mega atom updates/s, cycles/atom,
cycles/neighbor (at --freq GHz), optional CSV row.

    python -m mdbench_tpu_torch.stub --scheme cluster [-na N] [-nn NN]
        [-nr R] [--pattern seq|fix|rand] [-n steps] [--csv]
        [--precision sp|dp] [--freq GHz]

It runs on the CUDA card. The verlet stub (mdbench_tpu's default scheme)
is not ported yet (ROADMAP.md slice 2) and raises NotImplementedError.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from mdbench_tpu_torch.ops import lj_cluster

GROUP = 16


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
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA device")
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

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    first = loop()  # un-timed run
    sync()
    t0 = time.perf_counter()
    loop()
    sync()
    total = time.perf_counter() - t0

    freq_hz = proc_freq * 1e9
    upd_per_s = natoms / total * ntimes
    cy_atom = total / natoms / ntimes * freq_hz
    cy_neigh = cy_atom / max(nneighs * nreps, 1)
    result = dict(
        scheme="cluster", pattern=pattern, natoms=natoms,
        nneighs=nneighs, nreps=nreps, ntimes=ntimes, total=total,
        mega_updates=upd_per_s / 1e6, cycles_per_atom=cy_atom,
        cycles_per_neighbor=cy_neigh, first_force=first,
    )
    if csv:
        print("steps,pattern,natoms,nneighs,nreps,time(s),atom upds/s(M),"
              "cy/atom,cy/neigh")
        print(
            "%d,%s,%d,%d,%d,%.4f,%.4f,%.4f,%.4f"
            % (ntimes, pattern, natoms, nneighs, nreps, total,
               upd_per_s / 1e6, cy_atom, cy_neigh)
        )
    else:
        print(
            "Total time: %.4f, Mega atom updates/s: %.4f"
            % (total, upd_per_s / 1e6)
        )
        print(
            "Cycles per atom: %.4f, Cycles per neighbor: %.4f"
            % (cy_atom, cy_neigh)
        )
    return result


def main(argv=None) -> int:
    """mdbench_tpu.stub's command line. The cluster stub runs on the CUDA
    card; the verlet stub (the default scheme) raises
    NotImplementedError."""
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
        i += 1
    if scheme != "cluster":
        raise NotImplementedError(
            "mdbench_tpu_torch.stub runs the cluster stub only "
            "(--scheme cluster); the verlet stub comes with the verlet "
            "scheme, ROADMAP.md slice 2"
        )
    # half lists and EAM are verlet-stub axes, as in mdbench_tpu
    for k in ("half", "force_field", "eam_file", "eam_eval"):
        kw.pop(k, None)
    run_cluster_stub(**kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
