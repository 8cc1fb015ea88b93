"""The bf16 probe on the card: K1 with bfloat16 pair math, the port's
counterpart of tools/r3_bf16.py.

    python -m mdbench_tpu_torch.probes.bf16            # (a) and (b)
    python -m mdbench_tpu_torch.probes.bf16 golden     # + (c)
    python -m mdbench_tpu_torch.probes.bf16 ab         # + (d)
    python -m mdbench_tpu_torch.probes.bf16 CSRC_DIR   # + (e), any of them

On the benchmark's workload (131,072 atoms, SP, cluster scheme) it prints
  (a) the bf16 force's error against the exact float32 K1 force, per atom
      |f_bf16 - f| over the median nonzero |f|: max/typ and mean/typ, as
      the tool prints them;
  (b) the median CUDA-event times of K1 exact, K1 with the approximate
      reciprocal (approx_rcp) and the bf16 kernel on the same lists, on
      the device alone (probes.graph_ms: replayed from a CUDA graph, so
      the wrappers' host path, longer for the bf16 one, times nothing);
  (c) with `golden`: the 200-step run with the bf16 kernel in place of
      K1, on flat lists (no capacity buckets, as the tool turns them off),
      through the golden gate: PASS or FAIL, and the temperatures at steps
      20, 100 and 200 beside GOLDEN_TEMP_131K. A FAIL is the probe's
      finding, not a fault of the port.
  (d) with `ab`: the benchmark run (`python -m mdbench_tpu_torch.bench`'s
      workload, capacity buckets and all, golden-gated) alternately with
      approx_rcp on and off (on off off on, twice), 3 timed regions of one
      run each, and the median TOTAL of each side: what the approximate
      reciprocal moves end to end.
  (e) with one or more CSRC_DIR, other copies of mdbench_tpu_torch/csrc/
      with the same C entry points (an earlier checkout's, or an edited
      variant): each one's library is built beside the package's, and the
      bf16 kernel runs with each library in turns (this one, the others,
      then back in reverse order), in one process on one card, on (b)'s
      lists (ms back to back and on the device) and on `edge_case`'s lists
      for share 1, 2 and 4, with a fingerprint of the output bits each
      time: equal fingerprints mean equal bits. The kernel's -Xptxas -v
      lines come first.
(a), (b) and (e) run on the final state of a flat 200-step run of the
workload: in the initial state the atoms sit on the lattice, where the
forces cancel to rounding noise and the error metric has no scale.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from mdbench_tpu_torch import _build
from mdbench_tpu_torch.bench import root_bench
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine_cluster import ClusterSimulation, FlatSimulation
from mdbench_tpu_torch.ops.lj_cluster import (
    lj_cluster_force_ilist,
    lj_cluster_force_ilist_bf16,
    lj_cluster_force_ilist_bf16_ref,
)
from mdbench_tpu_torch.probes import card_line, event_ms, graph_ms
from mdbench_tpu_torch.probes.eam_verlet import bits
from mdbench_tpu_torch.state import SENTINEL_COORD

# edge_case's cutoff: cutforcesq 6.3001 lies between two bfloat16 values
EDGE_CUTOFF = 2.51
# (dx, dy) in bfloat16 whose rsq, (dx*dx + dy*dy) + 0 in bfloat16, is
# 6.28125, the largest bfloat16 value below 6.3001 ("inside"), or 6.3125,
# the smallest one above it ("outside"); the first of each side has its
# exact rsq across the cutoff (6.30127, 6.29132), where a float32 test
# would take the other side
EDGE_OFFSETS = {"inside": ((1.203125, 2.203125), (1.0, 2.296875)),
                "outside": ((1.0078125, 2.296875), (1.109375, 2.25))}
EDGE_ICAP = 20
EDGE_LENGTHS = (1, 3, 9, 11, 17, 20, 0)  # list lengths, j16: none a whole chunk


class Bf16Simulation(FlatSimulation):
    """FlatSimulation whose force is the bf16 kernel (the tool's run with
    the kernel patched in). Untyped LJ on the exact-list kernels only."""

    def __init__(self, params: Params, **kw):
        super().__init__(params, **kw)
        if (self.eam_poly is not None or self.type_tables is not None
                or self._kmode != "ilist_pl" or not self._ilist):
            raise ValueError("the bf16 force runs untyped LJ on the exact-list "
                             "kernels (kernel auto or ilist_pl) only")

    def _force_from(self, clusters, pairs, halo):
        p = self.params
        return lj_cluster_force_ilist_bf16(
            clusters.xc, clusters.yc, clusters.zc, pairs.ijlist, pairs.nji,
            self.n_clusters_pad, p.cutforce**2, p.sigma6, p.epsilon,
            share=self.ishare)


def _lists(sim, state):
    """(planes, ijlist, nji, n_clusters_pad, LJ scalars, share) of a state."""
    p, cl = sim.params, state.clusters
    return ((cl.xc, cl.yc, cl.zc), state.pairs.ijlist, state.pairs.nji,
            sim.n_clusters_pad, (p.cutforce**2, p.sigma6, p.epsilon), sim.ishare)


def force_error(sim, state) -> tuple:
    """(max/typ, mean/typ) of the bf16 force against the exact float32 K1
    force on `state`'s lists: per atom the norm of the difference over the
    median of the nonzero exact norms (tools/r3_bf16.py:173-182)."""
    planes, ijl, nji, npad, lj, share = _lists(sim, state)
    exact = lj_cluster_force_ilist(*planes, ijl, nji, npad, *lj, share=share)
    bf = lj_cluster_force_ilist_bf16(*planes, ijl, nji, npad, *lj, share=share)
    on = torch.linalg.vector_norm(torch.stack(exact, -1).double(), dim=-1)
    dn = torch.linalg.vector_norm(
        torch.stack([b.double() - e.double() for b, e in zip(bf, exact)], -1), dim=-1)
    on, dn = on.cpu().numpy(), dn.cpu().numpy()
    scale = max(float(np.median(on[on > 0])), 1e-30)
    return float(dn.max()) / scale, float(dn.mean()) / scale


def kernel_times(sim, state, reps: int = 20) -> dict:
    """Median device ms (graph_ms) of K1 exact, K1 with the approximate
    reciprocal and the bf16 kernel on `state`'s lists, in that order."""
    planes, ijl, nji, npad, lj, share = _lists(sim, state)
    calls = {
        "k1_exact": lambda: lj_cluster_force_ilist(*planes, ijl, nji, npad, *lj,
                                                   share=share),
        "k1_approx": lambda: lj_cluster_force_ilist(*planes, ijl, nji, npad, *lj,
                                                    share=share, approx_rcp=True),
        "bf16": lambda: lj_cluster_force_ilist_bf16(*planes, ijl, nji, npad, *lj,
                                                    share=share),
    }
    return {name: graph_ms(fn, reps) for name, fn in calls.items()}


def edge_case(share: int, device, seed: int = 0) -> dict:
    """Flat lists for the bf16 kernel's edge cases, from numpy's
    default_rng(seed), at cutoff EDGE_CUTOFF (sigma6 and epsilon 1). The
    128 i-atoms (16 cluster rows, 16 // share units) sit 8 apart; unit 1
    is all padding (SENTINEL_COORD rows) and must get exactly 0. Atom i
    has i % 5 partners (odd counts included), within 3 of it, so no pair
    of two units is inside: atoms with i % 3 == 0 take their first partner
    at an EDGE_OFFSETS "inside" offset, atoms with i % 3 == 1 their second
    at an "outside" one (signs and axes drawn), and the other partners lie
    1.3-2.45 away (three in four) or 2.6-3.0. A
    unit's partners fill its own j16 (the rest padding); its list holds
    them among other units' j16, the i-atoms' own j16 (rsq 0 with itself)
    and the all-padding j16, EDGE_LENGTHS[u] entries long (at least its
    own), none a whole 128-atom chunk; past nji the padding j16. Returns
    dict(xc, yc, zc, ijlist, nji, n_clusters_pad, share, cutforcesq,
    sigma6, epsilon), the planes float32 and the lists int32 on
    `device`."""
    rng = np.random.default_rng(seed)
    n_i, tpu = 128, 8 * share
    a = np.arange(n_i)
    ipos = 8.0 * np.stack([a % 8, (a // 8) % 8, a // 64], 1) + 4.0
    pad_i = a // tpu == 1
    offsets = [[] for _ in range(n_i // tpu)]  # per unit: partner positions
    for i in np.flatnonzero(~pad_i):
        for q in range(i % 5):
            if q < 2 and i % 3 == q:
                dx, dy = EDGE_OFFSETS["inside" if q == 0 else "outside"][(i // 3) % 2]
                d = rng.permutation([dx, dy, 0.0]) * rng.choice([-1.0, 1.0], 3)
            else:
                r = rng.uniform(1.3, 2.45) if rng.random() < 0.75 else rng.uniform(2.6, 3.0)
                u = rng.normal(size=3)
                d = r * u / np.linalg.norm(u)
            offsets[i // tpu].append(ipos[i] - d)  # x_i - x_j = d exactly
    rows = [ipos]  # flat atoms, 16 a j16
    own = []  # per unit: its partners' j16 ids
    for pts in offsets:
        n16 = -(-len(pts) // 16)
        block = np.full((n16 * 16, 3), np.nan)
        block[: len(pts)] = np.reshape(pts, (-1, 3))
        j0 = sum(len(r) for r in rows) // 16
        own.append(list(range(j0, j0 + n16)))
        rows.append(block)
    rows.append(np.full((16, 3), np.nan))  # the all-padding j16, last
    pos = np.concatenate(rows)
    nat = pos.shape[0]
    pad = np.isnan(pos[:, 0])
    pad[:n_i] |= pad_i
    sentinel = SENTINEL_COORD * (1.0 + np.arange(nat) * 1e-6)
    pos[pad] = sentinel[pad, None]
    n16 = nat // 16
    nu = n_i // tpu
    ijlist = np.full((nu, EDGE_ICAP), n16 - 1, np.int32)
    nji = np.zeros(nu, np.int32)
    others = list(range(n16 - 1))
    for u in range(nu):
        n = max(EDGE_LENGTHS[u % len(EDGE_LENGTHS)], len(own[u]))
        fill = [j for j in rng.permutation(others) if j not in own[u]]
        fill = fill + [n16 - 1] * n  # the padding j16 when others run out
        lst = list(fill[: n - len(own[u])])
        for j in own[u]:
            lst.insert(int(rng.integers(0, len(lst) + 1)), j)
        ijlist[u, :n] = lst
        nji[u] = n
    planes = [torch.tensor(pos[:, c].reshape(-1, 8), dtype=torch.float32, device=device)
              for c in range(3)]
    return dict(xc=planes[0], yc=planes[1], zc=planes[2],
                ijlist=torch.tensor(ijlist, device=device),
                nji=torch.tensor(nji, device=device), n_clusters_pad=n_i // 8,
                share=share, cutforcesq=EDGE_CUTOFF**2, sigma6=1.0, epsilon=1.0)


def edge_force(case: dict, plain: bool = False):
    """The bf16 force on an edge_case (its wrapper, or with `plain` the
    plain twin)."""
    planes = (case["xc"], case["yc"], case["zc"])
    args = (case["n_clusters_pad"], case["cutforcesq"], case["sigma6"], case["epsilon"])
    if plain:
        return lj_cluster_force_ilist_bf16_ref(*planes, case["ijlist"], *args,
                                               share=case["share"])
    return lj_cluster_force_ilist_bf16(*planes, case["ijlist"], case["nji"], *args,
                                       share=case["share"])


def golden_run(device="cuda", repeats: int = 1, chain: int = 1, **overrides) -> tuple:
    """The 131k/200 SP run with the bf16 force on flat lists (`overrides`
    change its Params, for a smaller box), through the golden gate. Returns
    (sim, result, passed, verdict): the gate's failure is the verdict
    "FAIL - <gate message>", not an exception."""
    params = Params(precision="sp", scheme="cluster", dense_thermo=False, **overrides)
    sim = Bf16Simulation(params, device=device)
    out = sim.run(repeats=repeats, chain=chain)
    try:
        root_bench().check_golden(out.temps, params.reneigh_every)
    except SystemExit as e:
        return sim, out, False, f"FAIL - {e}"
    return sim, out, True, "PASS"


def golden_lines(sim, out, verdict: str) -> list:
    """The lines (c) prints: the verdict with the run's rate, then the
    temperatures at steps 20, 100 and 200 beside the golden trace."""
    golden = root_bench().GOLDEN_TEMP_131K
    rate = sim.natoms * sim.params.ntimes / out.total_time
    return [f"bf16 GOLDEN GATE: {verdict}   headline {rate:.6e} atom-updates/s "
            f"(TOTAL {out.total_time:.6f} s)"] + [
        f"  step {s}: temp {out.temps[s - 1]:.6e} (golden {golden[s]:.6e})"
        for s in (20, 100, 200) if s <= len(out.temps)]


def approx_ab(device="cuda", repeats: int = 3) -> dict:
    """(d): the golden-gated benchmark run with approx_rcp on and off, in
    the order on off off on on off off on. Returns {flag: [TOTAL, ...]}."""
    check_golden = root_bench().check_golden
    totals = {True: [], False: []}
    for flag in (True, False, False, True) * 2:
        params = Params(precision="sp", scheme="cluster", dense_thermo=False,
                        approx_rcp=flag)
        out = ClusterSimulation(params, device=device).run(repeats=repeats, chain=1)
        check_golden(out.temps, params.reneigh_every)
        totals[flag].append(out.total_time)
    return totals


def ptxas_lines(src_dir=None) -> list:
    """The -Xptxas -v lines of the bf16 kernel (the kBf16x2 instantiation
    of lj_cluster_ilist_kernel, PairMath's third value) in the library
    built from `src_dir`."""
    import chip_smoke

    lines = chip_smoke.kernel_ptxas_lines("lj_cluster_ilist_kernel", src_dir)
    return [line for line in lines if "PairMathE2E" in line.split(":")[0]] or lines


def library_ab(sim, state, variants, reps: int = 50) -> None:
    """(e): the bf16 kernel with each library of `variants`, (name, csrc
    dir) pairs, in turns: on `state`'s lists (bits, ms back to back and on
    the device) and on edge_case's lists for share 1, 2 and 4 (bits), a
    line each. The package's library is the loaded one after."""
    planes, ijl, nji, npad, lj, share = _lists(sim, state)
    calls = {"131k": lambda: lj_cluster_force_ilist_bf16(*planes, ijl, nji, npad, *lj,
                                                         share=share)}
    for s in (1, 2, 4):
        case = edge_case(s, planes[0].device)
        calls[f"edge share {s}"] = lambda case=case: edge_force(case)
    order = variants + variants[::-1] if len(variants) > 1 else variants
    for name, src in order:
        _build.load(src)
        for case, fn in calls.items():
            line = f"{name} bf16 {case}: bits {bits(fn())}"
            if case == "131k":
                line += (f"; {event_ms(fn, reps):.4f} ms back to back, "
                         f"{graph_ms(fn, reps):.4f} ms on the device")
            print(line, flush=True)
    _build.load(_build.SRC_DIR)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("mdbench_tpu_torch.probes.bf16 needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    variants = [("this", _build.SRC_DIR),
                *((d, Path(d)) for d in argv if d not in ("golden", "ab"))]
    for name, src in variants:  # build every library before the runs
        _build.load(src)
        for line in ptxas_lines(src):
            print(f"{name}: {line}")
    _build.load(_build.SRC_DIR)
    sim = FlatSimulation(Params(precision="sp", scheme="cluster", dense_thermo=False))
    state = sim.run().state
    print(f"bf16 probe: {sim.natoms} atoms, icap {sim.icap}, share {sim.ishare}, "
          f"n_clusters_pad {sim.n_clusters_pad}; the final state of a flat "
          f"{sim.params.ntimes}-step SP run; {card}")
    mx, mean = force_error(sim, state)
    print(f"bf16 force err: max/typ {mx:.3e}  mean/typ {mean:.3e}")
    t = kernel_times(sim, state)
    print(f"force K1 exact: {t['k1_exact']:.4f} ms   K1 approx-rcp: "
          f"{t['k1_approx']:.4f} ms   bf16: {t['bf16']:.4f} ms   (bf16 / exact "
          f"{t['bf16'] / t['k1_exact']:.4f}, approx / exact "
          f"{t['k1_approx'] / t['k1_exact']:.4f}) on {card}")
    if len(variants) > 1:
        library_ab(sim, state, variants)
    if "golden" in argv:
        sim, out, _, verdict = golden_run()
        for line in golden_lines(sim, out, verdict):
            print(line)
    if "ab" in argv:
        totals = approx_ab()
        print(f"approx_rcp A/B (on off off on x2, 3 timed regions of one run each, "
              f"golden gate passed): median TOTAL on "
              f"{np.median(totals[True]):.6f} s, off {np.median(totals[False]):.6f} s; "
              f"on {totals[True]}, off {totals[False]}; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
