"""The bf16 probe on the card: K1 with bfloat16 pair math, the port's
counterpart of tools/r3_bf16.py.

    python -m mdbench_tpu_torch.probes.bf16            # (a) and (b)
    python -m mdbench_tpu_torch.probes.bf16 golden     # + (c)
    python -m mdbench_tpu_torch.probes.bf16 ab         # + (d)

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
(a) and (b) run on the final state of a flat 200-step run of the
workload: in the initial state the atoms sit on the lattice, where the
forces cancel to rounding noise and the error metric has no scale.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mdbench_tpu_torch.bench import root_bench
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine_cluster import ClusterSimulation, FlatSimulation
from mdbench_tpu_torch.ops.lj_cluster import (
    lj_cluster_force_ilist,
    lj_cluster_force_ilist_bf16,
)
from mdbench_tpu_torch.probes import card_line, graph_ms


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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("mdbench_tpu_torch.probes.bf16 needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
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
