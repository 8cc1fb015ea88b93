"""K4 (the group-window kernel, csrc/lj_cluster_stream.cu) beside K1 exact
(csrc/lj_cluster_ilist.cu) at the benchmark's 131,072 atoms:

    python -m mdbench_tpu_torch.probes.stream

Runs the 200-step SP benchmark once on each force path (kernel="pallas"
and kernel="auto", one timed region of one run each; the golden gate is
chip_smoke.py's business), then times, on each run's final state, K4 on
the group lists, K4t on the same lists with two random types and
non-uniform tables, and K1 exact on the exact lists, float32 and
float64, back to back (CUDA events) and on the device alone (CUDA graph),
and prints one line per dtype with the card's name and power limit. It calls
only the package's force wrappers and engine, so the same file also times
an earlier checkout of the package (put that checkout first on
PYTHONPATH) for an A/B comparison within one call on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench_tpu_torch.probes import card_line, event_ms, graph_ms


# two types, eps 1.0 / 0.7 / 1.3, sigma 1.0 / 0.95 / 1.05, cutoff 2.5
# (chip_smoke.NONUNIFORM_TABLES)
TABLES = tuple(torch.tensor(t) for t in (
    np.array([[1.0, 0.7], [0.7, 1.3]]), np.array([[1.0, 0.95], [0.95, 1.05]]) ** 6,
    np.full((2, 2), 2.5**2)))


def final_state(kernel: str):
    """(sim, final state, TOTAL) of one 131k/200 SP run on `kernel`."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation

    sim = ClusterSimulation(Params(precision="sp", scheme="cluster", kernel=kernel,
                                   dense_thermo=False), device="cuda")
    out = sim.run(repeats=1, chain=1)
    return sim, out.state, out.total_time


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probes.stream needs a CUDA card")
    from mdbench_tpu_torch.ops import lj_cluster as lj

    smi = card_line()
    g_sim, g_st, g_total = final_state("pallas")
    e_sim, e_st, e_total = final_state("auto")
    p = g_sim.params
    cut = (p.cutforce**2, p.sigma6, p.epsilon)
    print(f"TOTAL pallas {g_total:.6f} s, auto {e_total:.6f} s (one run each)")
    for dtype in (torch.float32, torch.float64):
        gp = [q.to(dtype) for q in (g_st.clusters.xc, g_st.clusters.yc, g_st.clusters.zc)]
        ep = [q.to(dtype) for q in (e_st.clusters.xc, e_st.clusters.yc, e_st.clusters.zc)]
        gpr, epr = g_st.pairs, e_st.pairs

        def k4():
            return lj.lj_cluster_force_stream(*gp, gpr.jlist, gpr.ranges,
                                              g_sim.n_clusters_pad, *cut)

        tc = torch.tensor(np.random.default_rng(0).integers(0, 2, tuple(gp[0].shape)),
                          dtype=torch.int32, device=gp[0].device)
        tabs = tuple(t.to(device=gp[0].device, dtype=dtype) for t in TABLES)

        def k4t():
            return lj.lj_cluster_force_stream(*gp, gpr.jlist, gpr.ranges,
                                              g_sim.n_clusters_pad, *cut, tc=tc,
                                              tables=tabs)

        def k1():
            return lj.lj_cluster_force_ilist(*ep, epr.ijlist, epr.nji,
                                             e_sim.n_clusters_pad, *cut,
                                             share=e_sim.ishare)

        t = {name: (event_ms(fn, 50), graph_ms(fn, 50)) for name, fn in
             (("K4", k4), ("K4t", k4t), ("K1", k1))}
        print(f"{str(dtype)[6:]}: K4 {t['K4'][0]:.4f} ms back to back, {t['K4'][1]:.4f} "
              f"ms on the device ({gpr.jlist.shape[0]} groups x L {gpr.jlist.shape[1]}); "
              f"K4t {t['K4t'][0]:.4f} / {t['K4t'][1]:.4f} ms on the same lists; "
              f"K1 exact {t['K1'][0]:.4f} / {t['K1'][1]:.4f} ms; K4 / K1 exact "
              f"{t['K4'][0] / t['K1'][0]:.4f} back to back, {t['K4'][1] / t['K1'][1]:.4f} "
              f"on the device; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
