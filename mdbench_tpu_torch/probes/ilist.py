"""The exact-list kernels at the benchmark's 131,072 atoms: K1, K1t and K1b
(csrc/lj_cluster_ilist.cu) and K2, K2b, K3 and K3b (csrc/eam_cluster.cu).

    python -m mdbench_tpu_torch.probes.ilist [CSRC_DIR ...]

Runs the 200-step SP LJ benchmark once on kernel="auto" (capacity
buckets planned, as the main path runs it) and the 60-step SP EAM run
once on chip_smoke.py's stand-in potential, one timed region each, then
times on each run's final state, float32 and float64: K1 and K1b (float32
with the approximate reciprocal, the main path's form, and exact), K1t on
the same lists with two random types and non-uniform tables (likewise),
K2 and K2b, K3 and K3b, back to back (CUDA events) and on the device
alone (CUDA graph). It prints one line per kernel with a fingerprint of
its output bits, the sweep counts of the main path's lists, the kernels'
-Xptxas -v lines, and the card's name and power limit.

Each CSRC_DIR is another copy of mdbench_tpu_torch/csrc/ with the same C
entry points (an earlier checkout's, or an edited variant): its library
is built beside the package's, and every kernel is timed with each
library in turns (this one first, then the others, then back in reverse
order), in one process on one card, on the same states; equal
fingerprints mean equal output bits. The probe calls only the package's
wrappers and engine, so it also runs from an earlier checkout's package
(that checkout first on PYTHONPATH, the repository root after it, the
probe run as a file).
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import torch

from mdbench_tpu_torch.probes import card_line, event_ms, graph_ms
from mdbench_tpu_torch.probes.stream import TABLES

REPS = 50


def bits(out) -> str:
    """A fingerprint of the output tensors' bits."""
    h = hashlib.sha1()
    for t in out:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def final_states():
    """(LJ sim, state), (EAM sim, state): one SP run each on the card."""
    import chip_smoke
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation

    lj_sim = ClusterSimulation(Params(precision="sp", scheme="cluster",
                                      dense_thermo=False), device="cuda")
    lj_st = lj_sim.run(repeats=1, chain=1).state
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    eam_file = str(_build.BUILD_DIR / "standin_cu.eam")
    chip_smoke.write_standin_funcfl(eam_file)
    eam_sim = ClusterSimulation(Params(precision="sp", scheme="cluster",
                                       dense_thermo=False, force_field=FF_EAM,
                                       eam_file=eam_file, ntimes=60), device="cuda")
    eam_st = eam_sim.run(repeats=1, chain=1).state
    return (lj_sim, lj_st), (eam_sim, eam_st)


def lj_calls(sim, st, dtype) -> dict:
    from mdbench_tpu_torch.ops import lj_cluster as lj

    cl, pr = st.clusters, st.pairs
    p = sim.params
    planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]
    args = (sim.n_clusters_pad, p.cutforce**2, p.sigma6, p.epsilon)
    share = sim.ishare
    tc = torch.tensor(np.random.default_rng(0).integers(0, 2, tuple(planes[0].shape)),
                      dtype=torch.int32, device=planes[0].device)
    tabs = tuple(t.to(device=planes[0].device, dtype=dtype) for t in TABLES)
    maps = (pr.bijlist, pr.bcrows, pr.binv, pr.nji)
    forms = (("", True), (" exact", False)) if dtype == torch.float32 else (("", False),)
    calls = {}
    for tag, approx in forms:
        calls["K1" + tag] = lambda a=approx: lj.lj_cluster_force_ilist(
            *planes, pr.ijlist, pr.nji, *args, share=share, approx_rcp=a)
        calls["K1b" + tag] = lambda a=approx: lj.lj_cluster_force_buckets(
            *planes, *maps, sim.n_clusters_pad, sim.buckets, *args[1:], share=share,
            approx_rcp=a)
        calls["K1t" + tag] = lambda a=approx: lj.lj_cluster_force_ilist(
            *planes, pr.ijlist, pr.nji, *args, share=share, tc=tc, tables=tabs,
            approx_rcp=a)
    return calls


def eam_calls(sim, st, dtype) -> dict:
    from mdbench_tpu_torch.ops import eam_cluster as ec
    from mdbench_tpu_torch.ops.eam import EamDevice

    cl, pr = st.clusters, st.pairs
    planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]
    args = (sim.n_clusters_pad, sim.params.cutforce**2, sim.eam_poly)
    share, plan = sim.ishare, sim.buckets
    maps = (pr.bijlist, pr.bcrows, pr.binv, pr.nji)
    rho = ec.eam_rho_ilist(*planes, pr.ijlist, pr.nji, *args, share=share)
    eam = EamDevice.from_tables(sim.eam_tables, planes[0].device, dtype)
    fp = ec.fp_plane_from_rho(rho, eam, st.halo.border_map, planes[0].shape[0])
    return {
        "K2": lambda: (ec.eam_rho_ilist(*planes, pr.ijlist, pr.nji, *args,
                                        share=share),),
        "K2b": lambda: (ec.eam_rho_buckets(*planes, *maps, *args, plan, share=share),),
        "K3": lambda: ec.eam_force_ilist(*planes, fp, pr.ijlist, pr.nji, *args,
                                         share=share),
        "K3b": lambda: ec.eam_force_buckets(*planes, fp, *maps, *args, plan,
                                            share=share),
    }


def sweep_line(name, sim, st, cutsq) -> str:
    """The sweep counts of the main path's (bucketed) lists, where the
    package has them."""
    from mdbench_tpu_torch.ops import lj_cluster as lj

    if not hasattr(lj, "ilist_sweep_counts"):
        return f"{name}: no sweep counts in this package"
    cl, pr = st.clusters, st.pairs
    c = lj.ilist_sweep_counts(cl.xc, cl.yc, cl.zc, pr.bijlist, pr.nji, sim.ishare,
                              cutsq, buckets=(sim.buckets, pr.bcrows))
    return (f"{name} sweep counts (bucketed lists, chunk {lj.SWEEP_CHUNK}): listed "
            f"{int(c['listed'].sum())}, inside {int(c['inside'].sum())}; warp steps: "
            f"sweep A {c['warp_sweep_a']}, sweep B {c['warp_sweep_b']}, branch "
            f"{c['warp_branch']}; efficiency {c['efficiency']:.4f}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probes.ilist needs a CUDA card")
    import chip_smoke
    from mdbench_tpu_torch import _build

    variants = [("this", _build.SRC_DIR), *((d, Path(d)) for d in argv)]
    smi = card_line()
    for name, src in variants:  # build every library before the runs
        _build.load(src)
        for kernel in ("lj_cluster_ilist_kernel", "eam_ilist_kernel"):
            for line in chip_smoke.kernel_ptxas_lines(kernel, src):
                print(f"{name}: {line}")
    _build.load(_build.SRC_DIR)
    (lj_sim, lj_st), (eam_sim, eam_st) = final_states()
    print(f"LJ buckets {lj_sim.buckets}, EAM buckets {eam_sim.buckets}; on {smi}",
          flush=True)
    print(sweep_line("LJ", lj_sim, lj_st, lj_sim.params.cutforce**2))
    print(sweep_line("EAM", eam_sim, eam_st, eam_sim.params.cutforce**2), flush=True)
    calls = {dtype: {**lj_calls(lj_sim, lj_st, dtype), **eam_calls(eam_sim, eam_st, dtype)}
             for dtype in (torch.float32, torch.float64)}
    order = variants + variants[::-1] if len(variants) > 1 else variants
    for name, src in order:
        _build.load(src)
        for dtype, fns in calls.items():
            for kernel, fn in fns.items():
                out = fn()
                ms, ms_dev = event_ms(fn, REPS), graph_ms(fn, REPS)
                print(f"{name} {str(dtype)[6:]} {kernel}: {ms:.4f} ms back to back, "
                      f"{ms_dev:.4f} ms on the device; bits {bits(out)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
