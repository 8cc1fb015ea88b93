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
     reference's temperature trace; the kernel's launch count over that
     run must cover every force evaluation of it;
  5. small input: a jittered 8^3 box in float64, step-0 forces and a
     40-step temperature trace with both rebuild kinds, card against the
     CPU plain path;
  6. kernel at the main path's shapes: the run's final 131k planes and
     lists, kernel against plain version (error, median times);
  7. EAM kernels: the two EAM passes (density, force) against their plain
     torch versions on the same random lists plus a random fp plane,
     float32 (<= 1e-5 of max |value|) and float64 (<= 1e-12), share 1,
     2, 4; all-padding units get exactly zero density and force;
  8. EAM main path: the cluster EAM run of run_bench_eam (131,072 atoms,
     60 SP steps) on the stand-in potential below; both EAM kernels'
     launch counts must cover every force evaluation of it; then the same
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
     0), float32 (<= 1e-5 of max |f|) and float64 (<= 1e-12);
 12. group-window main path: run_bench(kernel="pallas"), the 131,072-atom
     200-step SP run on group lists with tile windows, gated on the C
     reference's temperature trace; the group-window kernel's launches
     must cover every force evaluation and the exact-list kernel must not
     launch; the final state's window counters (stats.py);
 13. group-window small input: a jittered 8^3 box in float64, card
     against the CPU plain path (step-0 forces <= 1e-10, 40-step
     temperatures <= 1e-9, both rebuild kinds) for kernel="pallas", for
     kernel="pallas" with the prune every 3 steps, and for the Newton
     half lists (half_neigh=1, whose index_add_ sums with atomics on the
     card: ~1e-16 relative per sum in float64, so the same limits hold);
 14. group-window kernel at the main path's shapes: phase 12's final
     planes, lists and windows (error, median times, window pairs);
 15. the cluster stub (run_cluster_stub: 65,536 atoms, 76 j16 per group
     list, 200 steps) for seq, fix and rand: the kernel launches every
     step; its first force against the plain version (float32: the
     stub's geometry overflows some forces to inf or NaN, which must sit
     where the plain version has them; the finite ones <= 1e-5 of the
     largest); the kernel's median time on the stub's planes.

Every kernel count is set to 0 just before each main path (phases 4, 8
and 12) and read just after it. Then it prints a JSON line of the
kernels, nvidia-smi's line, and {"ok": true, "device": {...}} as the last
line; the script's wall time goes to standard error.
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
# SP against DP temperatures of the EAM run (tools/r3_eamc.py GOLDEN_TOL)
EAM_SP_TOL = {20: 2e-3, 40: 1e-2, 60: 3e-2}


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
    """Device time per call: CUDA events around `reps` back-to-back
    calls (so the host's launch gaps hide behind queued work), median
    over `batches`."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


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


def reset_counts(lj, ec) -> None:
    """Every kernel's launch count to 0."""
    lj.LAUNCHES = 0
    lj.STREAM_LAUNCHES = 0
    for name in ec.LAUNCHES:
        ec.LAUNCHES[name] = 0


def run_eam_phases(torch, dev, smi: str, ec) -> list:
    """Phases 7-10 (the cluster EAM path). Returns the kernels' JSON rows."""
    from mdbench_tpu_torch import _build
    from mdbench_tpu_torch.bench import run_bench_eam
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation
    from mdbench_tpu_torch.models.eam_tables import (
        apply_eam_overrides,
        fit_eam_poly,
        load_eam,
    )
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
    from mdbench_tpu_torch.ops.eam import EamDevice

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

    # 8. EAM main path at full width; count the kernels' launches in it
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
          f"list_cap {sim.list_cap}, grows {sim.grows or 'none'}")
    print(f"EAM main path: TOTAL {out.total_time:.6f} s per run, {rate:.6e} "
          f"atom-updates/s, run() wall {wall:.2f} s, on {smi}")
    print(f"EAM main path: kernel launches {launches} (each >= {need} force "
          f"evaluations); K1 launches {lj.LAUNCHES}", flush=True)
    for name, n in launches.items():
        if n < need:
            fail(f"the EAM main path launched {name} {n} times, fewer than "
                 f"its {need} force evaluations")
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
            err, rel = check(f"{name} at 131k", kern(), plain(), dtype)
            ms = median_ms(torch, kern, 50)
            plain_ms = median_ms(torch, plain, 5)
            print(f"{name} at 131k ({str(dtype)[6:]}, {pr.ijlist.shape[0]} units x "
                  f"icap {pr.ijlist.shape[1]}, share {share}): max abs err {err:.3e}, "
                  f"rel {rel:.3e} (tol {tol_of(torch, dtype):.0e}); median kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms on {smi}", flush=True)
            if dtype == torch.float32:
                rows[name] = {**EAM_KERNELS[name], "launches": launches[name],
                              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return [rows[name] for name in EAM_KERNELS]


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


def run_group_phases(torch, dev, smi: str, ec) -> dict:
    """Phases 11-15 (the group-window path). Returns the kernel's JSON
    row."""
    from mdbench_tpu_torch.bench import run_bench
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import GROUP, ClusterSimulation
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import lj_cluster as lj
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

    # 12. the group-window main path; count the kernels' launches in it
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    sim, out, rate = run_bench(repeats=REPEATS, chain=CHAIN, kernel="pallas")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k1 = lj.STREAM_LAUNCHES, lj.LAUNCHES
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
          f"evaluations); exact-list kernel launches {k1}; EAM {dict(ec.LAUNCHES)}")
    print(f"group main path: final-state counters {cs}", flush=True)
    if launches < need:
        fail(f"the group main path launched the group kernel {launches} times, "
             f"fewer than its {need} force evaluations")
    if k1 or any(ec.LAUNCHES.values()):
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

        err, rel = rel_err(torch, kern(), plain())
        ms = median_ms(torch, kern, 50)
        plain_ms = median_ms(torch, plain, 5)
        res[dtype] = (err, ms, plain_ms)
        print(f"group kernel at 131k ({str(dtype)[6:]}, {pr.jlist.shape[0]} groups x "
              f"L {pr.jlist.shape[1]}, {cs['padded_pairs']} window pairs = "
              f"{cs['padded_pairs'] / (ms * 1e-3):.4e} pairs/s): max abs err "
              f"{err:.3e}, rel {rel:.3e} (tol {tol_of(torch, dtype):.0e}); median "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms on {smi}", flush=True)
        if not rel <= tol_of(torch, dtype):
            fail(f"group kernel disagrees with its plain version at 131k ({dtype})")

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

    err, ms, plain_ms = res[torch.float32]
    return {**STREAM_KERNEL, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


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
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.ops import eam_cluster as ec
    from mdbench_tpu_torch.ops import lj_cluster as lj

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

    # 4. main path: the benchmark run; count the kernel's launches in it
    reset_counts(lj, ec)
    t0 = time.perf_counter()
    sim, out, rate = run_bench(repeats=REPEATS, chain=CHAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lj.LAUNCHES
    p = sim.params
    runs = 1 + REPEATS * CHAIN  # the un-timed checked run + the timed ones
    need = runs * (p.ntimes + 1)  # initial state's force + one per step
    print(f"main path: {sim.natoms} atoms, {p.ntimes} steps, {p.precision}, "
          f"n_clusters_pad {sim.n_clusters_pad}, icap {sim.icap}, "
          f"ghost_cap {sim.ghost_cap}, list_cap {sim.list_cap}, grows {sim.grows or 'none'}")
    print(f"main path: golden gate passed; TOTAL {out.total_time:.6f} s per run, "
          f"{rate:.6e} atom-updates/s, run() wall {wall:.2f} s")
    print(f"main path: kernel launches {launches} (>= {need} force evaluations)",
          flush=True)
    if launches < need:
        fail(f"the main path launched the kernel {launches} times, fewer than "
             f"its {need} force evaluations")
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
    res = {}
    for dtype in (torch.float32, torch.float64):
        planes = [q.to(dtype) for q in (cl.xc, cl.yc, cl.zc)]

        def kern():
            return lj.lj_cluster_force_ilist(
                *planes, pr.ijlist, pr.nji, npad, *cut, share=sim.ishare)

        def plain():
            return lj.lj_cluster_force_ilist_ref(
                *planes, pr.ijlist, npad, *cut, share=sim.ishare)

        err, rel = rel_err(torch, kern(), plain())
        ms = median_ms(torch, kern, 50)
        plain_ms = median_ms(torch, plain, 5)
        res[dtype] = (err, ms, plain_ms)
        padded = npad * 8 * pr.ijlist.shape[1] * 16
        print(f"kernel at 131k ({str(dtype)[6:]}, {pr.ijlist.shape[0]} units x icap "
              f"{pr.ijlist.shape[1]}, share {sim.ishare}, {padded} padded pairs = "
              f"{padded / (ms * 1e-3):.4e} pairs/s): max abs err {err:.3e}, "
              f"rel {rel:.3e} (tol {tol_of(torch, dtype):.0e}); median kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms on {smi}", flush=True)
        if not rel <= tol_of(torch, dtype):
            fail(f"kernel disagrees with its plain version at 131k ({dtype})")

    # 7-10. the cluster EAM path
    eam_rows = run_eam_phases(torch, dev, smi, ec)

    # 11-15. the group-window path
    stream_row = run_group_phases(torch, dev, smi, ec)

    err, ms, plain_ms = res[torch.float32]
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
    }, *eam_rows, stream_row]}))
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
