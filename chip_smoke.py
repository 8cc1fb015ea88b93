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
     lists and fp plane (error, median times).

Every kernel count is set to 0 just before each main path (phases 4 and
8) and read just after it. Then it prints a JSON line of the kernels,
nvidia-smi's line, and {"ok": true, "device": {...}} as the last line.
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


def reset_counts(lj, ec) -> None:
    """Every kernel's launch count to 0."""
    lj.LAUNCHES = 0
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


def main() -> int:
    import torch

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
        print(f"kernel at 131k ({str(dtype)[6:]}, {pr.ijlist.shape[0]} units x icap "
              f"{pr.ijlist.shape[1]}, share {sim.ishare}): max abs err {err:.3e}, "
              f"rel {rel:.3e} (tol {tol_of(torch, dtype):.0e}); median kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms on {smi}", flush=True)
        if not rel <= tol_of(torch, dtype):
            fail(f"kernel disagrees with its plain version at 131k ({dtype})")

    # 7-10. the cluster EAM path
    eam_rows = run_eam_phases(torch, dev, smi, ec)

    err, ms, plain_ms = res[torch.float32]
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms,
    }, *eam_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
