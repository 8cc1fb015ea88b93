"""Headline benchmark of the port on one CUDA card: the reference's default
workload — Cu-like FCC 32x32x32 cells = 131,072 atoms, LJ sigma=eps=1.0,
200 steps, cutoff 2.5, skin 0.3, reneighbor every 20 — in single
precision on the cluster scheme, gated on the C reference's temperature
trace (`check_golden` of the repository's bench.py).

Metric: atom-updates per second = Natoms * ntimes / TOTAL (reference:
src/verletlist/main.c:337-338), TOTAL the median of 3 timed regions of 3
chained runs, fenced with torch.cuda.synchronize().

    python -m mdbench_tpu_torch.bench

Prints exactly one JSON line.

`run_bench_eam` runs the EAM workload of tools/r3_eamc.py on the card
(the same 32^3 cells, with initEam's overrides: 131,072 atoms, cutoff of
the potential file, 60 steps), on the cluster scheme or, with
scheme="verlet", on the verlet scheme's per-atom lists, and applies no
gate.

`run_bench_verlet` runs the same LJ workload on the verlet scheme
(tools/r4_vbench.py's run: 16-atom row lists, K1 or K1b on the card),
gated on the same golden trace.

`run_bench_domain` runs the LJ workload on a domain engine over an
in-process mesh on the one card (the verlet scheme on `ndev` slabs,
parallel/verlet_domain.DomainSimulation, or with mesh=(px, py) on
pencils, parallel/verlet_domain2d.Domain2DSimulation, or with
mesh=(px, py, pz) on bricks, parallel/verlet_domain3d.Domain3DSimulation;
with scheme="cluster" the cluster scheme on `ndev` slabs,
parallel/cluster_domain.ClusterDomainSimulation), gated on the same
golden trace.

`run_bench_scale` runs tools/r3_scale.py's workload on the port: the
FCC box of nx^3 cells (64: 1,048,576 atoms; 136: 10,061,824, the
multi-chip target of BASELINE.json configs[4]) for ntimes steps, LJ or
verlet EAM, on the single engine of either scheme or on `ndev` verlet
slabs of an in-process mesh on the one card. No golden trace exists at
these sizes: the caller gates the run's trace with `check_trace`
against a DP run of the same box (or, for slabs, the single engine's).

`run_bench_file` runs the same LJ workload from an atom file
(`Params(input_file=...)`: positions, velocities, box and types of the
file; a file with more than one type runs the typed force with the
EXPLICIT_TYPES tables, or with `tables`) and applies no gate either.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def root_bench():
    """The repository's root bench.py, loaded by path (that module imports
    nothing of jax at module level): check_golden and GOLDEN_TEMP_131K."""
    path = Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("_mdbench_root_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_bench(repeats: int = 3, chain: int = 3, kernel: str = "auto",
              derive_bf16: bool = False):
    """The benchmark run on the CUDA card, gated on the golden trace, with
    the force kernel `kernel` ("auto": the exact-list kernel; "pallas":
    the group-window kernel) and Params.derive_bf16 (the exact lists
    derived in bfloat16). Returns (sim, result, atom-updates per
    second)."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation

    check_golden = root_bench().check_golden
    params = Params(precision="sp", scheme="cluster", kernel=kernel,
                    dense_thermo=False, derive_bf16=derive_bf16)
    sim = ClusterSimulation(params, device="cuda")
    out = sim.run(repeats=repeats, chain=chain)
    check_golden(out.temps, params.reneigh_every)
    return sim, out, sim.natoms * params.ntimes / out.total_time


def run_bench_verlet(repeats: int = 3, chain: int = 3, kernel: str = "auto"):
    """The benchmark run on the verlet scheme on the CUDA card, gated on
    the golden trace, with the verlet force path `kernel` ("auto" or
    "rowlist": the row lists and the exact-list kernels; "xla": the
    planar per-atom force). Returns (sim, result, atom-updates per
    second)."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine import Simulation

    check_golden = root_bench().check_golden
    params = Params(precision="sp", scheme="verlet", kernel=kernel,
                    dense_thermo=False)
    sim = Simulation(params, device="cuda")
    out = sim.run(repeats=repeats, chain=chain)
    check_golden(out.temps, params.reneigh_every)
    return sim, out, sim.natoms * params.ntimes / out.total_time


def run_bench_domain(ndev: int = 1, kernel: str = "auto", repeats: int = 3,
                     chain: int = 3, scheme: str = "verlet", mesh=None):
    """The benchmark run on a domain engine: an in-process mesh on the CUDA
    card, measured as run_bench and gated on the golden trace. scheme
    "verlet": `ndev` slabs of the verlet slab engine, or with `mesh` (px,
    py) the pencil engine, (px, py, pz) the brick engine (each the row
    lists with K1, or K1b once the melt calibration plans buckets, for
    "auto"/"rowlist"; the planar force for "xla"); "cluster": `ndev` slabs
    of the cluster slab engine with the force kernel `kernel` ("auto": the
    exact lists, K1, or K1b after the plan; "pallas": the group windows,
    K4). Returns (sim, result, atom-updates per second)."""
    from mdbench_tpu_torch.config import Params

    check_golden = root_bench().check_golden
    params = Params(precision="sp", scheme=scheme, kernel=kernel, dense_thermo=False)
    if mesh is not None and (scheme != "verlet" or len(mesh) not in (2, 3)):
        raise ValueError(f"mesh={mesh!r}: the verlet scheme's pencils (px, py) or "
                         "bricks (px, py, pz)")
    if scheme == "cluster":
        from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation

        sim = ClusterDomainSimulation(params, ndev=ndev, device="cuda")
    elif mesh is None:
        from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation

        sim = DomainSimulation(params, ndev=ndev, device="cuda")
    elif len(mesh) == 2:
        from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation

        sim = Domain2DSimulation(params, *mesh, device="cuda")
    else:
        from mdbench_tpu_torch.parallel.verlet_domain3d import Domain3DSimulation

        sim = Domain3DSimulation(params, *mesh, device="cuda")
    out = sim.run(repeats=repeats, chain=chain)
    check_golden(out.temps, params.reneigh_every)
    return sim, out, sim.natoms * params.ntimes / out.total_time


def run_bench_eam(eam_file: str, precision: str = "sp", repeats: int = 3,
                  chain: int = 3, scheme: str = "cluster", derive_bf16: bool = False):
    """The EAM run on the CUDA card with the potential `eam_file` on
    `scheme` ("cluster": K2b/K3b after the bucket plan; "verlet": K5 then
    K6, the passes of ops/eam.py), with Params.derive_bf16 (the cluster
    scheme's SP runs derive their exact lists in bfloat16). Returns (sim,
    result, atom-updates per second)."""
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.engine import Simulation
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation

    params = Params(precision=precision, scheme=scheme, dense_thermo=False,
                    force_field=FF_EAM, eam_file=eam_file, ntimes=60,
                    derive_bf16=derive_bf16)
    engine = ClusterSimulation if scheme == "cluster" else Simulation
    sim = engine(params, device="cuda")
    out = sim.run(repeats=repeats, chain=chain)
    return sim, out, sim.natoms * params.ntimes / out.total_time


def run_bench_scale(nx=64, ntimes: int = 40, scheme: str = "cluster",
                    kernel: str = "auto", precision: str = "sp",
                    force_field: str = "lj", eam_file=None, eam_eval: str = "auto",
                    ndev=None, repeats: int = 1, chain: int = 1, device="cuda"):
    """The scale run (module docstring) on `device` ("cpu" runs the plain
    path): `nx` cells on each side, or (nx, ny, nz); `force_field` "lj"
    or "eam" (with `eam_file`, initEam's overrides applied, and
    `eam_eval` as Params takes it); `ndev` None for the single engine of
    `scheme` (engine.Simulation or engine_cluster.ClusterSimulation), or
    the number of verlet slabs (parallel/verlet_domain.DomainSimulation).
    Measured as run_bench with `repeats` regions of `chain` runs; no
    gate. Sets sim.construct_time, the engine's construction seconds
    (lattice, host sort, upload); the engine's setup_time holds run()'s
    set-up. Returns (sim, result, atom-updates per second, peak bytes):
    torch.cuda.max_memory_allocated over construction and run() after a
    reset, None off the card."""
    import time

    import torch

    from mdbench_tpu_torch.config import FF_EAM, FF_LJ, Params

    dims = (nx,) * 3 if isinstance(nx, int) else tuple(nx)
    ff = {"lj": FF_LJ, "eam": FF_EAM}[force_field]
    if ff == FF_EAM and not eam_file:
        raise ValueError("force_field='eam' needs eam_file")
    if ndev is not None and scheme != "verlet":
        raise ValueError("ndev runs the verlet slab engine: scheme='verlet'")
    params = Params(precision=precision, scheme=scheme, kernel=kernel,
                    dense_thermo=False, nx=dims[0], ny=dims[1], nz=dims[2],
                    ntimes=ntimes, force_field=ff, eam_file=eam_file,
                    eam_eval=eam_eval)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if ndev is not None:
        from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation

        sim = DomainSimulation(params, ndev=ndev, device=device)
    elif scheme == "cluster":
        from mdbench_tpu_torch.engine_cluster import ClusterSimulation

        sim = ClusterSimulation(params, device=device)
    else:
        from mdbench_tpu_torch.engine import Simulation

        sim = Simulation(params, device=device)
    if on_card:
        torch.cuda.synchronize(device)
    sim.construct_time = time.perf_counter() - t0
    out = sim.run(repeats=repeats, chain=chain)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    return sim, out, sim.natoms * ntimes / out.total_time, peak


def check_trace(temps, ref_temps, steps, tols) -> None:
    """Gate a run's temperatures on a reference trace of the same box (an
    SP run on a DP run, slabs on the single engine): at each step of
    `steps` (1-based) the relative difference must be below the matching
    entry of `tols`, or SystemExit names the step, both temperatures and
    the difference (check_golden's words)."""
    for step, tol in zip(steps, tols, strict=True):
        t, t_ref = float(temps[step - 1]), float(ref_temps[step - 1])
        rel = abs(t - t_ref) / abs(t_ref)
        if not rel < tol:
            raise SystemExit(
                f"TRACE GATE FAILED at step {step}: temp {t:.6e} vs "
                f"reference {t_ref:.6e} (rel {rel:.2e} > tol {tol:.0e}) — "
                "refusing to report a benchmark score for a wrong "
                "trajectory"
            )


def run_bench_file(input_file: str, precision: str = "sp", kernel: str = "auto",
                   tables=None, repeats: int = 3, chain: int = 3):
    """The cluster LJ run of the atom file `input_file` on the CUDA card,
    with the force kernel `kernel` and, on a typed file, the type tables
    `tables` ((eps, sig6, cutsq), each (T, T); None for the defaults).
    Returns (sim, result, atom-updates per second)."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation

    params = Params(precision=precision, scheme="cluster", kernel=kernel,
                    dense_thermo=False, input_file=input_file)
    sim = ClusterSimulation(params, device="cuda", tables=tables)
    out = sim.run(repeats=repeats, chain=chain)
    return sim, out, sim.natoms * params.ntimes / out.total_time


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mdbench_tpu_torch.bench needs a CUDA device", file=sys.stderr)
        return 1
    _sim, _out, rate = run_bench()
    print(json.dumps({
        "metric": "atom_updates_per_second",
        "value": round(rate),
        "unit": "atom-updates/s",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
