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

`run_bench_eam` runs the cluster EAM workload of tools/r3_eamc.py on the
card (the same 32^3 cells, with initEam's overrides: 131,072 atoms,
cutoff of the potential file, 60 steps) and applies no gate.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def load_check_golden():
    """check_golden from the repository's root bench.py (loaded by path;
    that module imports nothing of jax at module level)."""
    path = Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("_mdbench_root_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.check_golden


def run_bench(repeats: int = 3, chain: int = 3, kernel: str = "auto"):
    """The benchmark run on the CUDA card, gated on the golden trace, with
    the force kernel `kernel` ("auto": the exact-list kernel; "pallas":
    the group-window kernel). Returns (sim, result, atom-updates per
    second)."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation

    check_golden = load_check_golden()
    params = Params(precision="sp", scheme="cluster", kernel=kernel,
                    dense_thermo=False)
    sim = ClusterSimulation(params, device="cuda")
    out = sim.run(repeats=repeats, chain=chain)
    check_golden(out.temps, params.reneigh_every)
    return sim, out, sim.natoms * params.ntimes / out.total_time


def run_bench_eam(eam_file: str, precision: str = "sp", repeats: int = 3,
                  chain: int = 3):
    """The cluster EAM run on the CUDA card with the potential `eam_file`.
    Returns (sim, result, atom-updates per second)."""
    from mdbench_tpu_torch.config import FF_EAM, Params
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation

    params = Params(precision=precision, scheme="cluster", dense_thermo=False,
                    force_field=FF_EAM, eam_file=eam_file, ntimes=60)
    sim = ClusterSimulation(params, device="cuda")
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
