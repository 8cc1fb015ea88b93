"""One run of one cell: set-up, the window (or the traced window), the
judge, and the result line. It takes the device as an argument, so the
tests drive it on the CPU; run.py adds the command line, the card checks
and the import check.

Everything that belongs to one configuration, cell or metric is a file
found by name: `BENCHMARK.json` names the cell, its configuration file and
its metrics; `workloads/<cell>.json` holds the cell's traffic (the scheme,
the force kernel, the runs traced, the sampled run) and its limits;
`e2e/<metric>.py` and `metrics/<metric>.py` each hold a `read(measure)`
that returns the metric's value, or None where it finds nothing to read.
A per-layer metric that reads the timed window's run times says so with
`WINDOW = True`; a traced run times the window only for such a metric.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench import devtrace
from portbench.engines import Engine
from portbench.reference import md
from portbench.reference.golden import GOLDEN_TEMP
from portbench.reference.judge import judge
from portbench.reference.lattice import box_lengths, fcc_atoms
from portbench.reference.peaks import PEAKS

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mdbench_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules(names) -> list:
    """The FORBIDDEN top-level names among module names (the part before
    the first dot, compared whole: `mdbench_tpu_torch` is not
    `mdbench_tpu`)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict  # the configuration file
    work: dict  # the workload file
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of a BENCHMARK.json, with its files read."""
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    work = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, entry["chips"], cfg, work, e2e, per_layer)


def metric(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str):
    """`read` of portbench/<kind>/<name>.py."""
    return metric(kind, name).read


@dataclasses.dataclass
class Measure:
    """What the metric readers read."""
    cfg: dict
    natoms: int
    steps: int  # steps a run
    setup_s: float
    run_times: list  # host seconds of each run of the window (none if untimed)
    window_s: float  # host seconds from the window's start to its last run's end
    trace: Optional[devtrace.DeviceTrace] = None  # of `traced_runs` runs
    traced_runs: int = 0
    syncs_per_run: Optional[int] = None
    pairs: Optional[tuple] = None  # ordered pairs within (cutforce + skin, cutforce)
    peaks: Optional[dict] = None


def count_syncs(fn):
    """(fn(), host synchronisations of the stream in it), counted by
    torch.cuda's sync debug mode (one warning each)."""
    n = 0

    def note(message, *_args, **_kw):
        nonlocal n
        if "called a synchronizing CUDA operation" in str(message):
            n += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return result, n


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_window(eng, seconds: float, sample_run: int, device):
    """Runs back to back until `seconds` have passed. Returns (thermo of
    each run, run seconds, window seconds, the sampled run's outputs, its
    index): the run `sample_run`, or the last if fewer ran."""
    thermo, times, sample = [], [], None
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        thermo.append(eng.run())
        _sync(device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if len(times) - 1 == sample_run:
            sample = eng.outputs()
        if t1 - start >= seconds:
            break
    if sample is None:
        sample, sample_run = eng.outputs(), len(times) - 1
    return thermo, times, t1 - start, sample, sample_run


def traced_runs(eng, runs: int, device):
    """`runs` runs under the profiler, then one more counting its host
    synchronisations. Returns (thermo of each, DeviceTrace, syncs)."""
    def body():
        out = []
        for _ in range(runs):
            out.append(eng.run())
            _sync(device)
        return out

    thermo, trace = devtrace.capture(body)
    extra, syncs = count_syncs(eng.run)
    return thermo + [extra], trace, syncs


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of `cell`; returns the result line's object. `t_start` is
    the process's start on the perf_counter clock. With `trace`, the
    workload's traced runs and a run counting host synchronisations follow
    the window, which is timed only where a per-layer metric of the cell
    reads it; every run is judged."""
    cfg, work = cell.cfg, cell.work
    device = torch.device(device)
    x0, v0 = fcc_atoms(cfg, seed)
    natoms, steps = x0.shape[0], cfg["ntimes"]
    eng = Engine(cfg, work, x0, v0, device)
    eng.run()  # warm-up: the kernel library, calibrations, any grow
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name} seed {seed}: {natoms} atoms, set-up {setup_s:.3f} s")
    thermo, times, window_s, sample, tr, syncs = [], [], 0.0, None, None, None
    if not trace or any(getattr(metric("metrics", m["name"]), "WINDOW", False)
                        for m in cell.per_layer):
        sample_run = int(np.random.default_rng(seed).integers(work["sample_runs"]))
        thermo, times, window_s, sample, sample_run = timed_window(
            eng, seconds, sample_run, device)
        log(f"{len(times)} runs in {window_s:.3f} s; run s min {min(times):.4f} "
            f"median {float(np.median(times)):.4f} max {max(times):.4f}")
        log("run s: " + " ".join(f"{t:.3f}" for t in times))
    if trace:  # after the window, which the profiler would slow
        more, tr, syncs = traced_runs(eng, work["traced_runs"], device)
        thermo += more
        if sample is None:
            sample, sample_run = eng.outputs(), len(thermo) - 1
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(eng.notes())
    eng.release()
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        log(f"card: {power_limit()}")

    t_ref = time.perf_counter()
    checks, failed = judge(cfg, work["limits"], x0, v0, thermo, sample, sample_run, device)
    log(f"judged in {time.perf_counter() - t_ref:.3f} s")
    golden = GOLDEN_TEMP.get(cfg["name"]) if seed == 0 else None
    if golden:
        t = thermo[0][0]
        log("golden T rel gap by step: " + ", ".join(
            f"{s}: {abs(t[s - 1] - g) / g:.3e}" for s, g in golden.items()))

    measure = Measure(cfg=cfg, natoms=natoms, steps=steps, setup_s=setup_s,
                      run_times=times, window_s=window_s, trace=tr,
                      traced_runs=work["traced_runs"] if trace else 0,
                      syncs_per_run=syncs)
    if trace:
        r_out, r_in = cfg["cutforce"] + cfg["skin"], cfg["cutforce"]
        box = torch.tensor(box_lengths(cfg), dtype=torch.float64, device=device)
        at0 = md.pair_counts(torch.tensor(x0, device=device), box, r_out, r_in)
        at_end = md.pair_counts(sample.x.double(), box, r_out, r_in)
        measure.pairs = tuple(0.5 * (a + b) for a, b in zip(at0, at_end))
        if device.type == "cuda":
            measure.peaks = PEAKS.get(torch.cuda.get_device_name(device))
        log(f"ordered pairs within {r_out}, {r_in}: t=0 {at0}, last {at_end}; "
            f"device ops without a launch in the trace: {tr.unlinked}")
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader("metrics" if trace else "e2e", m["name"])(measure)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    result = {}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = devtrace.breakdown(tr)
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": len(thermo), "failed": failed,
           "metrics": metrics, "device": dev, **result}
    out["checks"] = {k: {"value": (v if np.isfinite(v) else None), "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def check_lines(result: dict) -> list:
    """One line for each number compared, beside its limit."""
    return [f"check {k}: {c['value']} limit {c['limit']} "
            f"{'ok' if c['value'] is not None and c['value'] <= c['limit'] else 'FAILED'}"
            for k, c in result["checks"].items()] + [f"correct: {result['correct']}"]

