"""BENCHMARK.json against the contract's shape, discovery by name, the
result line, and the import check."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = harness.find_cell(BENCH, name)
    assert cell.cfg["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert set(cell.work["limits"]) == {"thermo_rel", "pos_abs", "vel_rel", "force_rel"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "atom_updates_per_s"}
    assert cell.per_layer
    for m in cell.end_to_end:
        assert callable(harness.reader("e2e", m["name"]))
    for m in cell.per_layer:
        assert callable(harness.reader("metrics", m["name"]))


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A later cell and per-layer metric need files and entries, no edit."""
    (tmp_path / "portbench" / "workloads").mkdir(parents=True)
    (tmp_path / "portbench" / "configs").mkdir()
    shutil.copy(ROOT / "portbench/configs/lj_fcc_131k.json", tmp_path / "portbench/configs")
    work = json.loads((ROOT / "portbench/workloads/lj131k.verlet_rows.json").read_text())
    (tmp_path / "portbench/workloads/lj131k.new.json").write_text(
        json.dumps(dict(work, kernel="pallas")))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "lj131k.new", "config": "lj_fcc_131k",
                               "traffic": "new", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "only_new", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "atom_updates_per_s", "workloads": ["lj131k.new"]})
    cell = harness.find_cell(bench, "lj131k.new", root=tmp_path)
    assert cell.work["kernel"] == "pallas"
    assert "only_new" in [m["name"] for m in cell.per_layer]
    assert "run_s_p90.host" not in [m["name"] for m in cell.per_layer]
    assert "only_new" not in [m["name"] for m in harness.find_cell(bench, "lj131k.verlet_rows").per_layer]


def test_result_line_keys():
    cell = harness.find_cell(BENCH, "lj1m.verlet_rows")
    cell = cell._replace(cfg=dict(cell.cfg, nx=6, ny=6, nz=6, ntimes=20, name="tiny"))
    r = harness.run_cell(cell, 9, 1.5, False, "cpu", time.perf_counter())
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"atom_updates_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    lines = harness.check_lines(r)
    assert len(lines) == 5 and lines[-1] == "correct: True"


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["mdbench_tpu_torch", "mdbench_tpu_torch.ops",
                                      "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(["mdbench_tpu.ops.cluster", "jax", "jaxlib.xla_client",
                                      "flax.linen", "torch"]) == ["flax", "jax", "jaxlib",
                                                                  "mdbench_tpu"]


def test_the_run_imports_no_jax_and_no_jax_package():
    """A whole run of a cell (on the CPU, the card's look skipped) in a
    fresh process, then its sys.modules."""
    code = (
        "import sys, time, json; sys.path[0] = sys.argv[1]\n"
        "import portbench.run, portbench.control\n"
        "from portbench import harness\n"
        "bench = json.load(open(sys.argv[1] + '/BENCHMARK.json'))\n"
        "cell = harness.find_cell(bench, 'lj131k.verlet_rows')\n"
        "cell = cell._replace(cfg=dict(cell.cfg, nx=6, ny=6, nz=6, ntimes=20, name='t'))\n"
        "harness.run_cell(cell, 1, 0.2, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mdbench_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "mdbench_tpu"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "lj131k.verlet_rows", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.parametrize("name,window", [("lj131k.verlet_rows", True),
                                         ("lj1m.verlet_rows", False)])
def test_a_traced_run_times_the_window_only_for_a_metric_that_reads_it(
        monkeypatch, name, window):
    """The profiler and the sync count stood in for on the host: a traced
    run times the window where a per-layer metric of the cell reads its
    run times (WINDOW), and is judged on every run either way."""
    from portbench import devtrace

    def capture(fn):
        out = fn()
        return out, devtrace.DeviceTrace([devtrace.DeviceOp("k", 0.0, 5.0, True)],
                                         (0.0, 10.0), [], 0)

    monkeypatch.setattr(devtrace, "capture", capture)
    monkeypatch.setattr(harness, "count_syncs", lambda fn: (fn(), 4))
    cell = harness.find_cell(BENCH, name)
    cell = cell._replace(cfg=dict(cell.cfg, nx=6, ny=6, nz=6, ntimes=20, name="tiny"))
    r = harness.run_cell(cell, 11, 1.0, True, "cpu", time.perf_counter())
    traced = cell.work["traced_runs"] + 1
    assert r["correct"] and (r["attempted"] > traced) == window
    assert ("run_s_p90.host" in r["metrics"]) == window
    assert r["metrics"]["host_syncs_per_run"]["value"] == 4
    assert r["device"]["busy_s"] == pytest.approx(5e-6)
    assert "force_roofline" not in r["metrics"]  # no peaks for the host
