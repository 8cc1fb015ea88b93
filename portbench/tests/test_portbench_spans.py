"""The program's spans in a trace (portbench/spans.py) and the per-layer
metrics that read them, on a synthetic trace with nested spans."""

import pytest

from portbench import devtrace, harness, spans
from portbench.tests.test_portbench_trace import PEAKS, ev


def synthetic():
    """A 1000 us window of one step's phases: a rebuild (a sort, the rows
    with their prune and a set, a copy), a force, the integration, a halo
    update, the thermo, and a read of the host after every span. The
    prune's `cudaLaunchKernel` holds its own `cuLaunchKernel`."""
    return [
        ev("user_annotation", devtrace.WINDOW_SPAN, 0, 1000),
        ev("user_annotation", "reneighbor", 10, 290),
        ev("user_annotation", "reneighbor.sort", 12, 28),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        ev("kernel", "S", 100, 20, tid=7, corr=1),
        ev("user_annotation", "reneighbor.rows", 50, 150),
        ev("user_annotation", "reneighbor.prune", 60, 90),
        ev("cuda_runtime", "cudaLaunchKernel", 70, 5, corr=2),
        ev("cuda_driver", "cuLaunchKernel", 71, 2),
        ev("kernel", "P", 130, 100, tid=7, corr=2),
        ev("cuda_runtime", "cudaMemsetAsync", 160, 5, corr=3),
        ev("gpu_memset", "Memset (Device)", 240, 10, tid=7, corr=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 250, 5, corr=4),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 260, 20, tid=7, corr=4),
        ev("user_annotation", "force", 310, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 320, 5, corr=5),
        ev("kernel", "F", 350, 50, tid=7, corr=5),
        ev("user_annotation", "integrate", 400, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 405, 5, corr=6),
        ev("kernel", "I", 420, 10, tid=7, corr=6),
        ev("user_annotation", "halo_update", 430, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 432, 5, corr=7),
        ev("kernel", "H", 440, 5, tid=7, corr=7),
        ev("user_annotation", "thermo", 450, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 455, 5, corr=8),
        ev("kernel", "T", 470, 5, tid=7, corr=8),
        ev("cuda_runtime", "cudaMemcpyAsync", 800, 5, corr=9),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 810, 2, tid=7, corr=9),
        ev("cuda_runtime", "cudaStreamSynchronize", 806, 10),
    ]


def measure(events):
    return harness.Measure(cfg={"precision": "sp"}, natoms=1000, steps=10, setup_s=1.0,
                           run_times=[], window_s=1e-3, trace=devtrace.parse(events),
                           traced_runs=2, syncs_per_run=3, pairs=(78000.0, 54000.0),
                           peaks=PEAKS)


def read(name, m):
    return harness.reader("metrics", name)(m)


def test_launches_and_tie():
    tr = devtrace.parse(synthetic())
    assert spans.launches(tr) == [
        (20, "kernel"), (70, "kernel"), (160, "set"), (250, "copy"), (320, "kernel"),
        (405, "kernel"), (432, "kernel"), (455, "kernel"), (800, "copy")]
    tied = {op.name: t for op, t in spans.tie(tr)}
    assert tied == {"S": 20, "P": 70, "F": 320, "I": 405, "H": 432, "T": 455,
                    "Memset (Device)": 160, "Memcpy DtoD (Device -> Device)": 250,
                    "Memcpy DtoH (Device -> Pageable)": 800}
    for name, kind in (("cudaLaunchKernel_ptsz", "kernel"), ("cudaGraphLaunch", "graph"),
                       ("cudaMemcpyAsync", "copy"), ("cuMemsetD32Async", "set"),
                       ("cudaStreamSynchronize", None), ("aten::copy_", None)):
        assert spans.launch_kind(name) == kind


def test_open_spans_and_overlap():
    tr = devtrace.parse(synthetic())
    names = ("reneighbor", "reneighbor.rows", "reneighbor.prune", "force")
    assert spans.open_at(tr, 100, names) == ["reneighbor", "reneighbor.rows",
                                             "reneighbor.prune"]
    assert spans.open_at(tr, 170, names) == ["reneighbor", "reneighbor.rows"]
    assert spans.open_at(tr, 900, names) == []
    assert spans.overlap_us([[0, 20], [290, 320], [335, 400]], tr,
                            ("reneighbor", "force")) == pytest.approx(10 + 10 + 10 + 5)


def test_new_metrics_arithmetic():
    m = measure(synthetic())
    per_step = 1e-3 / 20  # us -> ms, over 10 steps x 2 traced runs
    assert read("rebuild_device_ms", m) == pytest.approx((20 + 100 + 10 + 20) * per_step)
    assert read("prune_device_ms", m) == pytest.approx(100 * per_step)
    assert read("step_device_ms", m) == pytest.approx((10 + 5 + 5) * per_step)
    # idle while the host is in reneighbor [10, 300]: 10-100, 120-130,
    # 230-240, 250-260, 280-300
    assert read("rebuild_idle_share", m) == pytest.approx(100 * 140 / 1000)
    assert read("device_idle_share", m) == pytest.approx(100 * (1000 - 222) / 1000)
    assert read("launches_per_step", m) == pytest.approx(9 / 20)
    # what no span holds: the read of the host after the run
    unspanned = (read("nonforce_device_ms", m) - read("rebuild_device_ms", m)
                 - read("step_device_ms", m))
    assert unspanned == pytest.approx(2 * per_step)


def test_old_metrics_read_the_same_beside_the_new_spans():
    """A trace with the program's new spans against the same trace with
    only the spans the program had before: the metrics that were there
    read the same, the new ones that need the new spans read nothing."""
    before = [e for e in synthetic() if e.get("cat") != "user_annotation"
              or e["name"] in (devtrace.WINDOW_SPAN, "force", "reneighbor")]
    new, old = measure(synthetic()), measure(before)
    for name in ("force_device_ms", "nonforce_device_ms", "device_idle_share",
                 "force_roofline", "host_syncs_per_run"):
        assert read(name, new) == read(name, old) and read(name, new) is not None
    assert devtrace.breakdown(new.trace)["device_ops"] == devtrace.breakdown(
        old.trace)["device_ops"]
    assert read("prune_device_ms", old) is None and read("step_device_ms", old) is None
    assert read("rebuild_device_ms", old) == read("rebuild_device_ms", new)


def test_new_metrics_find_nothing_they_cannot_tie():
    for name in ("rebuild_device_ms", "prune_device_ms", "step_device_ms",
                 "rebuild_idle_share", "launches_per_step"):
        m = measure(synthetic())
        m.trace = None
        assert read(name, m) is None
    # a device op whose launch the trace lacks: the pairing fails, so the
    # device times read nothing rather than a shifted tie
    m = measure([e for e in synthetic() if not (e["name"] == "cudaLaunchKernel"
                                                and e["ts"] == 405)])
    assert spans.tie(m.trace) is None
    assert read("rebuild_device_ms", m) is None and read("step_device_ms", m) is None
    # the device's clock a little early against the host's: still tied
    early = synthetic()
    for e in early:
        if e["name"] == "S":
            e["ts"] = 19.5
    assert [t for op, t in spans.tie(devtrace.parse(early)) if op.name == "S"] == [20]
    # so early that the first op falls before the window, which drops it:
    # the launches after it are still tied
    clipped = synthetic() + [ev("cuda_runtime", "cudaLaunchKernel", 5, 2, corr=10),
                             ev("kernel", "Z", -10, 5, tid=7, corr=10)]
    tr = devtrace.parse(clipped)
    assert "Z" not in {op.name for op in tr.ops} and len(spans.launches(tr)) == 10
    assert {op.name: t for op, t in spans.tie(tr)} == {
        op.name: t for op, t in spans.tie(devtrace.parse(synthetic()))}
    # an op lost inside the window: refused
    lost = [e for e in synthetic() if e["name"] != "I"]
    assert devtrace.parse(lost).unlinked == 0 and spans.tie(devtrace.parse(lost)) is None
    # launches out of order against the force's correlation: refused
    swapped = synthetic()
    for e in swapped:
        if e["name"] in ("F", "I"):
            e["ts"] = {"F": 420, "I": 350}[e["name"]]
    assert spans.tie(devtrace.parse(swapped)) is None
    # a graph queues many operations at one launch: refused
    graph = synthetic() + [ev("cuda_runtime", "cudaGraphLaunch", 900, 5)]
    assert spans.tie(devtrace.parse(graph)) is None


CHILDREN = ("sort", "halo", "rows", "prune", "buckets")


def test_idle_shares_by_span():
    m = measure(synthetic())
    # the device idles 0-100 and 120-130 inside the rebuild's first 200 us;
    # the sort [12, 40], the rows [50, 200], the prune [60, 150]
    want = {"sort": 28, "rows": 50 + 10, "prune": 40 + 10, "halo": None, "buckets": None}
    for child in CHILDREN:
        got = read(f"rebuild_idle_share.{child}", m)
        if want[child] is None:
            assert got is None
        else:
            assert got == pytest.approx(100 * want[child] / 1000)
            assert got <= read("rebuild_idle_share", m)
    # the device idles 400-420, 430-440, 445-470 in the integrate [400, 420],
    # the halo update [430, 440], the thermo [450, 470]; 310-340 in the force
    assert read("step_idle_share", m) == pytest.approx(100 * (20 + 10 + 20) / 1000)
    assert read("force_idle_share", m) == pytest.approx(100 * 30 / 1000)
    # the spans the program had before: no child to read, and nothing raises
    before = measure([e for e in synthetic() if e.get("cat") != "user_annotation"
                      or e["name"] in (devtrace.WINDOW_SPAN, "force", "reneighbor")])
    children = [f"rebuild_idle_share.{c}" for c in CHILDREN]
    for name in children + ["step_idle_share"]:
        assert read(name, before) is None
    assert read("force_idle_share", before) == read("force_idle_share", m)
    m.trace = None
    for name in children + ["step_idle_share", "force_idle_share"]:
        assert read(name, m) is None


def test_tie_says_why_it_refuses_once_a_trace(capsys):
    tr = devtrace.parse(synthetic())
    assert spans.tie(tr) is not None and capsys.readouterr().err == ""
    unlinked = devtrace.parse([e for e in synthetic() if not (
        e["name"] == "cudaLaunchKernel" and e["ts"] == 405)])
    graph = devtrace.parse(synthetic() + [ev("cuda_runtime", "cudaGraphLaunch", 900, 5)])
    swapped = synthetic()
    for e in swapped:
        if e["name"] in ("F", "I"):
            e["ts"] = {"F": 420, "I": 350}[e["name"]]
    for trace, why in ((unlinked, "1 device ops have no launch"),
                       (graph, "1 graph launches"),
                       (devtrace.parse(swapped), "0 runs of the 9 launches fit the 9 ops")):
        m = measure(synthetic())
        m.trace = trace
        for name in ("rebuild_device_ms", "prune_device_ms", "step_device_ms"):
            assert read(name, m) is None
        err = capsys.readouterr().err
        assert err.count("spans.tie:") == 1 and why in err


def test_program_regions_in_a_real_profile_on_the_host():
    import torch

    from mdbench_tpu_torch.tracing import region

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(devtrace.WINDOW_SPAN):
            with region("reneighbor"):
                with region("reneighbor.rows"):
                    with region("reneighbor.prune"):
                        torch.ones(64).sum()
            with region("integrate"):
                torch.ones(8).add_(1)
    tr = devtrace.parse(devtrace.records(prof))
    (p0, p1), = spans.intervals(tr, spans.PRUNE)
    (r0, r1), = spans.intervals(tr, spans.REBUILD)
    assert r0 <= p0 < p1 <= r1
    assert spans.open_at(tr, 0.5 * (p0 + p1), ("reneighbor", "reneighbor.rows",
                                                "reneighbor.prune", "integrate")) == [
        "reneighbor", "reneighbor.rows", "reneighbor.prune"]
    assert len(spans.intervals(tr, spans.STEP)) == 1
