"""The trace reader and the per-layer arithmetic on a synthetic trace."""

import pytest

from portbench import devtrace, harness
from portbench.reference.work import force_bytes, force_ops

PEAKS = {"float32": 67e12, "float64": 34e12, "bytes_per_s": 3.35e12}


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A 1000 us window: a force span launching kernel A (100 us), a
    rebuild launching kernel B (300 us) and a copy, a kernel launched
    before the window, and host ops in the gaps."""
    return [
        ev("user_annotation", devtrace.WINDOW_SPAN, 0, 1000),
        ev("user_annotation", "force", 10, 30),
        ev("cpu_op", "aten::empty", 12, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        ev("kernel", "A", 50, 100, tid=7, corr=1),
        ev("cpu_op", "aten::nonzero", 60, 300),
        ev("cuda_runtime", "cudaLaunchKernel", 70, 5, corr=2),
        ev("kernel", "B", 200, 300, tid=7, corr=2),
        ev("cuda_runtime", "cudaMemcpyAsync", 380, 5, corr=3),
        ev("gpu_memcpy", "Memcpy DtoH", 600, 50, tid=7, corr=3),
        ev("kernel", "C", -500, 100, tid=7, corr=9),
        ev("kernel", "D", 900, 50, tid=7, corr=99),  # its launch is not in the trace
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 20, "id": 1},
    ]


def test_parse_busy_idle_and_gaps():
    tr = devtrace.parse(synthetic())
    assert tr.window == (0, 1000)
    assert [(o.name, o.in_force) for o in tr.ops] == [
        ("A", True), ("B", False), ("Memcpy DtoH", False), ("D", False)]
    assert tr.unlinked == 1
    assert tr.busy() == [[50, 150], [200, 500], [600, 650], [900, 950]]
    assert tr.busy_s() == pytest.approx(500e-6)
    assert tr.window_s == pytest.approx(1e-3)
    gaps = dict((name, sec) for sec, name in tr.gaps() if name != "python")
    assert gaps["aten::nonzero"] == pytest.approx(50e-6)  # 150-200, middle 175
    bd = devtrace.breakdown(tr)
    assert bd["device_ops"][0] == ["B", pytest.approx(300e-6)]
    assert len(bd["device_ops"]) == 4 and len(bd["idle_gaps"]) <= 10


def measure(trace):
    m = harness.Measure(cfg={"precision": "sp"}, natoms=1000, steps=10, setup_s=1.0,
                        run_times=[0.0005, 0.0005], window_s=1e-3, trace=trace,
                        traced_runs=2, syncs_per_run=7, pairs=(78000.0, 54000.0), peaks=PEAKS)
    return m


def test_layer_metrics_arithmetic():
    m = measure(devtrace.parse(synthetic()))
    read = lambda name: harness.reader("metrics", name)(m)  # noqa: E731
    assert read("force_device_ms") == pytest.approx(0.1 / 20)
    assert read("nonforce_device_ms") == pytest.approx((300 + 50 + 50) * 1e-3 / 20)
    assert read("device_idle_share") == pytest.approx(50.0)
    assert read("host_syncs_per_run") == 7
    ops = 8 * 78000 + 15 * 54000
    bound = max(ops / 67e12, force_bytes(1000, "sp") / 3.35e12)
    assert force_ops(m.pairs) == ops
    assert read("force_roofline") == pytest.approx(100 * bound / (100e-6 / 20))


def test_readers_find_nothing_without_a_trace():
    m = measure(None)
    for name in ("force_device_ms", "nonforce_device_ms", "device_idle_share",
                 "force_roofline"):
        assert harness.reader("metrics", name)(m) is None
    m = measure(devtrace.parse([e for e in synthetic() if e["name"] != "A"]))
    assert harness.reader("metrics", "force_roofline")(m) is None  # never 0


def test_end_to_end_arithmetic():
    m = harness.Measure(cfg={}, natoms=1000, steps=200, setup_s=3.5,
                        run_times=[0.1 * (i + 1) for i in range(20)], window_s=21.0)
    read = lambda name: harness.reader("e2e", name)(m)  # noqa: E731
    assert read("atom_updates_per_s") == pytest.approx(1000 * 200 * 20 / 21.0)
    assert read("setup_s") == 3.5
    p90 = harness.reader("metrics", "run_s_p90.host")(m)
    assert p90 == pytest.approx(1.89)  # (n + 1) * 0.9 = 18.9th value


def test_short_kernel_names():
    long = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast"
            "<at::native::CUDAFunctor_add<float> >(at::TensorIteratorBase&, at::native::"
            "CUDAFunctor_add<float> const&)::{lambda(int)#1}>(int, at::native::x)")
    assert devtrace.short_name(long) == (
        "elementwise_kernel<128, 2, gpu_kernel_impl_nocast<CUDAFunctor_add<float> >"
        "(at::TensorIteratorBase&, CUDAFunctor_add<float> const&)::{lambda(int)#1}>")
    ours = ("(anonymous namespace)::lj_cluster_ilist_kernel<float, false, ((anonymous "
            "namespace)::PairMath)1>(float const*, int, unit_map::Buckets, float)")
    assert devtrace.short_name(ours) == "lj_cluster_ilist_kernel<float, false, (PairMath)1>"
    assert devtrace.short_name("radixSortKVInPlace<2, -1, long>(x)") == (
        "radixSortKVInPlace<2, -1, long>")


def test_records_of_a_real_profile_on_the_host():
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(devtrace.WINDOW_SPAN):
            with torch.profiler.record_function("force"):
                torch.ones(64).sum()
    recs = devtrace.records(prof)
    tr = devtrace.parse(recs)
    names = {h[2] for h in tr.host}
    assert "force" in names and any(n.startswith("aten::") for n in names)
    assert tr.ops == [] and tr.window[1] > tr.window[0]
