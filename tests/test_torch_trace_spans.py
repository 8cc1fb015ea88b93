"""The engines' phase spans (tracing.region) on the CPU: an 8^3 box,
40 steps with lists every 20, one run(repeats=0) after the set-up run
under torch.profiler. Each span opens as often as the step loop says,
every top-level torch op of the run lies in a span but the run-level
reads, and outside a profiler region() builds nothing."""

import contextlib

import pytest
import torch

from mdbench_tpu_torch import tracing
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.engine_cluster import ClusterSimulation

torch.set_num_threads(1)

NTIMES, EVERY = 40, 20
SPANS = {"reneighbor", "reneighbor.sort", "reneighbor.halo", "reneighbor.rows",
         "reneighbor.prune", "reneighbor.buckets", "force", "integrate",
         "halo_update", "thermo"}
# run()'s reads of the overflow flag, the temperatures and the pressures
READS = {"aten::is_nonzero", "aten::item", "aten::_local_scalar_dense", "aten::to",
         "aten::detach", "aten::resolve_conj", "aten::resolve_neg"}


@pytest.fixture(scope="module")
def engines():
    """Each scheme's engine, built once and set up (its calibrations)."""
    built = {}

    def get(scheme):
        if scheme not in built:
            p = Params(nx=8, ny=8, nz=8, ntimes=NTIMES, reneigh_every=EVERY,
                       scheme=scheme)
            sim = (Simulation if scheme == "verlet" else ClusterSimulation)(
                p, device="cpu")
            sim.run(repeats=0)
            built[scheme] = sim
        return built[scheme]

    return get


@pytest.fixture(scope="module", params=["verlet", "cluster"])
def traced(request, engines):
    sim = engines(request.param)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim.run(repeats=0)
    return request.param, prof.events()


def ancestors(e):
    out, q = [], e.cpu_parent
    while q is not None:
        out.append(q.name)
        q = q.cpu_parent
    return out


def test_span_counts(traced):
    scheme, events = traced
    count = {n: sum(e.name == n for e in events) for n in SPANS}
    rebuilds = NTIMES // EVERY
    assert count["reneighbor"] == rebuilds + 1  # and the initial state's
    assert count["force"] == NTIMES + 1
    assert count["halo_update"] == NTIMES - rebuilds
    assert count["integrate"] == 2 * NTIMES
    assert count["thermo"] == NTIMES + 1  # and the run's gather
    assert count["reneighbor.halo"] >= rebuilds + 1
    assert count["reneighbor.rows"] == count["reneighbor.prune"] == rebuilds + 1
    for e in events:
        if e.name == "reneighbor.prune":
            assert e.cpu_parent.name == "reneighbor.rows"
        if e.name.startswith("reneighbor."):
            assert "reneighbor" in ancestors(e)


def test_every_op_of_the_run_lies_in_a_span(traced):
    scheme, events = traced
    loose = [e for e in events if e.name.startswith("aten::")
             and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))
             and not SPANS.intersection(ancestors(e))]
    last_span = max(e.time_range.end for e in events if e.name in SPANS)
    before = sorted(e.name for e in loose if e.time_range.start < last_span)
    after = {e.name for e in loose if e.time_range.start >= last_span}
    assert after and after <= READS
    if scheme == "verlet":
        assert before == ["aten::clone"]  # the initial state's velocities
    else:  # the per-run capacity checks and the initial flags' read
        assert set(before) <= READS | {"aten::max"} and "aten::max" in before


def test_region_off_builds_nothing(monkeypatch, engines):
    sim = engines("verlet")

    def refuse(*_a, **_k):
        raise AssertionError("a span object was built outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(contextlib, "ExitStack", refuse)
    assert tracing.region("force") is tracing.region("reneighbor.prune")
    r = sim.run(repeats=0)
    assert r.temps.shape == (NTIMES,) and (r.temps > 0).all()
