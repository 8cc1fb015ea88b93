"""The port's chunked run and its per-phase timing, on the CPU:
`run_chunked` (the callback's steps, the temperatures of an unchunked run,
the replay of a chunk that overflowed), `measure_phases` (two positive
finite times), and that a bucketed run of the port imports no jax.

run_chunked runs `_run_steps(chunk)` per chunk, so its rebuild cadence
counts from each chunk's start, as mdbench_tpu's does: the tests pick
cadences where that is run()'s, and then the trajectories agree to
rounding (rel 1e-12), or to rel 1e-9 across a replay, whose full rebuild
from the chunk's boundary sums the same pairs in another order."""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine_cluster import ClusterSimulation

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def test_run_chunked_steps_and_temperatures():
    """Counterpart of tests/test_aux.py:102-118: two chunks of 5 and a
    tail of 3 cover exactly 13 steps; the callback sees every boundary."""
    def mk():
        return Params(nx=3, ny=3, nz=3, kernel="xla", ntimes=13, scheme="cluster")

    steps, states = [], []

    def cb(st, step):
        steps.append(step)
        states.append(float(st.vxc.abs().sum()))

    out = ClusterSimulation(mk(), device="cpu").run_chunked(5, 2, cb, tail=3)
    assert steps == [0, 5, 10, 13]
    assert out.temps.shape == (13,) and out.press.shape == (13,)
    assert out.total_time > 0 and len(set(states)) == 4
    ref = ClusterSimulation(mk(), device="cpu").run(ntimes=13)
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)
    np.testing.assert_allclose(out.press, ref.press, rtol=1e-12)


@pytest.mark.parametrize("kernel", ["auto", "pallas"])
def test_run_chunked_matches_run_and_jax(kernel):
    """Chunks of one reneighbour interval each give run()'s trajectory on
    both force paths, and mdbench_tpu's run_chunked."""
    kw = dict(nx=4, ny=4, nz=4, ntimes=20, reneigh_every=5, resort_every=10,
              scheme="cluster", kernel=kernel)
    steps = []
    out = ClusterSimulation(Params(**kw), device="cpu").run_chunked(
        5, 4, lambda st, step: steps.append(step))
    assert steps == [0, 5, 10, 15, 20]
    ref = ClusterSimulation(Params(**kw), device="cpu").run()
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)
    if kernel == "auto":
        r_j = JSim(JParams(**{**kw, "kernel": "ilist"})).run()
        np.testing.assert_allclose(out.temps, r_j.temps, rtol=1e-9)


def test_run_chunked_replays_an_overflowed_chunk():
    """Counterpart of tests/test_aux.py:264-284: icap pinned at the cold
    lattice's longest list, a hot melt (temp 9.0) overflows it within a
    rebuild or two; the chunk is replayed from its boundary under a grown
    capacity, and the trajectory is the uninterrupted run's."""
    def mk():
        return Params(nx=8, ny=4, nz=4, ntimes=30, reneigh_every=10,
                      kernel="ilist", temp=9.0, scheme="cluster")

    oracle = ClusterSimulation(mk(), device="cpu").run()
    sim = ClusterSimulation(mk(), device="cpu")
    sim.icap = int(sim.initial_state().pairs.nji.max())
    icap0 = sim.icap
    steps = []
    out = sim.run_chunked(10, 3, lambda st, step: steps.append(step))
    assert sim.icap > icap0, "the replay never ran: no overflow"
    assert "ilist_nji" in sim.grows
    assert steps == [0, 10, 20, 30]
    np.testing.assert_allclose(out.temps, oracle.temps, rtol=1e-9, atol=1e-12)


def test_run_chunked_zero_chunks():
    sim = ClusterSimulation(Params(nx=3, ny=3, nz=3, scheme="cluster"), device="cpu")
    steps = []
    out = sim.run_chunked(5, 0, lambda st, step: steps.append(step))
    assert steps == [0] and out.temps.shape == (0,)


@pytest.mark.parametrize("kernel", ["auto", "pallas"])
def test_measure_phases(kernel):
    sim = ClusterSimulation(Params(nx=4, ny=4, nz=4, scheme="cluster",
                                   kernel=kernel), device="cpu")
    st = sim.initial_state()
    x0 = st.clusters.xc.clone()
    t_force, t_neigh = sim.measure_phases(st, reps=4)
    for t in (t_force, t_neigh):
        assert math.isfinite(t) and t > 0
    assert torch.equal(st.clusters.xc, x0)  # the state is not changed


def test_bucketed_cpu_path_imports_no_jax():
    """A bucketed run (hand-set plan), its stats, run_chunked and
    measure_phases, in a process that never imports jax or mdbench_tpu."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from chip_smoke import hand_plan\n"
        "from mdbench_tpu_torch import stats\n"
        "from mdbench_tpu_torch.config import Params\n"
        "from mdbench_tpu_torch.engine_cluster import ClusterSimulation\n"
        "p = Params(nx=4, ny=4, nz=4, ntimes=4, reneigh_every=2, scheme='cluster')\n"
        "sim = ClusterSimulation(p, device='cpu')\n"
        "sim.buckets = hand_plan(sim.initial_state().pairs.nji.numpy(), sim.icap)\n"
        "out = sim.run()\n"
        "assert out.temps.shape == (4,) and out.state.pairs.bijlist is not None\n"
        "cs = stats.compute_cluster_stats(out.state.clusters, out.state.pairs,\n"
        "    sim.n_clusters_pad, 16, 6.25, 7.84, buckets=sim.buckets)\n"
        "assert cs['pairs_within_cutforce'] > 0\n"
        "sim.run_chunked(2, 2, lambda st, step: None)\n"
        "sim.measure_phases(out.state, reps=2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mdbench_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
