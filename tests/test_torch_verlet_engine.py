"""The port's verlet engine (engine.Simulation) against mdbench_tpu's, in
float64 on the CPU: step-0 forces (1e-10 of max |f|), the 6^3 100-step
trajectory on the planar full lists, the half lists and the row lists
against mdbench_tpu's run on the same path (rel 1e-9) and the C
reference's golden trace (GOLDEN_LJ: rel 5e-6 full, 1e-5 half, 1e-4 on
the row lists, which sum in another order), thermo at rebuilds only, the
grow-and-retry path from capacities far below need, a hand-set bucket
plan, the melt calibration, run_chunked and measure_phases, and the
settings the port refuses."""

import numpy as np
import pytest
import torch

from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine import Simulation as JSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from chip_smoke import hand_plan
from mdbench_tpu_torch.config import FF_EAM
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.engine import FlatSimulation, Simulation as TSim
from mdbench_tpu_torch.engine_cluster import ClusterSimulation, check_slice
from test_golden import GOLDEN_LJ

torch.set_num_threads(1)


@pytest.mark.parametrize("kernel", ["rowlist", "xla"])
def test_step0_forces_match_jax(kernel):
    kw = dict(nx=5, ny=5, nz=5, kernel=kernel)
    x, v, _ = create_fcc_lattice(JParams(**kw))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    f_j = JSim(JParams(**kw), x=x, v=v).first_force()
    f_t = TSim(TParams(**kw), x=x, v=v, device="cpu").first_force()
    assert np.abs(f_j).max() > 1.0
    assert np.abs(f_t - f_j).max() / np.abs(f_j).max() < 1e-10


@pytest.mark.parametrize("kw, jkw, gold_rel", [
    ({"kernel": "xla"}, {}, 5e-6),
    ({"half_neigh": 1}, {"half_neigh": 1}, 1e-5),
    # the row lists sum in another order than the C verlet loop; the
    # ~1e-16 difference grows at the Lyapunov rate (mdbench_tpu's rowlist
    # run meets the golden trace at 7.2e-6 by step 90), so the golden
    # tolerance is the cluster scheme's
    ({"kernel": "auto"}, {"kernel": "rowlist"}, 1e-4),
])
def test_trajectory_matches_jax_and_golden(kw, jkw, gold_rel):
    """The 6^3 100-step DP run, port against mdbench_tpu on the same path
    (the port's default kernel runs the row lists on the CPU through their
    plain twins; mdbench_tpu's only when asked for by name)."""
    base = dict(nx=6, ny=6, nz=6, ntimes=100)
    r_t = TSim(TParams(**base, **kw), device="cpu").run(repeats=0)
    r_j = JSim(JParams(**base, **jkw)).run()
    assert r_t.temps.shape == (100,) and r_t.press.shape == (100,)
    np.testing.assert_allclose(r_t.temps, r_j.temps, rtol=1e-9)
    np.testing.assert_allclose(r_t.press, r_j.press, rtol=1e-9)
    for step, (t_gold, p_gold) in GOLDEN_LJ.items():
        if step:
            assert r_t.temps[step - 1] == pytest.approx(t_gold, rel=gold_rel)
            assert r_t.press[step - 1] == pytest.approx(p_gold, rel=gold_rel)


def test_rowlist_equals_planar_and_sparse_thermo():
    """dense_thermo off records only the rebuild steps; the row lists and
    the per-atom lists give one trajectory."""
    kw = dict(nx=4, ny=4, nz=4, ntimes=12, reneigh_every=5, dense_thermo=False)
    r_row = TSim(TParams(**kw), device="cpu").run(repeats=0)
    r_pl = TSim(TParams(**kw, kernel="xla"), device="cpu").run(repeats=0)
    np.testing.assert_array_equal(np.nonzero(r_row.temps)[0], [4, 9])
    np.testing.assert_allclose(r_row.temps, r_pl.temps, rtol=1e-12)


@pytest.mark.parametrize("kernel, shrink", [
    ("rowlist", {"rcap": 8}), ("rowlist", {"ccap": 24, "ukr": 8, "ucl": 1}),
    ("xla", {"maxneighs": 48, "ghost": None}),
])
def test_grow_and_retry_from_small_caps(kernel, shrink):
    """Capacities far below need overflow, grow and retry to the same
    trajectory (ghost None: 80% of the ghost count)."""
    kw = dict(nx=4, ny=4, nz=4, ntimes=12, reneigh_every=5, kernel=kernel)
    ref = TSim(TParams(**kw), device="cpu").run(repeats=0)
    sim = TSim(TParams(**kw), device="cpu")
    sim._rcap_calibrated = True  # keep the small caps into the run
    if "ghost" in shrink:
        shrink = {**shrink,
                  "ghost": int(int(sim.initial_state().halo.nghost) * 0.8) // 8 * 8}
    caps = {k: v for k, v in shrink.items() if k in sim.caps._fields}
    for k, v in shrink.items():
        if k not in caps:
            setattr(sim, k, v)
    sim.caps = sim.caps._replace(**caps)
    sim._build_device_state()
    assert bool(sim.initial_state().overflow)
    out = sim.run(repeats=0)
    for k, v in shrink.items():
        assert (sim.caps._asdict().get(k) or getattr(sim, k)) > v
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)


def test_hand_bucket_plan_and_melt_calibration():
    """A hand-set plan runs the bucketed plain force (equal to the flat
    run); the melt calibration (on the card it plans the buckets) runs on
    the CPU when asked for, and changes no temperature."""
    kw = dict(nx=5, ny=5, nz=5, ntimes=20, reneigh_every=10)
    ref = TSim(TParams(**kw), device="cpu").run(repeats=0)
    sim = TSim(TParams(**kw), device="cpu")
    st = sim.initial_state()
    sim._calibrate_rcap(st)
    sim.rbuckets = hand_plan(sim.initial_state().nlist.numrows.numpy(), sim.rcap)
    out = sim.run(repeats=0)
    assert out.state.nlist.brows is not None
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)
    melt = FlatSimulation(TParams(**kw), device="cpu")
    melt._on_card = True
    out = melt.run(repeats=0)
    assert melt._melt_calibrated and melt.rbuckets is None
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)


def test_run_chunked_and_measure_phases():
    kw = dict(nx=4, ny=4, nz=4, reneigh_every=5)
    ref = TSim(TParams(**kw), device="cpu").run(ntimes=20, repeats=0)
    steps = []
    sim = TSim(TParams(**kw), device="cpu")
    out = sim.run_chunked(5, 3, lambda state, step: steps.append(step), tail=5)
    assert steps == [0, 5, 10, 15, 20]
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)
    t_force, t_neigh = sim.measure_phases(out.state, reps=4)
    assert 0 < t_force < 5 and 0 < t_neigh < 5
    pal = sim.per_atom_lists(out.state.x, out.state.types)
    assert int(pal.numneigh.max()) > 20


def test_chunk_overflow_replays():
    """A chunk that overflows is replayed from its boundary after the
    capacities grow; the temperatures equal an uninterrupted run's."""
    kw = dict(nx=4, ny=4, nz=4, reneigh_every=5)
    ref = TSim(TParams(**kw), device="cpu").run(ntimes=15, repeats=0)
    sim = TSim(TParams(**kw), device="cpu")
    orig = sim._calibrate_rcap

    def shrink(state0):
        orig(state0)
        sim.rcap = 16  # the melt outgrows it mid-run
        sim._build_device_state()
        return True

    sim._calibrate_rcap = shrink
    out = sim.run_chunked(5, 3, lambda state, step: None)
    assert sim.rcap > 16
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)


@pytest.mark.parametrize("kw, exc", [
    # verlet EAM runs since its port; without a potential file it raises
    # ValueError, as mdbench_tpu's engine does
    ({"force_field": FF_EAM}, ValueError),
    ({"kernel": "pallas"}, ValueError),
    ({"scheme": "cluster"}, ValueError),
])
def test_refused_settings(kw, exc):
    p = TParams(**{"nx": 4, "ny": 4, "nz": 4, **kw})
    with pytest.raises(exc):
        TSim(p, device="cpu")


def test_check_slice_accepts_verlet_lj_and_cluster_refuses_it():
    p = TParams(nx=4, ny=4, nz=4, scheme="verlet")
    check_slice(p)
    with pytest.raises(ValueError, match="engine.Simulation"):
        ClusterSimulation(p, device="cpu")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSim(TParams(nx=4, ny=4, nz=4))  # the default device is "cuda"
