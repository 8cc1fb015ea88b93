"""The port's pencil engine (parallel/verlet_domain2d.Domain2DSimulation)
on the in-process mesh against the port's single-device engine
(engine.Simulation), in float64 on the CPU: the planar LJ trajectory on
(2, 2) and (4, 2) pencils (rel 1e-8, as tests/test_parallel.py:164-183),
the row lists on (2, 2) (rel 1e-6: the row partitions differ, :326-342),
EAM with the splines and the polynomials on the stand-in potential (rel
1e-8, :186-203), the overflow grow-and-retry, and the construction
rules."""

import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.parallel.exchange import InProcessMesh
from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation

torch.set_num_threads(1)


def _natoms(out):
    return sum(int(n) for n in out.state.nlocal)


@pytest.fixture(scope="module")
def planar_single():
    kw = dict(nx=10, ny=10, nz=4, ntimes=20, reneigh_every=10, kernel="xla")
    return kw, Simulation(Params(**kw), device="cpu").run(repeats=0).temps


@pytest.mark.parametrize("px,py", [(2, 2), (4, 2)])
def test_planar_matches_single_device(planar_single, px, py):
    """Two staged migration hops, the local z-halo, the x exports, the y
    exports that carry the x-ghosts (the corners) and per-pencil lists
    over two rebuilds."""
    kw, temps = planar_single
    dom = Domain2DSimulation(Params(**kw), px, py, device="cpu")
    assert dom.exchange.shape == (px, py) and len(dom.bcaps) == 2 and dom.gcap > 0
    out = dom.run(repeats=0)
    assert out.temps.shape == (20,) and np.isnan(out.total_time)
    np.testing.assert_allclose(out.temps, temps, rtol=1e-8, atol=1e-12)
    assert _natoms(out) == dom.natoms
    assert len(out.state.x) == px * py and len(out.state.maps[0]) == 2


def test_rowlist_matches_single_device():
    def mk():
        return Params(nx=8, ny=8, nz=4, ntimes=20, reneigh_every=10, kernel="rowlist")

    single = Simulation(mk(), device="cpu").run(repeats=0)
    dom = Domain2DSimulation(mk(), 2, 2, device="cpu")
    assert dom._rowlist
    out = dom.run(repeats=0)
    assert dom._calibrated and dom.rbuckets is None  # no bucket plan off the card
    assert dom.gcap >= 128 and min(dom.bcaps) >= 64  # the calibration's floors
    assert _natoms(out) == dom.natoms
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-6, atol=1e-10)


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


@pytest.mark.parametrize("eam_eval", ["spline", "poly"])
def test_eam_matches_single_device(eam_file, eam_eval):
    """The two EAM passes with the ghost fp staged between them: local z,
    then the x and y exchanges (the multi-device force_eam.c:117-120)."""
    def mk():
        return Params(nx=8, ny=8, nz=4, ntimes=10, reneigh_every=5,
                      force_field=FF_EAM, eam_file=eam_file, eam_eval=eam_eval)

    single = Simulation(mk(), device="cpu").run(repeats=0)
    dom = Domain2DSimulation(mk(), 2, 2, device="cpu")
    assert (dom.eam_poly is not None) == (eam_eval == "poly")
    out = dom.run(repeats=0)
    assert _natoms(out) == dom.natoms
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-8)


def test_overflow_recovery():
    """Starved capacities (neighbour lists, the y exports, migration) grow
    and retry; the trajectory is the single-device engine's."""
    def mk():
        return Params(nx=10, ny=10, nz=4, ntimes=20, reneigh_every=10, kernel="xla",
                      temp=3.0)

    dom = Domain2DSimulation(mk(), 2, 2, device="cpu")
    # below the melt's needs (~80 neighbours, 510 y exports, ~10 leavers)
    dom.maxneighs, dom.bcaps[1], dom.migcap = 64, 360, 8
    dom._fix_row_layout()
    dom._init_host_state(*dom._xv_init)
    out = dom.run(repeats=0)
    assert dom.grows == [("migration", "ghosts", "lists")]
    assert dom.maxneighs > 64 and dom.bcaps[1] > 360 and dom.migcap > 8
    single = Simulation(mk(), device="cpu").run(repeats=0)
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-8)
    assert _natoms(out) == dom.natoms


def test_construction_rules():
    p = Params(nx=8, ny=8, nz=4)
    with pytest.raises(ValueError, match="pencil width .* along y"):
        Domain2DSimulation(Params(nx=8, ny=4, nz=4), 2, 4, device="cpu")
    with pytest.raises(ValueError, match="pencil width .* along x"):
        Domain2DSimulation(Params(nx=4, ny=8, nz=4), 4, 2, device="cpu")
    for ex in (InProcessMesh(4, "cpu"), InProcessMesh((4, 1), "cpu"),
               InProcessMesh((2, 2, 1), "cpu")):
        with pytest.raises(ValueError, match="not \\(2, 2\\)"):
            Domain2DSimulation(p, 2, 2, device="cpu", exchange=ex)
    with pytest.raises(ValueError, match="kernel"):
        Domain2DSimulation(Params(nx=8, ny=8, nz=4, kernel="pallas"), 2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Domain2DSimulation(p, 2, 2)
    # the single engine's rule: row lists for auto LJ on every device, 16-row
    # aligned off the card; the planar lists for xla and EAM
    dom = Domain2DSimulation(p, 2, 2, device="cpu")
    assert dom._rowlist and not dom._on_card and dom.acap % 16 == 0
    assert all(b % 16 == 0 for b in dom.bcaps) and dom.gcap % 16 == 0
    assert not Domain2DSimulation(Params(nx=8, ny=8, nz=4, kernel="xla"), 2, 2,
                                  device="cpu")._rowlist
