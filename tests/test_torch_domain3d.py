"""The port's brick engine (parallel/verlet_domain3d.Domain3DSimulation)
on the in-process mesh against the port's single-device engine
(engine.Simulation), in float64 on the CPU: the planar LJ trajectory on
(2, 2, 2), (2, 2, 1) and (1, 1, 2) bricks (rel 1e-8, as
tests/test_parallel.py:228-249: along an axis of size 1 a brick sends to
itself), the row lists on (2, 2, 2) (rel 1e-6, :345-361), EAM with the
splines and the polynomials on the stand-in potential (rel 1e-8,
:206-225), the overflow grow-and-retry and the construction rules; and
inside the port, the brick engine on (2, 2, 1) against the pencil engine
on (2, 2) on one box (the z seam by a self-send against the local
z-halo: rel 1e-12, the same atoms per domain)."""

import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.parallel.exchange import InProcessMesh
from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation
from mdbench_tpu_torch.parallel.verlet_domain3d import Domain3DSimulation

torch.set_num_threads(1)


def _natoms(out):
    return sum(int(n) for n in out.state.nlocal)


@pytest.fixture(scope="module")
def planar_single():
    kw = dict(nx=10, ny=10, nz=10, ntimes=20, reneigh_every=10, kernel="xla")
    return kw, Simulation(Params(**kw), device="cpu").run(repeats=0).temps


@pytest.mark.parametrize("pdims", [(2, 2, 2), (2, 2, 1), (1, 1, 2)])
def test_planar_matches_single_device(planar_single, pdims):
    """Three staged migration hops and three staged face exchanges, each
    later stage carrying the earlier ones' ghosts (edges and corners), no
    local halo."""
    kw, temps = planar_single
    dom = Domain3DSimulation(Params(**kw), *pdims, device="cpu")
    assert dom.gcap == 0 and len(dom.bcaps) == 3
    out = dom.run(repeats=0)
    assert out.temps.shape == (20,)
    np.testing.assert_allclose(out.temps, temps, rtol=1e-8, atol=1e-12)
    assert _natoms(out) == dom.natoms
    assert out.state.halo_map == (None,) * dom.ndev


def test_rowlist_matches_single_device():
    def mk():
        return Params(nx=8, ny=8, nz=8, ntimes=20, reneigh_every=10, kernel="rowlist")

    single = Simulation(mk(), device="cpu").run(repeats=0)
    dom = Domain3DSimulation(mk(), 2, 2, 2, device="cpu")
    out = dom.run(repeats=0)
    assert dom._calibrated and dom.rbuckets is None and min(dom.bcaps) >= 64
    assert dom.gcap == 0
    assert _natoms(out) == dom.natoms
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-6, atol=1e-10)


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


@pytest.mark.parametrize("eam_eval", ["spline", "poly"])
def test_eam_matches_single_device(eam_file, eam_eval):
    """The ghost fp in three staged hops with the coordinate maps."""
    def mk():
        return Params(nx=4, ny=4, nz=4, ntimes=10, reneigh_every=5,
                      force_field=FF_EAM, eam_file=eam_file, eam_eval=eam_eval)

    single = Simulation(mk(), device="cpu").run(repeats=0)
    dom = Domain3DSimulation(mk(), 2, 2, 2, device="cpu")
    out = dom.run(repeats=0)
    assert _natoms(out) == dom.natoms
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-8)


def test_overflow_recovery():
    """Starved capacities (neighbour lists, the z exports, migration) grow
    once and retry; the trajectory is the single-device engine's."""
    def mk():
        return Params(nx=8, ny=8, nz=8, ntimes=20, reneigh_every=10, kernel="xla",
                      temp=3.0)

    dom = Domain3DSimulation(mk(), 2, 2, 2, device="cpu")
    need = max(int(o[5]) for o in dom._reneighbor(
        [x.clone() for x in dom.x0], dom.v0, dom.n0, with_stats=True)[1])
    dom.maxneighs, dom.bcaps[2], dom.migcap = 64, need * 3 // 4, 8
    dom._fix_row_layout()
    dom._init_host_state(*dom._xv_init)
    out = dom.run(repeats=0)
    assert dom.grows == [("migration", "ghosts", "lists")]
    assert dom.gcap == 0
    single = Simulation(mk(), device="cpu").run(repeats=0)
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-8)
    assert _natoms(out) == dom.natoms


def test_bricks_221_equal_pencils_22():
    """One box, hot enough to migrate: the (2, 2, 1) bricks wrap z by a
    self-send through their third stage, the (2, 2) pencils by the local
    z-halo; the sums run in other orders only."""
    def mk():
        return Params(nx=8, ny=8, nz=4, ntimes=20, reneigh_every=5, kernel="xla",
                      temp=3.0)

    bricks = Domain3DSimulation(mk(), 2, 2, 1, device="cpu").run(repeats=0)
    pencils = Domain2DSimulation(mk(), 2, 2, device="cpu").run(repeats=0)
    np.testing.assert_allclose(bricks.temps, pencils.temps, rtol=1e-12)
    nb = [int(n) for n in bricks.state.nlocal]
    assert nb == [int(n) for n in pencils.state.nlocal]
    assert nb != [256] * 4  # atoms migrated


def test_construction_rules():
    p = Params(nx=4, ny=4, nz=4)
    with pytest.raises(ValueError, match="brick width .* along z"):
        Domain3DSimulation(Params(nx=4, ny=4, nz=2), 2, 2, 2, device="cpu")
    for ex in (InProcessMesh(8, "cpu"), InProcessMesh((2, 4), "cpu"),
               InProcessMesh((2, 2, 1), "cpu")):
        with pytest.raises(ValueError, match="not \\(2, 2, 2\\)"):
            Domain3DSimulation(p, 2, 2, 2, device="cpu", exchange=ex)
    with pytest.raises(ValueError, match="kernel"):
        Domain3DSimulation(Params(nx=4, ny=4, nz=4, kernel="ilist"), 2, 2, 2,
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Domain3DSimulation(p, 2, 2, 2)
    dom = Domain3DSimulation(p, 2, 2, 2, device="cpu")
    assert dom._rowlist and not dom._on_card and dom.acap % 16 == 0
    assert all(b % 16 == 0 for b in dom.bcaps)
