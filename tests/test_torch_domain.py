"""The port's slab engine (parallel/verlet_domain.DomainSimulation) on the
in-process mesh against the port's single-device engine
(engine.Simulation), in float64 on the CPU: the planar LJ trajectory for
1, 2 and 4 slabs (rel 1e-8, as tests/test_parallel.py:15-32), EAM with
the splines and the polynomials on the stand-in potential (rel 1e-8, as
:35-78), atom conservation through migration, the overflow grow-and-retry
(:104-120), the capacity plan at 10.1M atoms against an H100's 80 GB, and
parallel/common.py number for number against mdbench_tpu's. The
row-list path and run_chunked are in test_torch_domain_rowlist.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu.ops.cells import make_cell_grid as j_make_cell_grid
from mdbench_tpu.parallel import common as jcommon
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.ops.cells import make_cell_grid
from mdbench_tpu_torch.parallel import common
from mdbench_tpu_torch.parallel.dryrun import dryrun_multichip
from mdbench_tpu_torch.parallel.exchange import InProcessMesh
from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation, plan_capacities

torch.set_num_threads(1)


def _natoms(out):
    return sum(int(n) for n in out.state.nlocal)


@pytest.fixture(scope="module")
def planar_single():
    mk = dict(nx=16, ny=4, nz=4, ntimes=30, reneigh_every=10, kernel="xla")
    return mk, Simulation(Params(**mk), device="cpu").run(repeats=0).temps


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_planar_matches_single_device(planar_single, ndev):
    """Migration, the y/z halo, the border exchange (with one slab: to
    itself across the x seam) and per-domain lists over three rebuilds."""
    kw, temps = planar_single
    dom = DomainSimulation(Params(**kw), ndev=ndev, device="cpu")
    out = dom.run(repeats=0)
    assert out.temps.shape == (30,)
    np.testing.assert_allclose(out.temps, temps, rtol=1e-8, atol=1e-12)
    assert _natoms(out) == dom.natoms
    assert len(out.state.x) == ndev and np.isnan(out.total_time)


def test_atoms_conserved_on_thin_slabs():
    """Eight slabs of a 32x3x3 box (mdbench_tpu's scaled smoke,
    test_parallel.py:136-143), hot so that atoms cross slab faces: every
    atom stays on exactly one domain and the trajectory stays finite."""
    p = Params(nx=32, ny=3, nz=3, ntimes=20, reneigh_every=10, temp=5.0, kernel="xla")
    dom = DomainSimulation(p, ndev=8, device="cpu")
    n0 = [int(n) for n in dom.n0]
    out = dom.run(repeats=0)
    assert np.isfinite(out.temps).all()
    n1 = [int(n) for n in out.state.nlocal]
    assert sum(n1) == dom.natoms == sum(n0)
    assert n1 != n0  # atoms migrated


def test_padding_spawns_no_ghosts_in_a_thin_box():
    """A box thinner than 2 cutneigh in y and z with the card's 1024-atom
    local blocks (mostly padding): the padding rows must spawn no y/z
    ghosts (mdbench_tpu's mid-box parking would, in such a box, and the
    ghost capacity would never catch up)."""
    def mk():
        return Params(nx=8, ny=2, nz=2, ntimes=4, reneigh_every=2, kernel="rowlist")

    dom = DomainSimulation(mk(), ndev=2, device="cpu")
    dom._on_card = True  # the card's layout rule, on the CPU
    dom._fix_row_layout()
    dom._init_host_state(*dom._xv_init)
    assert dom.acap == 1024
    out = dom.run(repeats=0)
    assert "ghosts" not in sum(dom.grows, ())
    # the ghosts are the live atoms' alone: as many as with the CPU's
    # 16-atom alignment (16 padding rows a slab)
    small = DomainSimulation(mk(), ndev=2, device="cpu")
    assert small.acap < 128
    assert ([int(d.halo.nghost) for d in dom.initial_state()]
            == [int(d.halo.nghost) for d in small.initial_state()])
    single = Simulation(mk(), device="cpu").run(repeats=0)
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-8)


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


@pytest.mark.parametrize("eam_eval", ["spline", "poly"])
def test_eam_matches_single_device(eam_file, eam_eval):
    """The two EAM passes with the ghost fp exchanged between the domains
    in between (the multi-device force_eam.c:117-120)."""
    def mk():
        return Params(nx=6, ny=6, nz=6, ntimes=10, reneigh_every=5,
                      force_field=FF_EAM, eam_file=eam_file, eam_eval=eam_eval)

    single = Simulation(mk(), device="cpu").run(repeats=0)
    dom = DomainSimulation(mk(), ndev=2, device="cpu")
    assert (dom.eam_poly is not None) == (eam_eval == "poly")
    out = dom.run(repeats=0)
    assert _natoms(out) == dom.natoms
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-8)


def test_overflow_recovery():
    """A neighbour-list capacity far below need grows and retries; the
    trajectory is the single-device engine's."""
    def mk():
        return Params(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5, kernel="xla")

    dom = DomainSimulation(mk(), ndev=2, device="cpu")
    dom.maxneighs = 16
    out = dom.run(repeats=0)
    assert dom.maxneighs > 16
    single = Simulation(mk(), device="cpu").run(repeats=0)
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-8)


@pytest.mark.parametrize("ndev,limit", [(1, 80e9 * 0.5), (8, 4 * 1024**3)])
def test_capacity_plan_10m_atoms(ndev, limit):
    """The 10.1M-atom configuration (136^3 FCC cells) plans within an H100's
    80 GB with the port's int64 indices; on 8 domains under 4 GB each."""
    for precision in ("sp", "dp"):
        p = Params(nx=136, ny=136, nz=136, precision=precision)
        natoms = 4 * p.nx * p.ny * p.nz
        assert natoms >= 10_000_000
        plan = plan_capacities(p, ndev, natoms)
        assert plan["slab_ok"]
        assert plan["bytes_per_device"] < limit, plan


def test_construction_rules():
    p = Params(nx=4, ny=4, nz=4)
    with pytest.raises(ValueError, match="slab width"):
        DomainSimulation(Params(nx=4, ny=4, nz=4), ndev=4, device="cpu")
    with pytest.raises(ValueError, match="mesh of 3"):
        DomainSimulation(p, ndev=1, device="cpu", exchange=InProcessMesh(3, "cpu"))
    with pytest.raises(ValueError, match="kernel"):
        DomainSimulation(Params(nx=4, ny=4, nz=4, kernel="pallas"), ndev=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DomainSimulation(Params(nx=4, ny=4, nz=4), ndev=1)
    # the single-engine rule: row lists for auto LJ on every device, on the
    # card 1024-aligned local blocks and a bucket plan, 16-aligned elsewhere
    dom = DomainSimulation(Params(nx=8, ny=4, nz=4), ndev=2, device="cpu")
    assert dom._rowlist and not dom._on_card and dom.acap % 16 == 0
    assert not DomainSimulation(Params(nx=8, ny=4, nz=4, kernel="xla"), ndev=2,
                                device="cpu")._rowlist


def test_dryrun_on_cpu():
    dryrun_multichip(2, device="cpu")
    # eight domains: the pencil leg on (4, 2) and the brick leg on (2, 2, 2)
    dryrun_multichip(8, device="cpu")


# ---- parallel/common.py against mdbench_tpu -----------------------------------

def test_layout_helpers_match_jax():
    for acap in (1, 15, 16, 17, 1000, 1024, 1025, 36056, 144184):
        for rowlist in (False, True):
            for on_card in (False, True):
                assert common.align_acap(rowlist, on_card, acap) == jcommon.align_acap(
                    rowlist, "pallas" if on_card else "xla", acap)
        assert common.round16(acap) == jcommon.round16(acap)
        for floor in (128, 256):
            assert (common.calibrated_block_cap(acap, floor)
                    == jcommon.calibrated_block_cap(acap, floor))


class _Caps:
    pass


@pytest.mark.parametrize("units,want_buckets", [(64, False), (5000, True), (9000, True)])
def test_apply_rowlist_caps_matches_jax(units, want_buckets):
    rng = np.random.default_rng(units)
    nr = rng.integers(0, 60, size=(3, units)).astype(np.int32)
    nr[:, : units // 10] = 0  # a zero tier
    st = rng.integers(1, 200, size=(3, 4))
    t, j = _Caps(), _Caps()
    pt = common.apply_rowlist_caps(t, nr, st, want_buckets)
    pj = jcommon.apply_rowlist_caps(j, nr, st, want_buckets)
    assert vars(t) == vars(j)
    assert pt == (None if pj is None else (tuple(map(int, pj[0])), tuple(map(int, pj[1]))))
    if units >= 4096:
        assert pt is not None


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_resort_by_cell_matches_jax(dtype):
    """The same bins in the same order; within a bin the port keeps row
    order (mdbench_tpu's one-key unstable sort leaves ties unordered, so
    only each bin's set of atoms is compared with it)."""
    rng = np.random.default_rng(7)
    box = np.array([7.0, 6.8, 6.8])
    acap, nloc = 320, 300
    x = np.full((acap + 48, 3), 1e30)
    x[:nloc] = rng.uniform(0.0, 1.0, (nloc, 3)) * box
    v = rng.normal(size=(acap, 3))
    tgrid = make_cell_grid(box, 2.8, 0.8442, 0)
    jgrid = j_make_cell_grid(box, 2.8, 0.8442, 0)
    xt, vt = common.resort_by_cell(tgrid, torch.tensor(x.astype(dtype)),
                                   torch.tensor(v.astype(dtype)),
                                   torch.tensor(nloc), acap)
    xj, vj = jcommon.resort_by_cell(jgrid, jnp.asarray(x, dtype), jnp.asarray(v, dtype),
                                    jnp.int32(nloc), acap)
    xt, vt, xj, vj = xt.numpy(), vt.numpy(), np.asarray(xj), np.asarray(vj)

    def bins(a):
        b = [np.clip((a[:nloc, d] / tgrid.binsize[d]).astype(np.int32) + 1, 0,
                     tgrid.dims[d] - 1) for d in range(3)]
        return (b[0] * tgrid.dims[1] + b[1]) * tgrid.dims[2] + b[2]

    bt, bj = bins(xt), bins(xj)
    np.testing.assert_array_equal(bt, bj)
    assert (np.diff(bt) >= 0).all()
    np.testing.assert_array_equal(xt[nloc:], x[nloc:].astype(dtype))
    for b in np.unique(bt):
        rows_t = np.lexsort(np.c_[xt[:nloc], vt[:nloc]][bt == b].T)
        rows_j = np.lexsort(np.c_[xj[:nloc], vj[:nloc]][bj == b].T)
        np.testing.assert_array_equal(np.c_[xt[:nloc], vt[:nloc]][bt == b][rows_t],
                                      np.c_[xj[:nloc], vj[:nloc]][bj == b][rows_j])
    # ties keep row order: the permutation is increasing within a bin
    order = [np.flatnonzero((x[:nloc].astype(dtype) == r).all(1))[0] for r in xt[:nloc]]
    for b in np.unique(bt):
        assert (np.diff(np.asarray(order)[bt == b]) > 0).all()
