"""The port's cluster slab engine (parallel/cluster_domain.
ClusterDomainSimulation) on the in-process mesh against the port's
single-device cluster engine (engine_cluster.ClusterSimulation), in
float64 on the CPU: the group-window plain path on 4 slabs (rel 1e-8, as
tests/test_parallel.py:81-101), the exact-list plain path (rel 1e-6, as
:287-308), the same with full rebuilds every other interval (migration
and both rebuild kinds), EAM on 2 slabs on the stand-in potential (rel
1e-10, as tests/test_eam_cluster.py:49-70), the targeted grow from
undersized capacities, a hand-set bucket plan against the flat lists,
and the construction rules."""

import numpy as np
import pytest
import torch

from chip_smoke import hand_plan, write_standin_funcfl
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.engine_cluster import ClusterSimulation
from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation
from mdbench_tpu_torch.parallel.exchange import InProcessMesh

torch.set_num_threads(1)

KW = dict(nx=16, ny=4, nz=4, ntimes=20, reneigh_every=10, scheme="cluster")


def _single(**kw):
    return ClusterSimulation(Params(**kw), device="cpu").run(repeats=0).temps


@pytest.mark.parametrize("kernel,rtol", [("xla", 1e-8), ("ilist", 1e-6)])
def test_matches_single_engine(kernel, rtol):
    """The j16 ghosts across the slab faces (one slab sends to itself
    across the seam), the y/z halo and the per-domain lists over two
    rebuilds, on 4 slabs."""
    kw = dict(KW, kernel=kernel)
    dom = ClusterDomainSimulation(Params(**kw), ndev=4, device="cpu")
    out = dom.run(repeats=0)
    assert out.temps.shape == (20,) and np.isnan(out.total_time)
    assert int(out.nlocal.sum()) == dom.natoms and not out.overflow.any()
    assert dom._calibrated == (kernel == "ilist") and dom.buckets is None
    np.testing.assert_allclose(out.temps, _single(**kw), rtol=rtol)


def test_migration_and_both_rebuild_kinds():
    """A full rebuild (with migration) every other interval, a cheap one
    between: atoms cross the slab faces, every atom stays on exactly one
    domain, and the trajectory is the single engine's with the same
    cadence."""
    kw = dict(KW, kernel="ilist", reneigh_every=5, resort_every=10, temp=3.0)
    dom = ClusterDomainSimulation(Params(**kw), ndev=4, device="cpu")
    n0 = [int(n) for n in dom.n0]
    out = dom.run(repeats=0)
    assert int(out.nlocal.sum()) == dom.natoms == sum(n0)
    assert list(out.nlocal) != n0  # atoms migrated
    np.testing.assert_allclose(out.temps, _single(**kw), rtol=1e-6)


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


def test_eam_matches_single_engine(eam_file):
    """The split EAM force: the density on both slabs, the ghost fp from
    the y/z owners and across the faces, then the pair force."""
    kw = dict(nx=8, ny=3, nz=3, ntimes=10, reneigh_every=5, scheme="cluster",
              force_field=FF_EAM, eam_file=eam_file)
    dom = ClusterDomainSimulation(Params(**kw), ndev=2, device="cpu")
    assert dom.eam_poly is not None
    out = dom.run(repeats=0)
    assert not out.overflow.any() and int(out.nlocal.sum()) == dom.natoms
    np.testing.assert_allclose(out.temps, _single(**kw), rtol=1e-10)


def test_overflow_recovery_is_targeted():
    """Ghost, export and exact-list capacities far below need: the runs
    that overflow grow what their flags name (and the calibration then
    sets the caps from the melt); the trajectory is the single engine's."""
    kw = dict(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5, scheme="cluster",
              kernel="ilist")
    dom = ClusterDomainSimulation(Params(**kw), ndev=2, device="cpu")
    acap, ncl_pad = dom.acap, dom.ncl_pad
    dom.gcap_rows, dom.xcap16, dom.icap = 8, 4, 8
    dom._fix_layout()
    dom._init_host_state(*dom._xv_init)
    out = dom.run(repeats=0)
    fired = set(sum(dom.grows, ()))
    assert {"ghosts", "x_export", "ilist_nji"} <= fired
    assert "migration" not in fired and "clusters" not in fired
    assert (dom.acap, dom.ncl_pad) == (acap, ncl_pad)  # not grown blindly
    np.testing.assert_allclose(out.temps, _single(**kw), rtol=1e-6)


def test_hand_set_bucket_plan_matches_flat():
    """The bucketed exact-list force (the card's K1b after the melt plan;
    on the CPU its plain twin) over a hand-set plan with a zero tier and
    dummy units, one plan for both slabs: the flat force's bits."""
    kw = dict(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5, scheme="cluster")
    dom = ClusterDomainSimulation(Params(**kw), ndev=2, device="cpu")
    flat = dom.run(repeats=0)
    assert dom.buckets is None  # no plan off the card
    nji = np.sort(np.stack([d.pairs.nji.numpy() for d in flat.state]), axis=1).max(0)
    dom.buckets = hand_plan(nji, dom.icap)
    out = dom._run_raw(10)
    assert dom.buckets is not None and not dom.grows
    assert all(d.pairs.bijlist is not None for d in out.state)
    np.testing.assert_array_equal(out.temps, flat.temps)
    for a, b in zip(out.state, flat.state):
        for f in ("fxc", "fyc", "fzc", "vxc"):
            assert torch.equal(getattr(a, f), getattr(b, f))


def test_construction_rules(eam_file):
    eam = dict(scheme="cluster", force_field=FF_EAM, eam_file=eam_file, nx=8, ny=3,
               nz=3)
    with pytest.raises(ValueError, match="polynomial-evaluation only"):
        ClusterDomainSimulation(Params(eam_eval="spline", **eam), ndev=2, device="cpu")
    for kernel in ("xla", "pallas"):
        with pytest.raises(ValueError, match="exact-list kernels only"):
            ClusterDomainSimulation(Params(kernel=kernel, **eam), ndev=2, device="cpu")
    with pytest.raises(ValueError, match="requires eam_file"):
        ClusterDomainSimulation(Params(scheme="cluster", force_field=FF_EAM), ndev=1,
                                device="cpu")
    with pytest.raises(ValueError, match="slab width"):
        ClusterDomainSimulation(Params(nx=4, ny=4, nz=4), ndev=4, device="cpu")
    with pytest.raises(ValueError, match="mesh of 3"):
        ClusterDomainSimulation(Params(nx=4, ny=4, nz=4), ndev=1, device="cpu",
                                exchange=InProcessMesh(3, "cpu"))
    with pytest.raises(ValueError, match="kernel must be one of"):
        ClusterDomainSimulation(Params(nx=4, ny=4, nz=4, kernel="rowlist"), ndev=1,
                                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ClusterDomainSimulation(Params(nx=4, ny=4, nz=4), ndev=1)
    dom = ClusterDomainSimulation(Params(nx=8, ny=4, nz=4), ndev=2, device="cpu")
    assert dom._ilist and not dom._on_card and dom.ishare == 2
    assert dom.nrows_cl == dom.ncl_pad + dom.gcap_rows + 4 * dom.xcap16 + 2
