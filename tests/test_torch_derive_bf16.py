"""The bf16 derive (Params.derive_bf16, ops/cluster.derive_ilists
bf16=True) against mdbench_tpu's, in single precision on the CPU: the
lists of a full build equal mdbench_tpu's (sets, nji, the sentinel past
nji); at share 1, 2 and 4 they are a superset of the exact lists whose
extra entries lie within the derive's reach, with no padding j16 kept;
the engine's SP runs (LJ, and cluster EAM on the stand-in potential) meet
mdbench_tpu's and the port's exact-derive runs; the lists' overflow goes
through grow and retry; the prune derives in bf16; and where mdbench_tpu
ignores the setting (DP runs, the verlet engine, the cluster slab
engine) the port gives the same bits with and without it."""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu.config import FF_EAM as J_FF_EAM
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.engine_cluster import GROUP, ClusterSimulation
from mdbench_tpu_torch.ops.cluster import (
    bf16_cutoff,
    bf16_extents,
    bf16_reach,
    derive_ilists,
)
from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation

torch.set_num_threads(1)

HALF = 5e29  # SENTINEL_COORD / 2: coordinates at or past it are padding


def _positions(n, sigma):
    x, v, _ = create_fcc_lattice(JParams(nx=n, ny=n, nz=n))
    if sigma:
        x = x + np.random.default_rng(11).normal(0.0, sigma, x.shape)
    return x, v


def _row_sets(lists, counts):
    return [set(row[:c].tolist()) for row, c in zip(lists, counts)]


@pytest.mark.parametrize("n,sigma", [(6, 0.0), (8, 0.1)])
def test_lists_match_mdbench_tpu(n, sigma):
    """A full build's lists, bit-identical clusters first. mdbench_tpu runs
    SP without jax_enable_x64, which the test harness turns on: under it
    mdbench_tpu's SP build of the exact lattice clusters otherwise (its
    atom_id differs, the jittered box's does not), so its runs here take
    the SP setting's default."""
    x, v = _positions(n, sigma)
    kw = dict(nx=n, ny=n, nz=n, precision="sp", scheme="cluster", derive_bf16=True)
    with jax.enable_x64(False):
        sj = JSim(JParams(**kw), x=x, v=v)
        *_, pj, oj = jax.jit(sj._reneighbor_from_flat)(sj.x_flat0, sj.v_flat0)
    st = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu")
    assert st._derive_bf16 and st.icap == sj.icap
    ct, _, _, pt, ot = st._reneighbor_from_flat(st.x_flat0, st.v_flat0)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    nji = np.asarray(pj.nji)
    np.testing.assert_array_equal(pt.nji.numpy(), nji)
    ijl_j, ijl_t = np.asarray(pj.ijlist), pt.ijlist.numpy()
    assert _row_sets(ijl_t, nji) == _row_sets(ijl_j, nji)
    past = np.arange(ijl_t.shape[1])[None, :] >= nji[:, None]
    sentinel = ct.xc.shape[0] // 2 - 1
    assert (ijl_t[past] == sentinel).all() and (ijl_j[past] == sentinel).all()
    # the exact derive of the same build keeps no more
    exact = derive_ilists(ct, pt, st.n_clusters_pad, GROUP, st.params.cutneigh,
                          st.icap, share=st.ishare)
    assert (exact.nji <= pt.nji).all()


def _min_dist(cl, npad, share, ijl):
    """The float64 minimum distance between each unit's real atoms and
    each listed j16's real atoms, (units, cap); inf where either side has
    none (padding)."""
    planes = [p.double() for p in (cl.xc, cl.yc, cl.zc)]
    nu = npad // share
    ia = [p[:npad].reshape(nu, share * 8) for p in planes]
    ja = [p.reshape(-1, 16) for p in planes]
    ireal = (torch.stack(ia).abs() < HALF).all(0)
    jreal = (torch.stack(ja).abs() < HALF).all(0)
    jl = ijl.long()
    d2 = sum((a[:, None, :, None] - b[jl][:, :, None, :]) ** 2 for a, b in zip(ia, ja))
    ok = ireal[:, None, :, None] & jreal[jl][:, :, None, :]
    return torch.where(ok, d2, torch.inf).amin((2, 3)).sqrt(), ireal


@pytest.mark.parametrize("share", [1, 2, 4])
def test_superset_within_the_reach(share):
    """On a melted 8^3 SP state: the bf16 lists hold every exact entry;
    each extra entry's float64 minimum distance is within the unit's
    reach (bf16_reach) and within sqrt(cut_eff) + err_r; the excess is a
    boundary shell; units of padding alone keep nothing, and a column-
    tail unit (real atoms and padding) keeps only j16s with a real atom
    within reach of a real atom."""
    x, v = _positions(8, 0.1)
    kw = dict(nx=8, ny=8, nz=8, ntimes=20, reneigh_every=10, precision="sp",
              scheme="cluster", derive_bf16=True, ishare=share)
    sim = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu")
    st = sim.run(repeats=0).state
    cl, npad, cut = st.clusters, sim.n_clusters_pad, sim.params.cutneigh
    args = (cl, st.pairs, npad, GROUP, cut, sim.icap)
    ex = derive_ilists(*args, share=share)
    bf = derive_ilists(*args, share=share, bf16=True)
    torch.testing.assert_close(bf.ijlist, st.pairs.ijlist, rtol=0, atol=0)
    assert not bool(bf.iovf) and int(bf.nji.max()) <= sim.icap
    ext = bf16_extents(cl, npad, GROUP, share)
    cut_eff, err_r = bf16_cutoff([b.double() for b in ext], cut)
    reach = bf16_reach(ext, cut)
    dist, ireal = _min_dist(cl, npad, share, bf.ijlist)
    sentinel = cl.xc.shape[0] // 2 - 1
    excess = 0
    for u in range(bf.nji.shape[0]):
        exact = set(ex.ijlist[u, : ex.nji[u]].tolist())
        row = bf.ijlist[u, : bf.nji[u]].tolist()
        assert exact <= set(row), f"unit {u} dropped exact entries"
        assert sentinel not in row and (bf.ijlist[u, bf.nji[u]:] == sentinel).all()
        assert torch.isfinite(dist[u, : bf.nji[u]]).all(), f"unit {u} kept padding"
        extra = [k for k, j in enumerate(row) if j not in exact]
        excess += len(extra)
        if extra:
            d = dist[u, extra]
            assert (d <= reach[u]).all() and (d > cut).all()
            assert (d <= torch.sqrt(cut_eff[u]) + err_r[u]).all()
    total = int(ex.nji.sum())
    assert 0 < excess <= 0.12 * total + 8, (excess, total)
    padding_units = ~ireal.any(1)
    tail_units = ireal.any(1) & ~ireal.all(1)
    assert padding_units.any() and tail_units.any()
    assert (bf.nji[padding_units] == 0).all()


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


@pytest.mark.parametrize("ff", ["lj", "eam"])
def test_sp_runs_match_mdbench_tpu(ff, eam_file):
    """20 SP steps with a rebuild at step 10 (mdbench_tpu's engine built
    once per case, without jax_enable_x64): the port's bf16 run meets mdbench_tpu's and the port's
    exact-derive run within rel 1e-5, and its final lists are the bf16
    derive's, longer than the exact derive's on the same state."""
    n, jff = (6, {}) if ff == "lj" else (4, {"force_field": J_FF_EAM,
                                            "eam_file": eam_file})
    kw = dict(nx=n, ny=n, nz=n, ntimes=20, reneigh_every=10, precision="sp",
              scheme="cluster", derive_bf16=True, **jff)
    with jax.enable_x64(False):
        r_j = JSim(JParams(**kw)).run()
    tkw = {**kw, **({"force_field": FF_EAM} if ff == "eam" else {})}
    sim = ClusterSimulation(Params(**tkw), device="cpu")
    out = sim.run(repeats=0)
    r_f = ClusterSimulation(Params(**{**tkw, "derive_bf16": False}), device="cpu").run(
        repeats=0)
    np.testing.assert_allclose(out.temps, r_j.temps, rtol=1e-5)
    np.testing.assert_allclose(out.temps, r_f.temps, rtol=1e-5)
    st = out.state
    args = (st.clusters, st.pairs, sim.n_clusters_pad, GROUP, sim.params.cutneigh,
            sim.icap)
    bf = derive_ilists(*args, share=sim.ishare, bf16=True)
    ex = derive_ilists(*args, share=sim.ishare)
    torch.testing.assert_close(st.pairs.nji, bf.nji, rtol=0, atol=0)
    assert int(bf.nji.sum()) > int(ex.nji.sum())


def test_overflow_grows_and_retries():
    """An exact-list capacity below the bf16 lists' need overflows, grows
    and retries to the trajectory of a run that fits."""
    kw = dict(nx=4, ny=4, nz=4, ntimes=12, reneigh_every=5, precision="sp",
              scheme="cluster", derive_bf16=True, temp=3.0)
    ref = ClusterSimulation(Params(**kw), device="cpu").run(repeats=0)
    sim = ClusterSimulation(Params(**kw), device="cpu")
    sim.icap = 8
    out = sim.run(repeats=0)
    assert sim.icap > 8 and sim.grows
    np.testing.assert_array_equal(out.temps, ref.temps)


def test_prune_derives_in_bf16():
    """The in-interval prune re-derives the bf16 lists from the current
    coordinates (its candidates stay the group list's)."""
    x, v = _positions(6, 0.1)
    kw = dict(nx=6, ny=6, nz=6, ntimes=8, reneigh_every=10, prune_every=3,
              precision="sp", scheme="cluster", derive_bf16=True)
    sim = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu")
    st = sim.run(repeats=0).state
    pruned = sim._prune(st).pairs
    want = derive_ilists(st.clusters, st.pairs, sim.n_clusters_pad, GROUP,
                         sim.params.cutneigh, sim.icap, share=sim.ishare, bf16=True)
    torch.testing.assert_close(pruned.ijlist, want.ijlist, rtol=0, atol=0)
    exact = derive_ilists(st.clusters, st.pairs, sim.n_clusters_pad, GROUP,
                          sim.params.cutneigh, sim.icap, share=sim.ishare)
    assert int(pruned.nji.sum()) > int(exact.nji.sum())


def _same_bits(make, **kw):
    a = make(Params(**kw)).run(repeats=0)
    b = make(Params(**kw, derive_bf16=True)).run(repeats=0)
    assert torch.equal(torch.as_tensor(a.temps), torch.as_tensor(b.temps))
    return a


def test_dp_run_ignores_the_setting():
    kw = dict(nx=4, ny=4, nz=4, ntimes=10, reneigh_every=5, prune_every=3,
              precision="dp", scheme="cluster")
    assert not ClusterSimulation(Params(**kw, derive_bf16=True), device="cpu")._derive_bf16
    _same_bits(lambda p: ClusterSimulation(p, device="cpu"), **kw)


@pytest.mark.parametrize("engine", ["verlet", "cluster_domain"])
def test_other_engines_ignore_the_setting(engine):
    """The verlet engine and the cluster slab engine accept derive_bf16 and
    run as without it (mdbench_tpu's pass no bf16 to their derives)."""
    if engine == "verlet":
        kw = dict(nx=4, ny=4, nz=4, ntimes=10, reneigh_every=5, precision="sp")
        _same_bits(lambda p: Simulation(p, device="cpu"), **kw)
    else:
        kw = dict(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5, precision="sp",
                  scheme="cluster", kernel="ilist")
        _same_bits(lambda p: ClusterDomainSimulation(p, ndev=2, device="cpu"), **kw)
