"""The port's capacity buckets against mdbench_tpu's, on the CPU: the
planner and the bucket maps (equal, bit for bit), the bucketed LJ force
against mdbench_tpu's Pallas kernel in interpret mode per bucket, the
bucketed EAM passes against `eam_cluster_force_pallas(buckets=)`, the
bucketed counters of `stats.py`, a DP trajectory with a hand-set plan
against mdbench_tpu's run, and in the port alone: the bucketed plain force
equal to the flat one in float64, the grow of an overflowing bucket, the
planner's refusals and the wrappers' argument checks.

Tolerances are relative to max |value|: 1e-5 in float32 (the Pallas
kernels sum in another order), 1e-9 for a 40-step DP trajectory. The CUDA
kernels themselves run only on a card: tests/test_torch_cuda.py."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hand_plan, write_standin_funcfl
from mdbench_tpu import stats as jstats
from mdbench_tpu.config import FF_EAM
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models import eam_tables as jtab
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops import cluster as jcl
from mdbench_tpu.ops.pallas.eam_cluster import eam_cluster_force_pallas
from mdbench_tpu.ops.pallas.lj_cluster import lj_cluster_force_ilist_pallas
from mdbench_tpu_torch import stats as tstats
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.convert import (
    clusters_from_numpy,
    eam_from_numpy,
    halo_from_numpy,
    pairs_from_numpy,
)
from mdbench_tpu_torch.engine_cluster import ClusterSimulation as TSim
from mdbench_tpu_torch.ops import cluster as tcl
from mdbench_tpu_torch.ops import eam_cluster as tec
from mdbench_tpu_torch.ops import lj_cluster as tlj

torch.set_num_threads(1)
CUT2 = 2.5**2


def _rel(a, b):
    a = np.stack([np.asarray(t, np.float64) for t in a])
    b = np.stack([np.asarray(t, np.float64) for t in b])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return np.abs(a - b).max() / np.abs(b).max()


def _nji_131k(seed=0):
    """A list-length histogram like the 131k box's first build (9,792
    units at share 2): 1,600 empty units, 4,100 at 23-30 (1,890 at 30)
    and 4,092 at 31-38."""
    rng = np.random.default_rng(seed)
    nji = np.concatenate([
        np.zeros(1600), np.full(1890, 30), rng.integers(23, 30, 2210),
        rng.integers(31, 39, 4092)]).astype(np.int32)
    return rng.permutation(nji)


def _nji_mixed(seed, nu):
    """Heated-like lengths: 10% empty, a bulk at 26-34, a tail at 8-20."""
    rng = np.random.default_rng(seed)
    nji = rng.integers(26, 35, nu)
    tail = rng.random(nu) < 0.2
    nji[tail] = rng.integers(8, 21, int(tail.sum()))
    nji[rng.random(nu) < 0.1] = 0
    return nji.astype(np.int32)


@pytest.mark.parametrize("case,cap,share,zero_tier", [
    ("131k", 48, 2, True), ("131k", 48, 2, False), ("131k", 56, 1, True),
    ("131k", 48, 4, True), ("mixed", 48, 1, True), ("mixed", 48, 2, False),
    ("mixed", 40, 4, True), ("small", 48, 2, True),
])
def test_planner_equals_jax(case, cap, share, zero_tier):
    nji = {"131k": _nji_131k(), "mixed": _nji_mixed(1, 6000),
           "small": _nji_mixed(2, 4095)}[case]
    got = tcl.plan_capacity_buckets(nji, cap, share, margin=2, zero_tier=zero_tier)
    want = jcl.plan_capacity_buckets(nji, cap, share, margin=2, zero_tier=zero_tier)
    assert got == want
    if case == "small":
        assert got is None  # fewer than 4096 units
    if (case, cap, share, zero_tier) == ("131k", 48, 2, True):
        assert got == ((1536, 4096, 4032, 128), (0, 32, 40, 48))


def _maps_case(kind, seed=0, nu=300, icap=24, share=2, cjn=500):
    """Random lists and a plan: heavy ties in nji, dummy units, or a
    bucket whose cap is below its longest list."""
    rng = np.random.default_rng(seed)
    ijl = rng.integers(0, cjn - 1, (nu, icap)).astype(np.int32)
    nji = (rng.integers(0, 5, nu) * 4).astype(np.int32)  # 5 values: ties
    if kind == "ties":
        sizes, caps = (nu // 2, nu - nu // 2), (8, icap)
    elif kind == "dummies":
        sizes, caps = hand_plan(nji, icap, gran=16)
    else:  # overflow: the middle tier truncates
        sizes, caps = hand_plan(nji, icap, trunc=True)
    return ijl, nji, sizes, caps, share, 2 * cjn


@pytest.mark.parametrize("kind", ["ties", "dummies", "overflow"])
@pytest.mark.parametrize("share", [1, 2])
def test_bucket_maps_equal_jax(kind, share):
    ijl, nji, sizes, caps, _, total_rows = _maps_case(kind, seed=share, share=share)
    nu = nji.size
    args = (nu * share, share, total_rows, sizes, caps)
    want = jcl.bucket_maps_core(jnp.asarray(ijl), jnp.asarray(nji), *args)
    got = tcl.bucket_maps_core(torch.tensor(ijl), torch.tensor(nji), *args)
    for g, w in zip(got, want):
        assert g.dtype == (torch.bool if g.dim() == 0 else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[3]) == (kind == "overflow")
    assert (sum(sizes) > nu) == (kind != "ties")
    # attach_bucket_maps folds bovf into iovf and converts across
    pairs = tcl.ClusterPairList(
        jlist=torch.zeros((1, 1), dtype=torch.int64), nj=torch.zeros(1),
        overflow=torch.zeros(2, dtype=torch.bool), ijlist=torch.tensor(ijl),
        nji=torch.tensor(nji), iovf=torch.tensor(False))
    pb = tcl.attach_bucket_maps(pairs, *args)
    assert bool(pb.iovf) == (kind == "overflow")
    conv = pairs_from_numpy({**pairs._asdict(), "bijlist": np.asarray(want[0]),
                             "bcrows": np.asarray(want[1]),
                             "binv": np.asarray(want[2])}, "cpu")
    for name in ("bijlist", "bcrows", "binv"):
        assert torch.equal(getattr(conv, name), getattr(pb, name))


@pytest.fixture(scope="module")
def lj_case():
    """mdbench_tpu's initial state of a jittered 8^3 SP box (exact lists,
    share 2) and a hand-set plan at the Pallas kernel's granularity (64
    units): a zero tier, a tier at the cap of the median list, a last tier
    with dummy units."""
    kw = dict(nx=8, ny=8, nz=8, precision="sp", kernel="ilist", scheme="cluster")
    x, v, _ = create_fcc_lattice(JParams(**kw))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    sim = JSim(JParams(**kw), x=x, v=v)
    st = sim.initial_state()
    plan = hand_plan(np.asarray(st.pairs.nji), sim.icap, gran=64)
    return sim, st, plan


def test_bucketed_lj_force_matches_pallas(lj_case):
    sim, st, (sizes, caps) = lj_case
    npad, share = sim.n_clusters_pad, sim.ishare
    total_rows = st.clusters.xc.shape[0]
    jp = jcl.attach_bucket_maps(st.pairs, npad, share, total_rows, sizes, caps)
    assert caps[0] == 0 and sizes[0] > 0 and sum(sizes) > npad // share
    assert not bool(jp.iovf)
    # mdbench_tpu: one interpret-mode Pallas call per bucket on the
    # permuted i-planes, then the inverse gather (_force_buckets)
    xc, yc, zc = st.clusters.xc, st.clusters.yc, st.clusters.zc
    xi = [p[jp.bcrows] for p in (xc, yc, zc)]
    parts, off = [], 0
    for n_k, c_k in zip(sizes, caps):
        r0, r1 = off * share, (off + n_k) * share
        if c_k == 0:
            parts.append([jnp.zeros((r1 - r0, 8), xc.dtype)] * 3)
        else:
            parts.append(lj_cluster_force_ilist_pallas(
                xc, yc, zc, jp.bijlist[off : off + n_k, :c_k], r1 - r0, CUT2,
                1.0, 1.0, share=share, interpret=True,
                xi=tuple(p[r0:r1] for p in xi)))
        off += n_k
    f_j = [jnp.concatenate(fs)[jp.binv] for fs in zip(*parts)]
    # the port on the converted state, maps built by the port
    c = clusters_from_numpy(st.clusters, "cpu", torch.float32)
    pr = tcl.attach_bucket_maps(pairs_from_numpy(st.pairs, "cpu"), npad, share,
                                total_rows, sizes, caps)
    for name in ("bijlist", "bcrows", "binv"):
        np.testing.assert_array_equal(getattr(pr, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    before = tlj.BUCKET_LAUNCHES
    f_t = tlj.lj_cluster_force_buckets(
        c.xc, c.yc, c.zc, pr.bijlist, pr.bcrows, pr.binv, pr.nji, npad,
        (sizes, caps), CUT2, 1.0, 1.0, share=share)
    assert tlj.BUCKET_LAUNCHES == before  # the CPU takes the plain twin
    assert np.abs(np.asarray(f_j[0])).max() > 1e-3
    assert _rel(f_t, f_j) <= 1e-5
    # and the flat force within the same limit
    f_flat = tlj.lj_cluster_force_ilist_ref(c.xc, c.yc, c.zc, pr.ijlist, npad,
                                            CUT2, 1.0, 1.0, share=share)
    assert _rel(f_t, f_flat) <= 1e-5


def test_bucketed_counters_equal_jax(lj_case):
    sim, st, plan = lj_case
    npad, share = sim.n_clusters_pad, sim.ishare
    c = clusters_from_numpy(st.clusters, "cpu", torch.float32)
    pr = tcl.attach_bucket_maps(pairs_from_numpy(st.pairs, "cpu"), npad, share,
                                st.clusters.xc.shape[0], *plan)
    cut = (CUT2, 2.8**2)
    got = tstats.compute_cluster_stats(c, pr, npad, 16, *cut, buckets=plan)
    jpairs = SimpleNamespace(ijlist=st.pairs.ijlist, nji=st.pairs.nji,
                             bijlist=jnp.asarray(pr.bijlist.numpy()))
    want = jstats.compute_cluster_stats(st.clusters, jpairs, npad, 16, *cut,
                                        buckets=plan)
    assert got == {k: int(v) for k, v in want.items()}
    flat = tstats.compute_cluster_stats(c, pr, npad, 16, *cut)
    assert got["padded_pairs"] == sum(n * share * 8 * k * 16 for n, k in zip(*plan))
    assert got["padded_pairs"] < flat["padded_pairs"]
    assert {k: v for k, v in got.items() if k not in ("tiles", "padded_pairs")} == {
        k: v for k, v in flat.items() if k not in ("tiles", "padded_pairs")}


def test_bucketed_eam_matches_pallas(tmp_path):
    """The 6x6x4 box of tests/test_eam_cluster.py on the stand-in funcfl,
    jittered by 0.15 A (float32 rounding near the lattice, as in
    tests/test_torch_eam.py), with a two-tier plan at the Pallas
    granularity plus a zero tier and dummy units."""
    eam_file = str(tmp_path / "standin.eam")
    write_standin_funcfl(eam_file)
    kw = dict(nx=6, ny=6, nz=4, scheme="cluster", precision="sp",
              force_field=FF_EAM, eam_file=eam_file, kernel="ilist")
    tables = jtab.load_eam(eam_file)
    x, v, _ = create_fcc_lattice(jtab.apply_eam_overrides(JParams(**kw), tables))
    x = x + np.random.default_rng(3).normal(0.0, 0.15, x.shape)
    sim = JSim(JParams(**kw), x=x, v=v)
    st = sim.initial_state()
    npad, share = sim.n_clusters_pad, sim.ishare
    sizes, caps = plan = hand_plan(np.asarray(st.pairs.nji), sim.icap, gran=64)
    total_rows = st.clusters.xc.shape[0]
    jp = jcl.attach_bucket_maps(st.pairs, npad, share, total_rows, sizes, caps)
    assert not bool(jp.iovf) and sum(sizes) > npad // share
    args = (st.clusters.xc, st.clusters.yc, st.clusters.zc, st.pairs.ijlist,
            st.halo.border_map, npad, sim.params.cutforce**2, sim.eam_dev,
            sim.eam_poly)
    *f_j, fp_j = eam_cluster_force_pallas(
        *args, share=share, interpret=True, buckets=plan,
        bpairs=(jp.bijlist, jp.bcrows, jp.binv))
    c = clusters_from_numpy(st.clusters, "cpu", torch.float32)
    pr = tcl.attach_bucket_maps(pairs_from_numpy(st.pairs, "cpu"), npad, share,
                                total_rows, sizes, caps)
    halo = halo_from_numpy(st.halo, "cpu", torch.float32)
    eam_t, poly_t = eam_from_numpy(sim.eam_dev, sim.eam_poly, "cpu", torch.float32)
    before = dict(tec.LAUNCHES)
    *f_t, fp_t = tec.eam_cluster_force(
        c.xc, c.yc, c.zc, pr.ijlist, pr.nji, halo.border_map, npad,
        sim.params.cutforce**2, eam_t, poly_t, share=share, buckets=plan,
        bpairs=(pr.bijlist, pr.bcrows, pr.binv))
    assert tec.LAUNCHES == before
    assert np.abs(np.asarray(f_j[0])).max() > 1e-3
    assert _rel(f_t, f_j) <= 1e-5
    assert _rel([fp_t], [fp_j]) <= 1e-5
    # the bucketed passes against the flat ones
    *f_flat, _ = tec.eam_cluster_force_ref(
        c.xc, c.yc, c.zc, pr.ijlist, halo.border_map, npad,
        sim.params.cutforce**2, eam_t, poly_t, share=share)
    assert _rel(f_t, f_flat) <= 1e-5


def _dp_box(n=6, seed=3, **kw):
    p = dict(nx=n, ny=n, nz=n, precision="dp", scheme="cluster", **kw)
    x, v, _ = create_fcc_lattice(JParams(**p))
    return p, x + np.random.default_rng(seed).normal(0.0, 0.05, x.shape), v


def _planned(sim, **plan_kw):
    """`sim` with a hand-set plan from its first build's lists."""
    nji = sim.initial_state().pairs.nji.numpy()
    sim.buckets = hand_plan(nji, sim.icap, **plan_kw)
    return sim


def test_bucketed_plain_force_equals_flat_f64():
    """In float64 the bucketed plain force is the flat one bit for bit:
    each unit sums the same listed pairs in the same order; the zero tier's
    and the padding units' rows are exactly 0."""
    p, x, v = _dp_box(8)
    flat = TSim(TParams(**p), x=x, v=v, device="cpu").initial_state()
    sim = _planned(TSim(TParams(**p), x=x, v=v, device="cpu"))
    st = sim.initial_state()
    assert st.pairs.bijlist is not None and not bool(st.pairs.iovf)
    for a, b in zip((st.fxc, st.fyc, st.fzc), (flat.fxc, flat.fyc, flat.fzc)):
        assert torch.equal(a, b)
    units = st.pairs.binv.long().reshape(-1, sim.ishare)[:, 0] // sim.ishare
    zero_tier = units < sim.buckets[0][0]
    assert zero_tier.sum() == sim.buckets[0][0] > 0
    f = st.fxc.reshape(-1, sim.ishare * 8)
    assert (f[zero_tier] == 0).all()
    real = st.clusters.atom_id.reshape(-1, sim.ishare * 8) >= 0
    assert (f[~real.any(1)] == 0).all()


def test_bucketed_trajectory_matches_jax():
    """40 DP steps of a jittered 6^3 box with a hand-set plan (cheap
    rebuilds at 10 and 30, full re-clusters at 20 and 40) against
    mdbench_tpu's kernel="ilist" run."""
    p, x, v = _dp_box(6, ntimes=40, reneigh_every=10, resort_every=20)
    r_j = JSim(JParams(**p, kernel="ilist"), x=x, v=v).run()
    sim = _planned(TSim(TParams(**p), x=x, v=v, device="cpu"))
    plan = sim.buckets
    r_t = sim.run()
    assert sim.buckets[0] == plan[0] and r_t.state.pairs.bijlist is not None
    np.testing.assert_allclose(r_t.temps, r_j.temps, rtol=1e-9)
    np.testing.assert_allclose(r_t.press, r_j.press, rtol=1e-9)


def test_bucket_overflow_grows_caps():
    """A cap of 8 on the middle tier overflows (counterpart of
    tests/test_buckets.py:45-52): run() grows every cap by 8 and the
    last to the new icap (mdbench_tpu's _grow), then finishes with the
    unbucketed trajectory."""
    p, x, v = _dp_box(6, ntimes=4)
    ref = TSim(TParams(**p), x=x, v=v, device="cpu").run()
    sim = _planned(TSim(TParams(**p), x=x, v=v, device="cpu"))
    sizes, caps = sim.buckets
    sim.buckets = (sizes, (0, 8, caps[2]))
    out = sim.run()
    n = len(sim.grows)
    assert n >= 1 and all(g == "ilist_nji" for g in sim.grows)
    assert sim.buckets[0] == sizes
    assert sim.buckets[1][:2] == (8 * n, 8 + 8 * n) and sim.buckets[1][2] >= sim.icap
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)


@pytest.mark.parametrize("kw", [
    {"kernel": "ilist"}, {"kernel": "pallas"}, {"kernel": "xla"}, {"typed": True},
    {"small": True},
])
def test_plan_buckets_refusals(kw):
    """_plan_buckets plans only on kernel "ilist_pl"/"auto" untyped runs,
    and the planner only for boxes of 4096 units or more."""
    kw = dict(kw)
    extra = {}
    if kw.pop("typed", False):
        extra = dict(types=np.zeros(256, np.int32),
                     tables=tuple(np.full((2, 2), val) for val in (1.0, 1.0, CUT2)))
    small = kw.pop("small", False)
    sim = TSim(TParams(nx=4, ny=4, nz=4, scheme="cluster", **kw), device="cpu",
               **extra)
    big = _nji_131k()
    assert sim._plan_buckets(np.zeros(16, np.int32) if small else big) is False
    assert sim.buckets is None
    ok = TSim(TParams(nx=4, ny=4, nz=4, scheme="cluster"), device="cpu")
    ok.icap = 48
    assert ok._plan_buckets(big) is True
    assert ok.buckets == tcl.plan_capacity_buckets(big, 48, 2, margin=2,
                                                   zero_tier=True)
    assert ok._plan_buckets(big) is False  # once


def _bucket_args():
    p, x, v = _dp_box(4)
    sim = _planned(TSim(TParams(**p), x=x, v=v, device="cpu"))
    st = sim.initial_state()
    pr = st.pairs
    return dict(xc=st.clusters.xc, yc=st.clusters.yc, zc=st.clusters.zc,
                bijlist=pr.bijlist, bcrows=pr.bcrows, binv=pr.binv, nji=pr.nji,
                n_clusters_pad=sim.n_clusters_pad, buckets=sim.buckets,
                share=sim.ishare)


def test_bucket_wrappers_on_cpu_and_other_devices():
    a = _bucket_args()
    lj_args = (a["xc"], a["yc"], a["zc"], a["bijlist"], a["bcrows"], a["binv"],
               a["nji"], a["n_clusters_pad"], a["buckets"], CUT2, 1.0, 1.0)
    f = tlj.lj_cluster_force_buckets(*lj_args, share=a["share"])
    want = tlj.lj_cluster_force_buckets_ref(
        *lj_args[:6], *lj_args[7:], share=a["share"])
    assert all(torch.equal(x, y) for x, y in zip(f, want))
    meta = [t.to("meta") if torch.is_tensor(t) else t for t in lj_args]
    with pytest.raises(ValueError, match="no force kernel"):
        tlj.lj_cluster_force_buckets(*meta, share=a["share"])
    with pytest.raises(ValueError, match="no EAM kernel"):
        tec.eam_rho_buckets(*meta[:8], CUT2, None, a["buckets"], share=a["share"])


@pytest.mark.parametrize("bad,exc", [
    (lambda a: {**a, "bijlist": a["bijlist"].long()}, TypeError),
    (lambda a: {**a, "nji": a["nji"].long()}, TypeError),
    (lambda a: {**a, "bcrows": a["bcrows"][:-1]}, ValueError),
    (lambda a: {**a, "bijlist": a["bijlist"][:-1]}, ValueError),
    (lambda a: {**a, "binv": a["binv"][:-2]}, ValueError),
    (lambda a: {**a, "buckets": (a["buckets"][0], a["buckets"][1][:-1])}, ValueError),
    (lambda a: {**a, "buckets": ((1,) * 33, (8,) * 33)}, ValueError),
    (lambda a: {**a, "buckets": (a["buckets"][0], (-1,) + a["buckets"][1][1:])},
     ValueError),
    (lambda a: {**a, "share": 3}, ValueError),
    (lambda a: {**a, "n_clusters_pad": a["n_clusters_pad"] + 2}, ValueError),
])
def test_bucket_argument_checks_raise(bad, exc):
    """The checks the bucketed kernels' wrappers make before a launch."""
    a = _bucket_args()
    tlj._check_bucket_args(**a)  # the good arguments pass
    with pytest.raises(exc):
        tlj._check_bucket_args(**bad(a))
