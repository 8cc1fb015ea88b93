"""The port's group-window family against mdbench_tpu's, on the CPU: the
group lists with their tile windows (`build_cluster_pairs(need_ranges=
True)`), the windows' refresh (the prune), the plain group-list force
against the XLA twin and the windowed one against the Pallas stream
kernel in interpret mode, the Newton half-list force, the engine on the
kernel axis ("pallas", "xla", half_neigh=1, the prune), convert.py's
windows, check_slice, and the stream wrapper's device rule and argument
checks.

Tolerances are relative to max |f|: 1e-12 in float64 and 1e-5 in float32
for one force evaluation (only the summation order differs), 1e-10 for
step-0 forces and 1e-9 for a short trajectory (rounding differences grow
along it); a run with the prune must give the run without it to rtol
1e-12 (the windows only drop pairs beyond cutneigh). The CUDA kernel
itself runs only on a card: tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_group_lists
from mdbench_tpu.config import FF_EAM
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops.cluster import refresh_pair_ranges as j_refresh
from mdbench_tpu.ops.pallas.lj_cluster import (
    lj_cluster_force_pallas_stream,
    lj_cluster_force_xla,
    lj_cluster_force_xla_half,
)
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.convert import clusters_from_numpy, pairs_from_numpy
from mdbench_tpu_torch.engine_cluster import ClusterSimulation as TSim
from mdbench_tpu_torch.engine_cluster import check_slice
from mdbench_tpu_torch.ops import lj_cluster as tlj
from mdbench_tpu_torch.ops.cluster import refresh_pair_ranges as t_refresh

torch.set_num_threads(1)

CUT2, SIG6, EPS = 2.5**2, 1.0, 1.0
TOL = {np.float64: 1e-12, np.float32: 1e-5}
T_OF = {np.float64: torch.float64, np.float32: torch.float32}
# a jittered 4^3 box (256 atoms) with a short run at both rebuild kinds
KW = dict(nx=4, ny=4, nz=4, ntimes=16, reneigh_every=8, resort_every=16,
          precision="dp", scheme="cluster")


@functools.lru_cache(maxsize=None)
def _positions():
    x, v, _ = create_fcc_lattice(JParams(**KW))
    return x + np.random.default_rng(11).normal(0.0, 0.1, x.shape), v


@functools.lru_cache(maxsize=None)
def _jax_xla():
    """mdbench_tpu's kernel="xla" engine on the jittered box, its initial
    state (group lists with windows) as numpy, and its run."""
    x, v = _positions()
    sim = JSim(JParams(**KW, kernel="xla"), x=x, v=v)
    st = jax.jit(sim.initial_state)()
    cl = {k: np.asarray(getattr(st.clusters, k)) for k in ("xc", "yc", "zc", "bbox")}
    pairs = {k: np.asarray(getattr(st.pairs, k))
             for k in ("jlist", "ranges", "nj", "overflow")}
    return sim, st, cl, pairs, sim.run()


def _rel(a, b):
    a = np.stack([np.asarray(t, np.float64) for t in a])
    b = np.stack([np.asarray(t, np.float64) for t in b])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return np.abs(a - b).max() / np.abs(b).max()


def _zsorted(jl, zmin16):
    """The ids of a list in (zmin, id) order."""
    return jl[np.lexsort((jl, zmin16[jl]))]


def test_group_lists_and_windows_match_jax():
    """The same flat positions through both list builds: nj, the first
    nj entries and the windows equal. Ghost images shifted along x or y
    share their owner's zmin exactly, and mdbench_tpu's unstable sort may
    place such ties in either order, so the entries are compared in
    (zmin, id) order, the port's own."""
    sj, _, _, pj, _ = _jax_xla()
    st = TSim(TParams(**KW, kernel="pallas"), x=sj._x0, v=sj._v0, device="cpu")
    assert (st.ishare, st.n_clusters_pad) == (sj.ishare, sj.n_clusters_pad)
    cl, _, _, pt, ovf = st._reneighbor_from_flat(st.x_flat0, st.v_flat0)
    assert pt.jlist.shape[1] == pj["jlist"].shape[2]  # the same list_cap
    assert not ovf.any() and pt.ijlist is None
    nj = pj["nj"]
    np.testing.assert_array_equal(pt.nj.numpy(), nj)
    bb = cl.bbox.numpy().reshape(-1, 2, 8)
    zmin16 = np.minimum(bb[:, 0, 4], bb[:, 1, 4])
    jl_j = pj["jlist"][:, 0]
    jl_t = pt.jlist.numpy()
    sentinel16 = cl.xc.shape[0] // 2 - 1
    for g, n in enumerate(nj):
        np.testing.assert_array_equal(jl_t[g, :n], _zsorted(jl_t[g, :n], zmin16))
        np.testing.assert_array_equal(jl_t[g, :n], _zsorted(jl_j[g, :n], zmin16))
        assert (jl_t[g, n:] == sentinel16).all()
    # mdbench_tpu leaves real ids past nj; the port writes the sentinel
    assert any((jl_j[g, n:] != sentinel16).any() for g, n in enumerate(nj))
    np.testing.assert_array_equal(pt.ranges.numpy(), pj["ranges"][:, 0])
    assert pt.ranges.dtype == torch.int32
    r = pt.ranges.numpy()
    assert (r[:, :16] > 0).any() and (r[:, 16:32] < r[:, 32:]).any()


def test_pairs_from_numpy_carries_ranges():
    _, st, _, pj, _ = _jax_xla()
    pt = pairs_from_numpy(st.pairs, "cpu")
    ng = pj["nj"].shape[0]
    assert pt.ranges.shape == (ng, 33) and pt.ranges.dtype == torch.int32
    np.testing.assert_array_equal(pt.ranges.numpy(), pj["ranges"][:, 0])
    assert pt.ijlist is None and pt.nji is None and pt.iovf is None
    assert pairs_from_numpy({k: v for k, v in pj.items() if k != "ranges"},
                            "cpu").ranges is None


def _perturbed(cl, sigma=0.2, seed=9):
    rng = np.random.default_rng(seed)
    out = dict(cl)
    for k in ("xc", "yc", "zc"):
        real = np.abs(cl[k]) < 1e29
        out[k] = np.where(real, cl[k] + rng.normal(0.0, sigma, cl[k].shape), cl[k])
    return out


def test_refresh_pair_ranges_matches_jax():
    """The prune's window refresh after a perturbation of the planes, on
    mdbench_tpu's lists (real ids past nj included)."""
    sj, st, cl, pj, _ = _jax_xla()
    cp = _perturbed(cl)
    cj = st.clusters._replace(**{k: jnp.asarray(cp[k]) for k in ("xc", "yc", "zc")})
    r_j = np.asarray(j_refresh(cj, st.pairs, sj.n_clusters_pad, 16,
                               sj.params.cutneigh).ranges)[:, 0]
    r_t = t_refresh(clusters_from_numpy({**cp, "atom_id": np.zeros(1),
                                         "inv_map": np.zeros(1)}, "cpu", torch.float64),
                    pairs_from_numpy(pj, "cpu"), sj.n_clusters_pad, 16,
                    sj.params.cutneigh).ranges.numpy()
    assert (r_j != pj["ranges"][:, 0]).any()  # the perturbation moved windows
    np.testing.assert_array_equal(r_t, r_j)


def _planes(cl, np_dtype):
    c = clusters_from_numpy({"bbox": np.zeros(1), **cl, "atom_id": np.zeros(1),
                             "inv_map": np.zeros(1)}, "cpu", T_OF[np_dtype])
    return (c.xc, c.yc, c.zc), [jnp.asarray(cl[k].astype(np_dtype))
                                for k in ("xc", "yc", "zc")]


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
def test_plain_group_force_matches_xla(np_dtype):
    """Without windows: mdbench_tpu's lj_cluster_force_xla, on the
    perturbed planes and mdbench_tpu's lists, in small chunks."""
    sj, _, cl, pj, _ = _jax_xla()
    cp = _perturbed(cl)
    tp, jp = _planes(cp, np_dtype)
    npad = sj.n_clusters_pad
    f_j = lj_cluster_force_xla(*jp, jnp.asarray(pj["jlist"]), npad, 16, CUT2,
                               SIG6, EPS)
    f_t = tlj.lj_cluster_force_group_ref(
        *tp, torch.tensor(pj["jlist"][:, 0]), npad, CUT2, SIG6, EPS,
        max_elems=1 << 18)
    assert np.abs(np.asarray(f_j[0])).max() > 1.0
    assert _rel(f_t, f_j) <= TOL[np_dtype]


def _random_case():
    planes, jl, rg, npad = random_group_lists(seed=4)
    return {"xc": planes[0], "yc": planes[1], "zc": planes[2]}, jl, rg, npad


@pytest.mark.parametrize("name", ["random", "engine"])
def test_windowed_force_matches_stream_interpret(name):
    """With windows: the Pallas stream kernel in interpret mode, float32,
    on random windows (inner, empty, past njg; an all-padding group;
    sentinel and real ids past nj) and on mdbench_tpu's own lists, cut
    to the widest window's tiles (no tile at or past njg is read)."""
    if name == "random":
        cl, jl, rg, npad = _random_case()
    else:
        sj, _, cl, pj, _ = _jax_xla()
        cl = _perturbed(cl, 0.05)
        rg = pj["ranges"][:, 0]
        jl = pj["jlist"][:, 0, : 8 * int(rg[:, 32].max())]
        npad = sj.n_clusters_pad
    tp, jp = _planes(cl, np.float32)
    f_p = lj_cluster_force_pallas_stream(
        *jp, jnp.asarray(jl[:, None, :]), jnp.asarray(rg[:, None, :]), npad, 16,
        CUT2, SIG6, EPS, interpret=True)
    f_t = tlj.lj_cluster_force_group_ref(
        *tp, torch.tensor(jl), npad, CUT2, SIG6, EPS, ranges=torch.tensor(rg))
    assert np.abs(np.asarray(f_p[0])).max() > 1.0
    assert _rel(f_t, f_p) <= TOL[np.float32]
    if name == "random":  # the all-padding group's rows
        for f in f_t:
            assert (f[16:32] == 0).all()


def test_half_force_matches_jax_and_full():
    sj, _, cl, pj, _ = _jax_xla()
    cp = _perturbed(cl)
    tp, jp = _planes(cp, np.float64)
    npad = sj.n_clusters_pad
    f_j = lj_cluster_force_xla_half(*jp, jnp.asarray(pj["jlist"]), npad, 16,
                                    CUT2, SIG6, EPS)
    jl = torch.tensor(pj["jlist"][:, 0])
    f_t = tlj.lj_cluster_force_half_ref(*tp, jl, npad, CUT2, SIG6, EPS,
                                        max_elems=1 << 18)
    f_full = tlj.lj_cluster_force_group_ref(*tp, jl, npad, CUT2, SIG6, EPS)
    assert _rel(f_t, f_j) <= TOL[np.float64]
    assert _rel(f_t, f_full) <= 1e-9


def test_engine_pallas_matches_jax_xla():
    """Port kernel="pallas" on the CPU against mdbench_tpu kernel="xla":
    step-0 forces and the 16-step trajectory (both rebuild kinds)."""
    sj, _, _, _, r_j = _jax_xla()
    sim = TSim(TParams(**KW, kernel="pallas"), x=sj._x0, v=sj._v0, device="cpu")
    f_t = sim.first_force_atoms()
    f_j = sj.first_force_atoms()
    assert np.abs(f_t - f_j).max() <= 1e-10 * np.abs(f_j).max()
    r_t = sim.run()
    assert sim.grows == []
    np.testing.assert_allclose(r_t.temps, r_j.temps, rtol=1e-9)
    np.testing.assert_allclose(r_t.press, r_j.press, rtol=1e-9)


def test_prune_keeps_the_trajectory():
    """prune_every=3 within reneigh_every=8 (prunes after plain steps 3
    and 6 of each interval) against no prune on the group-window path,
    and against mdbench_tpu's unpruned run."""
    sj, _, _, _, r_j = _jax_xla()
    x, v = sj._x0, sj._v0
    runs = [TSim(TParams(**KW, kernel="pallas", prune_every=pe), x=x, v=v,
                 device="cpu") for pe in (0, 3)]
    calls = []
    orig = runs[1]._prune
    runs[1]._prune = lambda s: (calls.append(1), orig(s))[1]
    r0, r3 = (s.run() for s in runs)
    # 2 prunes per interval, 2 intervals, in run()'s checked and timed runs
    assert len(calls) == 2 * 2 * 2
    np.testing.assert_allclose(r3.temps, r0.temps, rtol=1e-12, atol=0)
    np.testing.assert_allclose(r3.temps, r_j.temps, rtol=1e-9)


def test_exact_list_prune_matches_jax():
    """The prune on the exact-list path re-derives the unit lists against
    cutneigh from current coordinates. On this hot box that drops pairs
    which come back inside the cutoff before the next rebuild, in
    mdbench_tpu as in the port (ROADMAP.md, section 3), so the pruned run
    is held against mdbench_tpu's pruned run, not against the unpruned
    one."""
    x, v = _positions()
    kw = dict(KW, prune_every=3)
    r_j = JSim(JParams(**kw, kernel="ilist"), x=x, v=v).run()
    r_t = TSim(TParams(**kw), x=x, v=v, device="cpu").run()
    np.testing.assert_allclose(r_t.temps, r_j.temps, rtol=1e-9)


def test_half_neigh_engine_matches_jax():
    x, v = _positions()
    kw = dict(KW, half_neigh=1)
    sj = JSim(JParams(**kw), x=x, v=v)
    st = TSim(TParams(**kw), x=x, v=v, device="cpu")
    assert (st.ishare, st.list_cap) == (sj.ishare, sj.list_cap)
    f_j = sj.first_force_atoms()
    assert np.abs(st.first_force_atoms() - f_j).max() <= 1e-10 * np.abs(f_j).max()
    np.testing.assert_allclose(st.run().temps, sj.run().temps, rtol=1e-9)


@pytest.mark.parametrize("kernel", ["pallas", "xla", "ilist", "ilist_pl"])
def test_check_slice_accepts_the_kernel_axis(kernel):
    p = TParams(scheme="cluster", nx=4, ny=4, nz=4, kernel=kernel,
                half_neigh=1, prune_every=5)
    check_slice(p)
    TSim(p, device="cpu")


def test_unknown_kernel_name_raises():
    with pytest.raises(ValueError, match="kernel must be one of"):
        TSim(TParams(scheme="cluster", nx=4, ny=4, nz=4, kernel="stream"),
             device="cpu")


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_eam_on_the_group_path_raises_jax_error(tmp_path, kernel):
    from chip_smoke import write_standin_funcfl

    eam = tmp_path / "standin.eam"
    write_standin_funcfl(eam)
    kw = dict(nx=4, ny=4, nz=4, scheme="cluster", force_field=FF_EAM,
              eam_file=str(eam), kernel=kernel)
    with pytest.raises(ValueError) as e_j:
        JSim(JParams(**kw))
    with pytest.raises(ValueError) as e_t:
        TSim(TParams(**kw), device="cpu")
    assert str(e_t.value) == str(e_j.value)


def _stream_args():
    cl, jl, rg, npad = _random_case()
    tp, _ = _planes(cl, np.float32)
    return dict(xc=tp[0], yc=tp[1], zc=tp[2], jlist=torch.tensor(jl),
                ranges=torch.tensor(rg), n_clusters_pad=npad)


def test_stream_wrapper_on_cpu_is_the_plain_version():
    a = _stream_args()
    before = tlj.STREAM_LAUNCHES
    f_w = tlj.lj_cluster_force_stream(**a, cutforcesq=CUT2, sigma6=SIG6,
                                      epsilon=EPS)
    f_r = tlj.lj_cluster_force_group_ref(
        a["xc"], a["yc"], a["zc"], a["jlist"], a["n_clusters_pad"], CUT2,
        SIG6, EPS, ranges=a["ranges"])
    for x, y in zip(f_w, f_r):
        assert torch.equal(x, y)
    assert tlj.STREAM_LAUNCHES == before


def test_stream_wrapper_refuses_other_devices():
    a = {k: (v.to("meta") if torch.is_tensor(v) else v)
         for k, v in _stream_args().items()}
    before = tlj.STREAM_LAUNCHES
    with pytest.raises(ValueError, match="no force kernel"):
        tlj.lj_cluster_force_stream(**a, cutforcesq=CUT2, sigma6=SIG6,
                                    epsilon=EPS)
    assert tlj.STREAM_LAUNCHES == before


@pytest.mark.parametrize("bad,exc", [
    (lambda a: {**a, "xc": a["xc"].double()}, ValueError),
    (lambda a: {**a, "xc": a["xc"].half(), "yc": a["yc"].half(),
                "zc": a["zc"].half()}, TypeError),
    (lambda a: {**a, "jlist": a["jlist"].long()}, TypeError),
    (lambda a: {**a, "ranges": a["ranges"].long()}, TypeError),
    (lambda a: {**a, "jlist": a["jlist"][:, :-4].contiguous()}, ValueError),
    (lambda a: {**a, "ranges": a["ranges"][:, :-1].contiguous()}, ValueError),
    (lambda a: {**a, "jlist": a["jlist"].t().contiguous().t()}, ValueError),
    (lambda a: {**a, "n_clusters_pad": a["n_clusters_pad"] + 16}, ValueError),
])
def test_stream_argument_checks_raise(bad, exc):
    a = _stream_args()
    tlj._check_stream_args(**a)  # the good arguments pass
    with pytest.raises(exc):
        tlj._check_stream_args(**bad(a))
