"""Typed (EXPLICIT_TYPES) cluster LJ runs of the port against mdbench_tpu's,
on the CPU: the type plane of the clusters and its ghost rows, the typed
plain forces against mdbench_tpu's typed XLA forms and against its typed
Pallas kernels in interpret mode, convert.py's type plane and tables, the
EAM refusal, check_slice, and the typed wrappers' argument checks. The
typed engine runs are in tests/test_torch_typed_engine.py.

The case: a jittered 4^3 box (256 atoms) in float64 with two random types
and the non-uniform tables of tests/test_cluster.py (eps 1.0 / 0.7 / 1.3,
sigma 1.0 / 0.95 / 1.05, cutoff 2.5 everywhere). Tolerances are relative to
max |f|: 1e-12 in float64 and 1e-5 in float32 for one force evaluation
(only the summation order differs). The CUDA
kernels themselves run only on a card: tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu.config import FF_EAM
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops.pallas.lj_cluster import (
    lj_cluster_force_ilist_pallas,
    lj_cluster_force_pallas_stream,
    lj_cluster_force_xla,
    lj_cluster_force_xla_half,
    lj_cluster_force_xla_ilist,
)
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.convert import (
    clusters_from_numpy,
    pairs_from_numpy,
    step_state_from_numpy,
    tables_from_numpy,
)
from mdbench_tpu_torch.engine_cluster import ClusterSimulation as TSim
from mdbench_tpu_torch.engine_cluster import check_slice
from mdbench_tpu_torch.ops import lj_cluster as tlj
from mdbench_tpu_torch.ops.cluster import update_cluster_pbc

torch.set_num_threads(1)

KW = dict(nx=4, ny=4, nz=4, ntimes=16, reneigh_every=8, resort_every=16,
          precision="dp", scheme="cluster")
CUT2 = 2.5**2
TABLES = (np.array([[1.0, 0.7], [0.7, 1.3]]),
          np.array([[1.0, 0.95], [0.95, 1.05]]) ** 6,
          np.full((2, 2), CUT2))
# the port's kernel names and the mdbench_tpu engine each is held against
# (on the CPU mdbench_tpu's "auto" is its exact-list XLA twin; its
# "pallas" engine runs the kernel in interpret mode, too slow for tier-1,
# so the port's "pallas" is held against mdbench_tpu's "xla")
ENGINES = {
    "auto": {"kernel": "auto"},
    "ilist": {"kernel": "ilist"},
    "xla": {"kernel": "xla"},
    "pallas": {"kernel": "pallas"},
    "half": {"half_neigh": 1},
}
JAX_OF = {"auto": "auto", "ilist": "auto", "xla": "xla", "pallas": "xla",
          "half": "half"}


@functools.lru_cache(maxsize=None)
def _case():
    """Jittered positions, lattice velocities and two random types."""
    x, v, _ = create_fcc_lattice(JParams(**KW))
    x = x + np.random.default_rng(11).normal(0.0, 0.1, x.shape)
    types = np.random.default_rng(2).integers(0, 2, x.shape[0]).astype(np.int32)
    return x, v, types


@functools.lru_cache(maxsize=None)
def _jax(name):
    """mdbench_tpu's typed engine `name` (see JAX_OF), its initial state
    and its run."""
    x, v, types = _case()
    sim = JSim(JParams(**KW, **ENGINES[name]), x=x, v=v, types=types,
               tables=TABLES)
    st = jax.jit(sim.initial_state)()
    return sim, st, sim.run()


def _port(name, **kw):
    x, v, types = _case()
    return TSim(TParams(**KW, **ENGINES[name]), x=x, v=v, types=types,
                tables=TABLES, device="cpu", **kw)


def _rel(a, b):
    a = np.stack([np.asarray(t, np.float64) for t in a])
    b = np.stack([np.asarray(t, np.float64) for t in b])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return np.abs(a - b).max() / np.abs(b).max()


def test_type_planes_and_ghost_types_match_jax():
    """The same atoms through both cluster builds: the int32 type plane
    equals mdbench_tpu's float-encoded one on every row (local, ghost,
    padding and sentinel), and update_cluster_pbc(update_bbox=True)
    rewrites the ghost rows' types from their owners."""
    sj, stj, _ = _jax("auto")
    st = _port("auto")
    cl, _, halo, _, ovf = st._reneighbor_from_flat(st.x_flat0, st.v_flat0)
    assert not ovf.any() and cl.tc.dtype == torch.int32
    tc_j = np.asarray(stj.clusters.tc)
    np.testing.assert_array_equal(cl.tc.numpy(), tc_j.astype(np.int32))
    npad = st.n_clusters_pad
    nghost_rows = 2 * int(halo.nghost)
    ghosts = cl.tc[npad : npad + nghost_rows]
    assert (ghosts == 1).any() and (ghosts == 0).any()
    aid = cl.atom_id.numpy()
    np.testing.assert_array_equal(cl.tc[:npad].numpy()[aid >= 0],
                                  _case()[2][aid[aid >= 0]])
    assert (cl.tc[:npad].numpy()[aid < 0] == 0).all()
    cl.tc[npad:] = 0
    update_cluster_pbc(cl, halo, npad, update_bbox=False)
    assert (cl.tc[npad:] == 0).all()  # a plain step leaves the types alone
    update_cluster_pbc(cl, halo, npad, update_bbox=True)
    np.testing.assert_array_equal(cl.tc.numpy(), tc_j.astype(np.int32))


def _perturbed_planes(stj, np_dtype, sigma=0.1, seed=9):
    """mdbench_tpu's initial planes, real atoms moved by N(0, sigma), as
    (port planes, jax planes) in np_dtype."""
    rng = np.random.default_rng(seed)
    tp, jp = [], []
    for k in ("xc", "yc", "zc"):
        p = np.asarray(getattr(stj.clusters, k))
        p = np.where(np.abs(p) < 1e29, p + rng.normal(0.0, sigma, p.shape), p)
        tp.append(torch.tensor(p.astype(np_dtype)))
        jp.append(jnp.asarray(p.astype(np_dtype)))
    return tp, jp


@pytest.mark.parametrize("form", ["ilist", "group", "half"])
def test_typed_plain_forces_match_xla(form):
    """The typed plain versions against mdbench_tpu's typed XLA forms, on
    mdbench_tpu's lists and perturbed planes, float64."""
    sj, stj, _ = _jax("auto")
    tp, jp = _perturbed_planes(stj, np.float64)
    npad = sj.n_clusters_pad
    tc_j = stj.clusters.tc
    tc_t = torch.tensor(np.asarray(tc_j).astype(np.int32))
    tabs = tables_from_numpy(sj.type_tables, "cpu", torch.float64)
    scal = (CUT2, 1.0, 1.0)
    pr = stj.pairs
    if form == "ilist":
        f_j = lj_cluster_force_xla_ilist(*jp, pr.ijlist, npad, *scal, tc=tc_j,
                                         tables=sj._tables_jnp, share=sj.ishare)
        f_t = tlj.lj_cluster_force_ilist_ref(
            *tp, torch.tensor(np.asarray(pr.ijlist)), npad, *scal,
            share=sj.ishare, tc=tc_t, tables=tabs)
    else:
        jl = torch.tensor(np.asarray(pr.jlist)[:, 0])
        xla = lj_cluster_force_xla if form == "group" else lj_cluster_force_xla_half
        ref = (tlj.lj_cluster_force_group_ref if form == "group"
               else tlj.lj_cluster_force_half_ref)
        f_j = xla(*jp, pr.jlist, npad, 16, *scal, tc=tc_j, tables=sj._tables_jnp)
        f_t = ref(*tp, jl, npad, *scal, max_elems=1 << 18, tc=tc_t, tables=tabs)
    assert np.abs(np.asarray(f_j[0])).max() > 1.0
    assert _rel(f_t, f_j) <= 1e-12
    # the same call untyped gives another force: the tables matter here
    f_u = (tlj.lj_cluster_force_ilist_ref(*tp, torch.tensor(np.asarray(pr.ijlist)),
                                          npad, *scal, share=sj.ishare)
           if form == "ilist" else ref(*tp, jl, npad, *scal))
    assert _rel(f_u, f_j) > 1e-3


@pytest.mark.parametrize("kernel", ["ilist", "stream"])
def test_typed_plain_matches_pallas_interpret(kernel):
    """The typed plain versions against mdbench_tpu's typed Pallas kernels
    in interpret mode (K1's and K4's `tables` branches), float32, on
    mdbench_tpu's own lists (the windows' lists cut to the widest
    window's tiles: no tile at or past njg is read)."""
    sj, stj, _ = _jax("auto" if kernel == "ilist" else "xla")
    tp, jp = _perturbed_planes(stj, np.float32, sigma=0.05)
    npad = sj.n_clusters_pad
    tc_j = stj.clusters.tc.astype(jnp.float32)
    tc_t = torch.tensor(np.asarray(tc_j).astype(np.int32))
    tabs = tables_from_numpy(sj._tables_static, "cpu", torch.float32)
    scal = (CUT2, 1.0, 1.0)
    pr = stj.pairs
    if kernel == "ilist":
        f_p = lj_cluster_force_ilist_pallas(
            *jp, pr.ijlist, npad, *scal, share=sj.ishare, interpret=True,
            tc=tc_j, tables=sj._tables_static)
        f_t = tlj.lj_cluster_force_ilist(
            *tp, torch.tensor(np.asarray(pr.ijlist)),
            torch.tensor(np.asarray(pr.nji)), npad, *scal, share=sj.ishare,
            tc=tc_t, tables=tabs)
    else:
        # the first 8 groups only (the kernel's grid must be a multiple of
        # 8), to keep the interpreter's time down
        npad = 8 * 16
        rg = np.asarray(pr.ranges)[:8, 0]
        jl = np.asarray(pr.jlist)[:8, 0, : 8 * int(rg[:, 32].max())]
        # plain Python floats: the stream kernel, unlike the exact-list
        # one, does not convert the tables' numpy scalars, which drag
        # float64 into a float32 kernel under x64
        static = tuple(tuple(tuple(float(e) for e in row) for row in t)
                       for t in sj._tables_static)
        f_p = lj_cluster_force_pallas_stream(
            *jp, jnp.asarray(jl[:, None, :]), jnp.asarray(rg[:, None, :]), npad,
            16, *scal, interpret=True, tc=tc_j, tables=static)
        f_t = tlj.lj_cluster_force_stream(
            *tp, torch.tensor(jl), torch.tensor(rg), npad, *scal, tc=tc_t,
            tables=tabs)
    assert np.abs(np.asarray(f_p[0])).max() > 1.0
    assert _rel(f_t, f_p) <= 1e-5


def test_convert_carries_the_type_plane_and_tables():
    """step_state_from_numpy(typed=True) carries the type plane as int32,
    typed=False drops it; tables_from_numpy takes mdbench_tpu's
    type_tables and _tables_static alike; a cheap rebuild from the
    converted typed state gives mdbench_tpu's forces."""
    sj, stj, _ = _jax("auto")
    st_t = step_state_from_numpy(stj, "cpu", torch.float64, typed=True)
    assert st_t.clusters.tc.dtype == torch.int32
    np.testing.assert_array_equal(st_t.clusters.tc.numpy(),
                                  np.asarray(stj.clusters.tc).astype(np.int32))
    assert step_state_from_numpy(stj, "cpu", torch.float64).clusters.tc is None
    assert clusters_from_numpy(stj.clusters, "cpu", torch.float64).tc is None
    for src in (sj.type_tables, sj._tables_static, sj._tables_jnp):
        tabs = tables_from_numpy(src, "cpu", torch.float32)
        for a, b in zip(tabs, TABLES):
            assert a.dtype == torch.float32 and a.shape == (2, 2)
            np.testing.assert_array_equal(a.numpy(), b.astype(np.float32))
    s1j, _ = jax.jit(sj._reneigh_step_cheap)(stj)
    s1t = _port("auto")._reneigh_step_cheap(st_t, [])
    np.testing.assert_array_equal(s1t.clusters.tc.numpy(),
                                  np.asarray(s1j.clusters.tc).astype(np.int32))
    assert _rel((s1t.fxc, s1t.fyc, s1t.fzc),
                (s1j.fxc, s1j.fyc, s1j.fzc)) <= 1e-12
    assert pairs_from_numpy(stj.pairs, "cpu").ijlist is not None


@pytest.mark.parametrize("kw", [{"ntypes": 2}, {"types": "two"}])
def test_typed_eam_raises(tmp_path, kw):
    eam = tmp_path / "standin.eam"
    write_standin_funcfl(eam)
    p = TParams(nx=4, ny=4, nz=4, scheme="cluster", force_field=FF_EAM,
                eam_file=str(eam), ntypes=kw.get("ntypes", 1))
    extra = {}
    if "types" in kw:
        x, v, types = _case()
        extra = dict(x=x, v=v, types=types)
    with pytest.raises(ValueError, match="single-type"):
        TSim(p, device="cpu", **extra)


@pytest.mark.parametrize("kw", [{"ntypes": 2}, {"input_file": "atoms.dmp"},
                                {"ntypes": 3, "kernel": "pallas"},
                                {"ntypes": 2, "half_neigh": 1}])
def test_check_slice_accepts_types_and_input_files(kw):
    check_slice(TParams(scheme="cluster", nx=4, ny=4, nz=4, **kw))


def _typed_args(device="cpu", dtype=torch.float32):
    sj, stj, _ = _jax("auto")
    tp, _ = _perturbed_planes(stj, np.float32, sigma=0.05)
    tc = torch.tensor(np.asarray(stj.clusters.tc).astype(np.int32))
    pr = pairs_from_numpy(stj.pairs, "cpu")
    return dict(xc=tp[0], yc=tp[1], zc=tp[2], ijlist=pr.ijlist, nji=pr.nji,
                n_clusters_pad=sj.n_clusters_pad, cutforcesq=CUT2, sigma6=1.0,
                epsilon=1.0, share=sj.ishare, tc=tc,
                tables=tables_from_numpy(TABLES, "cpu", torch.float64))


def test_typed_wrappers_on_cpu_are_the_plain_versions():
    a = _typed_args()
    before = (tlj.LAUNCHES, tlj.TYPED_LAUNCHES)
    f_w = tlj.lj_cluster_force_ilist(**a)
    a.pop("nji")
    f_r = tlj.lj_cluster_force_ilist_ref(**a)
    for x, y in zip(f_w, f_r):
        assert torch.equal(x, y)
    assert (tlj.LAUNCHES, tlj.TYPED_LAUNCHES) == before
    with pytest.raises(ValueError, match="both or neither"):
        tlj.lj_cluster_force_ilist_ref(**{**a, "tables": None})
    with pytest.raises(ValueError, match="no force kernel"):
        tlj.lj_cluster_force_ilist(**{k: (v.to("meta") if torch.is_tensor(v) else v)
                                      for k, v in _typed_args().items()})


def _bad_tables(n):
    return tuple(torch.ones((n, n), dtype=torch.float64) for _ in range(3))


@pytest.mark.parametrize("bad,exc", [
    (lambda a: {**a, "tc": a["tc"].long()}, TypeError),
    (lambda a: {**a, "tc": a["tc"][:-2].contiguous()}, ValueError),
    (lambda a: {**a, "tc": a["tc"].t().contiguous().t()}, ValueError),
    (lambda a: {**a, "tables": a["tables"][:2]}, ValueError),
    (lambda a: {**a, "tables": (a["tables"][0][:1], *a["tables"][1:])}, ValueError),
    (lambda a: {**a, "tables": tuple(t.half() for t in a["tables"])}, TypeError),
    (lambda a: {**a, "tables": _bad_tables(33)}, ValueError),
])
def test_typed_operand_checks_raise(bad, exc):
    a = _typed_args()
    xc, tc, tables = a["xc"], a["tc"], a["tables"]
    nt, *tabs = tlj._typed_operands(xc, tc, tables)  # the good arguments pass
    assert nt == 2 and all(t.dtype == torch.float32 for t in tabs)
    b = bad(a)
    with pytest.raises(exc):
        tlj._typed_operands(b["xc"], b["tc"], b["tables"])
