"""The force kernels (the exact-list LJ kernel csrc/lj_cluster_ilist.cu,
the two EAM passes of csrc/eam_cluster.cu and the group-window LJ kernel
csrc/lj_cluster_stream.cu, the LJ kernels untyped and typed, the
exact-list kernels flat and over capacity buckets, exact and with the
approximate reciprocal) and the probes' kernels (the bf16 form of
csrc/lj_cluster_ilist.cu, the row fetch of csrc/row_fetch.cu)
against their plain torch versions, on a CUDA card. This file imports no jax, so
it runs on a machine that has torch and a card but no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py configures jax; --noconftest skips it.) Without a card
the kernel tests skip: a CUDA kernel has no CPU mode.

Inputs: random planes and lists that hold sentinel ids mid-list, padding
atoms, all-padding units and the all-sentinel last j16; and the lists the
port's own engine builds on the card. Tolerances are relative to max |f|:
1e-5 in float32, 1e-12 in float64 (the kernel sums in list order, the
plain version in torch's reduction order)."""

import numpy as np
import pytest
import torch

from chip_smoke import (
    BF16_TOL,
    LJ_COUNTS,
    boundary_group_lists,
    hand_plan,
    random_group_lists,
    random_tables,
    write_standin_funcfl,
)
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.convert import clusters_from_numpy, pairs_from_numpy
from mdbench_tpu_torch.engine_cluster import ClusterSimulation
from mdbench_tpu_torch.models.eam_tables import (
    apply_eam_overrides,
    fit_eam_poly,
    load_eam,
)
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops.cluster import attach_bucket_maps
from mdbench_tpu_torch.ops import eam_cluster as tec
from mdbench_tpu_torch.ops import lj_cluster as tlj
from mdbench_tpu_torch.ops import row_fetch as trf
from mdbench_tpu_torch.state import SENTINEL_COORD

torch.set_num_threads(1)

CUT2, SIG6, EPS = 2.5**2, 1.0, 1.0
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def synthetic_case(seed=0, cjn=256, nu=64, icap=16, share=2, spacing=1.1):
    """Numpy arrays named as mdbench_tpu's Clusters / ClusterPairList:
    jittered cubic-lattice rows (lattice constant `spacing`), ~10% padding
    atoms, units 4 and 5 (share 2) made only of padding, the last j16
    all-sentinel, and lists holding a sentinel id mid-list. Returns
    (clusters, pairs, n_clusters_pad, share)."""
    rng = np.random.default_rng(seed)
    nrows = 2 * cjn
    g = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1)
    pts = g.reshape(-1, 3)[rng.permutation(16**3)[: nrows * 8]] * spacing
    pts = pts + rng.normal(0.0, 0.05, pts.shape)
    planes = [pts[:, c].reshape(nrows, 8).copy() for c in range(3)]
    rank = np.arange(nrows * 8, dtype=np.float64).reshape(nrows, 8)
    pad = SENTINEL_COORD * (1.0 + rank * 1e-6)
    padmask = rng.random((nrows, 8)) < 0.1
    padmask[-2:] = True  # the last j16 is all-sentinel
    padmask[8:12] = True  # rows 8-11: all-padding units at share 1, 2, 4
    for pl in planes:
        pl[padmask] = pad[padmask]
    sentinel16 = cjn - 1
    ijl = np.full((nu, icap), sentinel16, np.int32)
    nji = rng.integers(0, icap + 1, nu).astype(np.int32)
    for u in range(nu):
        ids = rng.choice(cjn - 1, nji[u], replace=False)
        if nji[u] > 2:
            ids[rng.integers(nji[u])] = sentinel16  # a sentinel mid-list
        ijl[u, : nji[u]] = ids
    cl = {"xc": planes[0], "yc": planes[1], "zc": planes[2],
          "bbox": np.zeros((nrows, 8)), "atom_id": np.zeros((nu * share, 8)),
          "inv_map": np.zeros(1)}
    pairs = {"jlist": np.zeros((1, 1, 1)), "nj": np.zeros(1),
             "overflow": np.zeros(2, bool), "ijlist": ijl, "nji": nji,
             "iovf": np.zeros((), bool)}
    return cl, pairs, nu * share, share


def synthetic_eam_case(seed=0, share=2):
    """synthetic_case at a lattice constant of 1.45 A, so the nearest
    pairs fall just below the EAM fit window's lower edge (1.5 A, where
    t clips) and most listed pairs inside the 4.95 A cutoff lie in it;
    plus a border map of random owners (local j16, ~20% the sentinel
    j16) for the ghost rows and a random fp plane. Returns (clusters,
    pairs, border_map, fp_plane, n_clusters_pad, share)."""
    cl, pairs, npad, share = synthetic_case(
        seed, nu=128 // share, share=share, spacing=1.45)
    rng = np.random.default_rng(seed + 100)
    nrows = cl["xc"].shape[0]
    gcap16 = (nrows - npad - 2) // 2
    border_map = rng.integers(0, npad // 2, gcap16)
    border_map[rng.random(gcap16) < 0.2] = nrows // 2 - 1
    fp_plane = rng.normal(-10.0, 3.0, (nrows, 8))
    return cl, pairs, border_map, fp_plane, npad, share


def _rel(a, b):
    a = torch.stack([t.double().cpu() for t in a])
    b = torch.stack([t.double().cpu() for t in b])
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("share,nu", [(1, 128), (2, 64), (4, 32)])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_plain(cuda, share, nu, tdtype):
    cl, pairs, npad, share = synthetic_case(seed=share, nu=nu, share=share)
    c = clusters_from_numpy(cl, cuda, tdtype)
    pr = pairs_from_numpy(pairs, cuda)
    before = tlj.LAUNCHES
    f_k = tlj.lj_cluster_force_ilist(
        c.xc, c.yc, c.zc, pr.ijlist, pr.nji, npad, CUT2, SIG6, EPS, share=share)
    torch.cuda.synchronize()
    assert tlj.LAUNCHES == before + 1
    f_r = tlj.lj_cluster_force_ilist_ref(
        c.xc, c.yc, c.zc, pr.ijlist, npad, CUT2, SIG6, EPS, share=share)
    assert _rel(f_k, f_r) <= TOL[tdtype]
    # the all-padding units get exactly zero force
    for f in f_k:
        assert (f[8:12] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["sp", "dp"])
def test_cuda_kernel_on_engine_lists(cuda, precision):
    p = Params(nx=6, ny=6, nz=6, precision=precision, scheme="cluster")
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    sim = ClusterSimulation(p, x=x, v=v, device=cuda)
    st = sim.initial_state()
    cl, pr = st.clusters, st.pairs
    args = (cl.xc, cl.yc, cl.zc, pr.ijlist)
    f_r = tlj.lj_cluster_force_ilist_ref(
        *args, sim.n_clusters_pad, CUT2, SIG6, EPS, share=sim.ishare)
    assert _rel((st.fxc, st.fyc, st.fzc), f_r) <= TOL[p.dtype]
    # the same forces from the card's engine and from the CPU plain path
    f_cpu = ClusterSimulation(p, x=x, v=v, device="cpu").first_force_atoms()
    f_gpu = sim.first_force_atoms()
    assert np.abs(f_gpu - f_cpu).max() <= 10 * TOL[p.dtype] * np.abs(f_cpu).max()



@pytest.fixture
def eam_file(tmp_path):
    path = tmp_path / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [1, 2, 4])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_eam_kernels_match_plain(cuda, eam_file, share, tdtype):
    cl, pairs, _, fp, npad, share = synthetic_eam_case(seed=share, share=share)
    c = clusters_from_numpy(cl, cuda, tdtype)
    pr = pairs_from_numpy(pairs, cuda)
    fp = torch.tensor(fp, dtype=tdtype, device=cuda)
    poly = fit_eam_poly(load_eam(eam_file))
    args = (npad, poly.cut**2, poly)
    before = dict(tec.LAUNCHES)
    rho_k = tec.eam_rho_ilist(c.xc, c.yc, c.zc, pr.ijlist, pr.nji, *args, share=share)
    f_k = tec.eam_force_ilist(c.xc, c.yc, c.zc, fp, pr.ijlist, pr.nji, *args,
                              share=share)
    torch.cuda.synchronize()
    flat = ("eam_rho_ilist", "eam_force_ilist")
    assert tec.LAUNCHES == {k: n + (k in flat) for k, n in before.items()}
    rho_r = tec.eam_rho_ilist_ref(c.xc, c.yc, c.zc, pr.ijlist, *args, share=share)
    f_r = tec.eam_force_ilist_ref(c.xc, c.yc, c.zc, fp, pr.ijlist, *args,
                                  share=share)
    assert float(rho_r.abs().max()) > 0 and float(f_r[0].abs().max()) > 0
    assert _rel((rho_k,), (rho_r,)) <= TOL[tdtype]
    assert _rel(f_k, f_r) <= TOL[tdtype]
    # the all-padding units get exactly zero density and force
    for t in (rho_k, *f_k):
        assert (t[8:12] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["sp", "dp"])
def test_cuda_eam_kernels_on_engine_lists(cuda, eam_file, precision):
    kw = dict(nx=6, ny=6, nz=6, precision=precision, scheme="cluster",
              force_field=FF_EAM, eam_file=eam_file)
    p = apply_eam_overrides(Params(**kw), load_eam(eam_file))
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    sim = ClusterSimulation(Params(**kw), x=x, v=v, device=cuda)
    st = sim.initial_state()
    cl, pr = st.clusters, st.pairs
    planes = (cl.xc, cl.yc, cl.zc)
    args = (sim.n_clusters_pad, sim.params.cutforce**2, sim.eam_poly)
    rho_r = tec.eam_rho_ilist_ref(*planes, pr.ijlist, *args, share=sim.ishare)
    rho_k = tec.eam_rho_ilist(*planes, pr.ijlist, pr.nji, *args, share=sim.ishare)
    assert _rel((rho_k,), (rho_r,)) <= TOL[p.dtype]
    fp = tec.fp_plane_from_rho(rho_r, sim.eam_dev, st.halo.border_map,
                               cl.xc.shape[0])
    f_r = tec.eam_force_ilist_ref(*planes, fp, pr.ijlist, *args, share=sim.ishare)
    f_k = tec.eam_force_ilist(*planes, fp, pr.ijlist, pr.nji, *args,
                              share=sim.ishare)
    assert _rel(f_k, f_r) <= TOL[p.dtype]
    # the engine's step-0 forces went through both kernels and agree
    assert _rel((st.fxc, st.fyc, st.fzc), f_r) <= 10 * TOL[p.dtype]
    f_cpu = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu").first_force_atoms()
    f_gpu = sim.first_force_atoms()
    assert np.abs(f_gpu - f_cpu).max() <= 10 * TOL[p.dtype] * np.abs(f_cpu).max()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_stream_kernel_matches_plain(cuda, seed, tdtype):
    """Random windows (inner, empty, past njg), an all-padding group,
    sentinel ids and real ids past nj (chip_smoke phase 11's cases)."""
    planes, jl, rg, npad = random_group_lists(seed, ng=24, L=40)
    xc, yc, zc = (torch.tensor(p, dtype=tdtype, device=cuda) for p in planes)
    jl = torch.tensor(jl, device=cuda)
    rg = torch.tensor(rg, device=cuda)
    before = tlj.STREAM_LAUNCHES
    f_k = tlj.lj_cluster_force_stream(xc, yc, zc, jl, rg, npad, CUT2, SIG6, EPS)
    torch.cuda.synchronize()
    assert tlj.STREAM_LAUNCHES == before + 1
    f_r = tlj.lj_cluster_force_group_ref(xc, yc, zc, jl, npad, CUT2, SIG6, EPS,
                                         ranges=rg)
    assert float(f_r[0].abs().max()) > 1.0
    assert _rel(f_k, f_r) <= TOL[tdtype]
    for f in f_k:  # the all-padding group's rows
        assert (f[16:32] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["sp", "dp"])
def test_cuda_stream_kernel_on_engine_lists(cuda, precision):
    p = Params(nx=6, ny=6, nz=6, precision=precision, scheme="cluster",
               kernel="pallas")
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    sim = ClusterSimulation(p, x=x, v=v, device=cuda)
    before = tlj.STREAM_LAUNCHES
    st = sim.initial_state()
    assert tlj.STREAM_LAUNCHES == before + 1
    cl, pr = st.clusters, st.pairs
    f_r = tlj.lj_cluster_force_group_ref(
        cl.xc, cl.yc, cl.zc, pr.jlist, sim.n_clusters_pad, CUT2, SIG6, EPS,
        ranges=pr.ranges)
    assert _rel((st.fxc, st.fyc, st.fzc), f_r) <= TOL[p.dtype]
    f_cpu = ClusterSimulation(p, x=x, v=v, device="cpu").first_force_atoms()
    f_gpu = sim.first_force_atoms()
    assert np.abs(f_gpu - f_cpu).max() <= 10 * TOL[p.dtype] * np.abs(f_cpu).max()


@pytest.mark.cuda
def test_cuda_stream_wrapper_device_rule(cuda):
    planes, jl, rg, npad = random_group_lists(3)
    args = [torch.tensor(p, dtype=torch.float32) for p in planes]
    args += [torch.tensor(jl), torch.tensor(rg)]
    before = tlj.STREAM_LAUNCHES
    tlj.lj_cluster_force_stream(*args, npad, CUT2, SIG6, EPS)  # the CPU
    assert tlj.STREAM_LAUNCHES == before
    with pytest.raises(ValueError, match="no force kernel"):
        tlj.lj_cluster_force_stream(*(a.to("meta") for a in args), npad, CUT2,
                                    SIG6, EPS)
    tlj.lj_cluster_force_stream(*(a.to(cuda) for a in args), npad, CUT2, SIG6, EPS)
    assert tlj.STREAM_LAUNCHES == before + 1


def _types_and_tables(seed, shape, ntypes, dtype, device):
    """Random int32 types in [0, ntypes) and chip_smoke's random symmetric
    non-uniform tables, on `device`."""
    tc = torch.tensor(np.random.default_rng(seed).integers(0, ntypes, shape),
                      dtype=torch.int32, device=device)
    tabs = tuple(torch.tensor(t, dtype=dtype, device=device)
                 for t in random_tables(seed + 7, ntypes))
    return tc, tabs


UNIFORM = tuple(np.full((2, 2), val) for val in (EPS, SIG6, CUT2))


@pytest.mark.cuda
@pytest.mark.parametrize("ntypes", [1, 2, 3])
@pytest.mark.parametrize("share,nu", [(1, 128), (2, 64), (4, 32)])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_typed_kernel_matches_plain(cuda, ntypes, share, nu, tdtype):
    """K1t against the typed plain version, T = 1, 2, 3; with uniform
    tables it gives the untyped kernel's force."""
    cl, pairs, npad, share = synthetic_case(seed=share, nu=nu, share=share)
    c = clusters_from_numpy(cl, cuda, tdtype)
    pr = pairs_from_numpy(pairs, cuda)
    tc, tabs = _types_and_tables(share + 10 * ntypes, tuple(c.xc.shape), ntypes,
                                 tdtype, cuda)
    args = (c.xc, c.yc, c.zc, pr.ijlist, pr.nji, npad, CUT2, SIG6, EPS)
    before = (tlj.LAUNCHES, tlj.TYPED_LAUNCHES)
    f_k = tlj.lj_cluster_force_ilist(*args, share=share, tc=tc, tables=tabs)
    torch.cuda.synchronize()
    assert (tlj.LAUNCHES, tlj.TYPED_LAUNCHES) == (before[0], before[1] + 1)
    f_r = tlj.lj_cluster_force_ilist_ref(
        c.xc, c.yc, c.zc, pr.ijlist, npad, CUT2, SIG6, EPS, share=share, tc=tc,
        tables=tabs)
    assert _rel(f_k, f_r) <= TOL[tdtype]
    for f in f_k:  # the all-padding units
        assert (f[8:12] == 0).all()
    f_u = tlj.lj_cluster_force_ilist(*args, share=share, tc=tc % 2,
                                     tables=tuple(torch.tensor(t) for t in UNIFORM))
    assert _rel(f_u, tlj.lj_cluster_force_ilist(*args, share=share)) <= TOL[tdtype]


@pytest.mark.cuda
@pytest.mark.parametrize("ntypes", [1, 2, 3])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_typed_stream_kernel_matches_plain(cuda, ntypes, tdtype):
    """K4t against the typed plain version with the windows, T = 1, 2, 3;
    with uniform tables it gives the untyped kernel's force."""
    planes, jl, rg, npad = random_group_lists(ntypes, ng=24, L=40)
    xc, yc, zc = (torch.tensor(p, dtype=tdtype, device=cuda) for p in planes)
    jl, rg = torch.tensor(jl, device=cuda), torch.tensor(rg, device=cuda)
    tc, tabs = _types_and_tables(ntypes, tuple(xc.shape), ntypes, tdtype, cuda)
    args = (xc, yc, zc, jl, rg, npad, CUT2, SIG6, EPS)
    before = (tlj.STREAM_LAUNCHES, tlj.STREAM_TYPED_LAUNCHES)
    f_k = tlj.lj_cluster_force_stream(*args, tc=tc, tables=tabs)
    torch.cuda.synchronize()
    assert (tlj.STREAM_LAUNCHES, tlj.STREAM_TYPED_LAUNCHES) == (before[0], before[1] + 1)
    f_r = tlj.lj_cluster_force_group_ref(xc, yc, zc, jl, npad, CUT2, SIG6, EPS,
                                         ranges=rg, tc=tc, tables=tabs)
    assert float(f_r[0].abs().max()) > 1.0
    assert _rel(f_k, f_r) <= TOL[tdtype]
    for f in f_k:  # the all-padding group's rows
        assert (f[16:32] == 0).all()
    f_u = tlj.lj_cluster_force_stream(*args, tc=tc % 2,
                                      tables=tuple(torch.tensor(t) for t in UNIFORM))
    assert _rel(f_u, tlj.lj_cluster_force_stream(*args)) <= TOL[tdtype]


@pytest.mark.cuda
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_stream_kernels_on_cull_edge_cases(cuda, nan, tdtype):
    """K4 and K4t on chip_smoke.boundary_group_lists: pairs exactly at the
    cutoff and one ulp inside it, boxes touching along one axis, padding,
    NaN rows, an empty window, a window past njg, one-j16 windows and an
    all-padding group. NaN atoms take no pair, so with NaN rows the kernels
    must give the plain force of the same rows as padding. Rows without a
    pair get exactly 0, and two launches give the same bits."""
    np_dtype = np.float32 if tdtype == torch.float32 else np.float64
    planes, jl, rg, npad = boundary_group_lists(np_dtype, nan=nan)
    ref = boundary_group_lists(np_dtype, nan=False)[0]
    p_k = [torch.tensor(q, device=cuda) for q in planes]
    p_r = [torch.tensor(q, device=cuda) for q in ref]
    jl, rg = torch.tensor(jl, device=cuda), torch.tensor(rg, device=cuda)
    zero = [1, *range(16, 32), *range(33, 48)]
    tc, tabs = _types_and_tables(4, tuple(p_k[0].shape), 2, tdtype, cuda)
    for typed in ({}, {"tc": tc, "tables": tabs}):
        f_k = tlj.lj_cluster_force_stream(*p_k, jl, rg, npad, CUT2, SIG6, EPS, **typed)
        again = tlj.lj_cluster_force_stream(*p_k, jl, rg, npad, CUT2, SIG6, EPS, **typed)
        torch.cuda.synchronize()
        f_r = tlj.lj_cluster_force_group_ref(*p_r, jl, npad, CUT2, SIG6, EPS,
                                             ranges=rg, **typed)
        assert float(f_r[0].abs().max()) > 1.0
        assert _rel(f_k, f_r) <= TOL[tdtype]
        for f, g in zip(f_k, again):
            assert (f[zero] == 0).all() and torch.equal(f, g)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{"kernel": "auto"}, {"kernel": "pallas"},
                                   {"half_neigh": 1}])
def test_cuda_typed_engine_matches_cpu(cuda, extra):
    """A jittered 6^3 DP box with two random types and non-uniform tables:
    the card's step-0 forces against the CPU plain path, the typed kernel
    launched and the untyped one not."""
    p = Params(nx=6, ny=6, nz=6, precision="dp", scheme="cluster", **extra)
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    types = np.random.default_rng(6).integers(0, 2, x.shape[0]).astype(np.int32)
    kw = dict(x=x, v=v, types=types, tables=random_tables(4, 2))
    before = {n: getattr(tlj, n) for n in LJ_COUNTS}
    f_gpu = ClusterSimulation(p, device=cuda, **kw).first_force_atoms()
    grew = {n: getattr(tlj, n) - before[n] for n in LJ_COUNTS}
    typed = {"auto": "TYPED_LAUNCHES", "pallas": "STREAM_TYPED_LAUNCHES"}.get(
        extra.get("kernel"))
    assert all(n == 0 for k, n in grew.items() if k != typed)
    if typed:
        assert grew[typed] >= 1
    f_cpu = ClusterSimulation(p, device="cpu", **kw).first_force_atoms()
    assert np.abs(f_gpu - f_cpu).max() <= 1e-10 * np.abs(f_cpu).max()


def _bucket_case(share, nu, tdtype, device, trunc=False, seed=None):
    """synthetic_case's planes and lists on `device` with hand_plan's
    capacity buckets (zero tier, dummy units; with `trunc` a tier whose
    cap is below its longest list) and their maps."""
    cl, pairs, npad, share = synthetic_case(seed=share if seed is None else seed,
                                            nu=nu, share=share)
    c = clusters_from_numpy(cl, device, tdtype)
    plan = hand_plan(pairs["nji"], pairs["ijlist"].shape[1], trunc=trunc)
    pr = attach_bucket_maps(pairs_from_numpy(pairs, device), npad, share,
                            c.xc.shape[0], *plan)
    assert bool(pr.iovf) == trunc
    return c, pr, npad, share, plan


@pytest.mark.cuda
@pytest.mark.parametrize("trunc", [False, True])
@pytest.mark.parametrize("share,nu", [(1, 128), (2, 64), (4, 32)])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_bucket_kernel_matches_plain(cuda, trunc, share, nu, tdtype):
    """K1b against its plain bucketed twin; on untruncated buckets it is
    K1 bit for bit (each unit sums the same list in the same order)."""
    c, pr, npad, share, plan = _bucket_case(share, nu, tdtype, cuda, trunc)
    args = (c.xc, c.yc, c.zc, pr.bijlist, pr.bcrows, pr.binv, pr.nji, npad, plan,
            CUT2, SIG6, EPS)
    before = {n: getattr(tlj, n) for n in LJ_COUNTS}
    f_k = tlj.lj_cluster_force_buckets(*args, share=share)
    torch.cuda.synchronize()
    grew = {n: getattr(tlj, n) - before[n] for n in LJ_COUNTS}
    assert grew == {n: int(n == "BUCKET_LAUNCHES") for n in LJ_COUNTS}
    f_r = tlj.lj_cluster_force_buckets_ref(*args[:6], *args[7:], share=share)
    assert _rel(f_k, f_r) <= TOL[tdtype]
    for f in f_k:  # the all-padding units
        assert (f[8:12] == 0).all()
    if not trunc:
        f_flat = tlj.lj_cluster_force_ilist(c.xc, c.yc, c.zc, pr.ijlist, pr.nji,
                                            npad, CUT2, SIG6, EPS, share=share)
        assert all(torch.equal(a, b) for a, b in zip(f_k, f_flat))


@pytest.mark.cuda
@pytest.mark.parametrize("trunc", [False, True])
@pytest.mark.parametrize("share", [1, 2, 4])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_bucket_eam_kernels_match_plain(cuda, eam_file, trunc, share, tdtype):
    """K2b and K3b against their plain bucketed twins; on untruncated
    buckets they are K2 and K3 bit for bit."""
    cl, pairs, _, fp, npad, share = synthetic_eam_case(seed=share, share=share)
    c = clusters_from_numpy(cl, cuda, tdtype)
    plan = hand_plan(pairs["nji"], pairs["ijlist"].shape[1], trunc=trunc)
    pr = attach_bucket_maps(pairs_from_numpy(pairs, cuda), npad, share,
                            c.xc.shape[0], *plan)
    fp = torch.tensor(fp, dtype=tdtype, device=cuda)
    poly = fit_eam_poly(load_eam(eam_file))
    lists = (pr.bijlist, pr.bcrows, pr.binv)
    args = (npad, poly.cut**2, poly)
    before = dict(tec.LAUNCHES)
    rho_k = tec.eam_rho_buckets(c.xc, c.yc, c.zc, *lists, pr.nji, *args, plan,
                                share=share)
    f_k = tec.eam_force_buckets(c.xc, c.yc, c.zc, fp, *lists, pr.nji, *args, plan,
                                share=share)
    torch.cuda.synchronize()
    bucketed = ("eam_rho_buckets", "eam_force_buckets")
    assert tec.LAUNCHES == {k: n + (k in bucketed) for k, n in before.items()}
    rho_r = tec.eam_rho_buckets_ref(c.xc, c.yc, c.zc, *lists, *args, plan, share)
    f_r = tec.eam_force_buckets_ref(c.xc, c.yc, c.zc, fp, *lists, *args, plan,
                                    share)
    assert float(rho_r.abs().max()) > 0 and float(f_r[0].abs().max()) > 0
    assert _rel((rho_k,), (rho_r,)) <= TOL[tdtype]
    assert _rel(f_k, f_r) <= TOL[tdtype]
    for t in (rho_k, *f_k):
        assert (t[8:12] == 0).all()
    if not trunc:
        flat = (c.xc, c.yc, c.zc, pr.ijlist, pr.nji, *args)
        assert torch.equal(rho_k, tec.eam_rho_ilist(*flat, share=share))
        f_flat = tec.eam_force_ilist(c.xc, c.yc, c.zc, fp, pr.ijlist, pr.nji, *args,
                                     share=share)
        assert all(torch.equal(a, b) for a, b in zip(f_k, f_flat))


@pytest.mark.cuda
@pytest.mark.parametrize("force_field", ["lj", "eam"])
def test_cuda_bucketed_engine_matches_cpu(cuda, eam_file, force_field):
    """A jittered 6^3 DP box with a hand-set plan: the card's step-0
    forces went through the bucketed kernels and equal the CPU's plain
    bucketed path."""
    kw = dict(nx=6, ny=6, nz=6, precision="dp", scheme="cluster")
    if force_field == "eam":
        kw.update(force_field=FF_EAM, eam_file=eam_file)
    p = Params(**kw)
    if force_field == "eam":
        apply_eam_overrides(p, load_eam(eam_file))
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)

    def forces(device):
        sim = ClusterSimulation(Params(**kw), x=x, v=v, device=device)
        sim.buckets = hand_plan(sim.initial_state().pairs.nji.cpu().numpy(), sim.icap)
        return sim.first_force_atoms()

    before = (tlj.BUCKET_LAUNCHES, dict(tec.LAUNCHES))
    f_gpu = forces(cuda)
    if force_field == "lj":
        assert tlj.BUCKET_LAUNCHES > before[0]
    else:
        assert tec.LAUNCHES["eam_force_buckets"] > before[1]["eam_force_buckets"]
    f_cpu = forces("cpu")
    assert np.abs(f_gpu - f_cpu).max() <= 1e-10 * np.abs(f_cpu).max()


@pytest.mark.cuda
@pytest.mark.parametrize("bad,exc", [
    (lambda a: {**a, "bijlist": a["bijlist"].long()}, TypeError),
    (lambda a: {**a, "bcrows": a["bcrows"][:-1]}, ValueError),
    (lambda a: {**a, "nji": a["nji"][:-1]}, ValueError),
    (lambda a: {**a, "buckets": ((1,) * 33, (8,) * 33)}, ValueError),
    (lambda a: {**a, "share": 3}, ValueError),
    (lambda a: {**a, "binv": a["binv"].long()}, TypeError),
])
def test_cuda_bucket_wrappers_raise(cuda, bad, exc):
    """The bucketed wrappers check their operands before a launch and
    launch nothing when one is wrong."""
    c, pr, npad, share, plan = _bucket_case(2, 64, torch.float32, cuda)
    a = dict(xc=c.xc, yc=c.yc, zc=c.zc, bijlist=pr.bijlist, bcrows=pr.bcrows,
             binv=pr.binv, nji=pr.nji, n_clusters_pad=npad, buckets=plan,
             share=share)
    b = bad(a)
    before = tlj.BUCKET_LAUNCHES
    with pytest.raises(exc):
        tlj.lj_cluster_force_buckets(
            b["xc"], b["yc"], b["zc"], b["bijlist"], b["bcrows"], b["binv"],
            b["nji"], b["n_clusters_pad"], b["buckets"], CUT2, SIG6, EPS,
            share=b["share"])
    assert tlj.BUCKET_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("share,nu", [(1, 128), (2, 64), (4, 32)])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_approx_rcp_kernels(cuda, share, nu, tdtype):
    """K1, K1t and K1b with approx_rcp: in float32 within the kernels'
    tolerance of their plain twins (which divide), K1b still K1 bit for
    bit; in float64 bit-equal to the kernels without the flag."""
    c, pr, npad, share, plan = _bucket_case(share, nu, tdtype, cuda)
    tc, tabs = _types_and_tables(share, tuple(c.xc.shape), 2, tdtype, cuda)
    lists = (c.xc, c.yc, c.zc, pr.ijlist, pr.nji, npad, CUT2, SIG6, EPS)
    maps = (c.xc, c.yc, c.zc, pr.bijlist, pr.bcrows, pr.binv, pr.nji, npad, plan,
            CUT2, SIG6, EPS)
    calls = {
        "K1": (lambda a: tlj.lj_cluster_force_ilist(*lists, share=share, approx_rcp=a),
               tlj.lj_cluster_force_ilist_ref(c.xc, c.yc, c.zc, pr.ijlist, npad, CUT2,
                                              SIG6, EPS, share=share)),
        "K1t": (lambda a: tlj.lj_cluster_force_ilist(*lists, share=share, tc=tc,
                                                     tables=tabs, approx_rcp=a),
                tlj.lj_cluster_force_ilist_ref(c.xc, c.yc, c.zc, pr.ijlist, npad, CUT2,
                                               SIG6, EPS, share=share, tc=tc,
                                               tables=tabs)),
        "K1b": (lambda a: tlj.lj_cluster_force_buckets(*maps, share=share,
                                                       approx_rcp=a),
                tlj.lj_cluster_force_buckets_ref(*maps[:6], *maps[7:], share=share)),
    }
    got = {}
    for name, (run, plain) in calls.items():
        approx, exact = run(True), run(False)
        torch.cuda.synchronize()
        assert _rel(approx, plain) <= TOL[tdtype], name
        if tdtype == torch.float64:
            assert all(torch.equal(a, b) for a, b in zip(approx, exact)), name
        got[name] = approx
    assert all(torch.equal(a, b) for a, b in zip(got["K1b"], got["K1"]))


@pytest.mark.cuda
@pytest.mark.parametrize("share,nu", [(1, 128), (2, 64), (4, 32)])
def test_cuda_bf16_kernel_matches_plain(cuda, share, nu):
    """The bf16 kernel against its plain twin within BF16_TOL of max |f|
    (the card's approximate reciprocal may round sr2 to the neighbouring
    bfloat16 value); the all-padding units get exactly 0."""
    cl, pairs, npad, share = synthetic_case(seed=share, nu=nu, share=share)
    c = clusters_from_numpy(cl, cuda, torch.float32)
    pr = pairs_from_numpy(pairs, cuda)
    before = {n: getattr(tlj, n) for n in LJ_COUNTS}
    f_k = tlj.lj_cluster_force_ilist_bf16(c.xc, c.yc, c.zc, pr.ijlist, pr.nji, npad,
                                          CUT2, SIG6, EPS, share=share)
    torch.cuda.synchronize()
    grew = {n: getattr(tlj, n) - before[n] for n in before}
    assert grew == {n: int(n == "BF16_LAUNCHES") for n in before}
    f_r = tlj.lj_cluster_force_ilist_bf16_ref(c.xc, c.yc, c.zc, pr.ijlist, npad,
                                              CUT2, SIG6, EPS, share=share)
    assert float(f_r[0].abs().max()) > 1.0
    assert _rel(f_k, f_r) <= BF16_TOL
    for f in f_k:
        assert (f[8:12] == 0).all()


@pytest.mark.cuda
def test_cuda_bf16_kernel_on_engine_lists(cuda):
    """The bf16 kernel on the lists of a jittered 6^3 SP box against its
    plain twin; float64 planes are refused."""
    p = Params(nx=6, ny=6, nz=6, precision="sp", scheme="cluster")
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    sim = ClusterSimulation(p, x=x, v=v, device=cuda)
    st = sim.initial_state()
    cl, pr = st.clusters, st.pairs
    args = (sim.n_clusters_pad, CUT2, SIG6, EPS)
    f_k = tlj.lj_cluster_force_ilist_bf16(cl.xc, cl.yc, cl.zc, pr.ijlist, pr.nji,
                                          *args, share=sim.ishare)
    f_r = tlj.lj_cluster_force_ilist_bf16_ref(cl.xc, cl.yc, cl.zc, pr.ijlist, *args,
                                              share=sim.ishare)
    assert _rel(f_k, f_r) <= BF16_TOL
    with pytest.raises(TypeError):
        tlj.lj_cluster_force_ilist_bf16(cl.xc.double(), cl.yc.double(),
                                        cl.zc.double(), pr.ijlist, pr.nji, *args,
                                        share=sim.ishare)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ids", [1, 37, 4096])
@pytest.mark.parametrize("rows_per_id", [1, 8])
@pytest.mark.parametrize("mode", ["cp_async", "tma"])
def test_cuda_row_fetch_matches_index_select(cuda, mode, rows_per_id, n_ids):
    """Each row-fetch variant equals index_select bit for bit, on id lists
    that fill whole stages or end inside one, ids 0 and the last
    included."""
    rng = np.random.default_rng(n_ids)
    table = torch.tensor(rng.standard_normal((1024, 128)), dtype=torch.float32,
                         device=cuda)
    hi = 1024 // rows_per_id
    ids = rng.integers(0, hi, n_ids)
    ids[0], ids[-1] = 0, hi - 1
    ids = torch.tensor(ids, dtype=torch.int32, device=cuda)
    name = trf.variant(mode, rows_per_id)
    before = dict(trf.LAUNCHES)
    got = trf.row_fetch(table, ids, rows_per_id, mode)
    torch.cuda.synchronize()
    assert trf.LAUNCHES == {k: n + (k == name) for k, n in before.items()}
    assert torch.equal(got, trf.row_fetch_ref(table, ids, rows_per_id))
