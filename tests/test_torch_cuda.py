"""The force kernels (the exact-list LJ kernel csrc/lj_cluster_ilist.cu,
the two EAM passes of csrc/eam_cluster.cu, the group-window LJ kernel
csrc/lj_cluster_stream.cu, the verlet EAM passes of
csrc/eam_verlet.cu, the verlet row lists' exact prune of
csrc/verlet_prune.cu and the ranges build's candidate stage of
csrc/verlet_ranges.cu, the LJ kernels untyped and typed, the
exact-list kernels flat and over capacity buckets, exact and with the
approximate reciprocal, on the cluster lists and on the verlet scheme's
16-atom row lists) and the probes' kernels (the bf16 form of
csrc/lj_cluster_ilist.cu, the row fetch of csrc/row_fetch.cu)
against their plain torch versions, on a CUDA card; the cluster EAM's
split passes against the composed force; the bf16 derive's lists on the
card against the CPU's, bit for bit; and the verlet engine and the
slab, pencil and brick engines on the card against their CPU runs. This
file imports no jax, so it runs on a machine that has torch and a card
but no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py configures jax; --noconftest skips it.) Without a card
the kernel tests skip: a CUDA kernel has no CPU mode.

Inputs: random planes and lists that hold sentinel ids mid-list, padding
atoms, all-padding units and the all-sentinel last j16; and the lists the
port's own engine builds on the card. Tolerances are relative to max |f|:
1e-5 in float32, 1e-12 in float64 (the kernel sums in list order, the
plain version in torch's reduction order)."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (
    BF16_TOL,
    LJ_COUNTS,
    VERLET_EAM_CUTSQ,
    boundary_group_lists,
    hand_plan,
    launches_of,
    prune_edge_cases,
    prune_operands,
    prune_tensors,
    ranges_diff,
    ranges_edge_cases,
    ranges_tensors,
    random_group_lists,
    random_tables,
    sweep_edge_calls,
    verlet_eam_case,
    verlet_eam_edge_cases,
    verlet_eam_pair,
    write_standin_funcfl,
)
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.convert import clusters_from_numpy, pairs_from_numpy
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.engine_cluster import ClusterSimulation
from mdbench_tpu_torch.models.eam_tables import (
    apply_eam_overrides,
    fit_eam_poly,
    load_eam,
)
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops.cluster import attach_bucket_maps, bucket_maps_core
from mdbench_tpu_torch.ops import eam as tev
from mdbench_tpu_torch.ops import eam_cluster as tec
from mdbench_tpu_torch.ops import lj_cluster as tlj
from mdbench_tpu_torch.ops import row_fetch as trf
from mdbench_tpu_torch.ops import verlet as tver
from mdbench_tpu_torch.probes import bf16 as pbf16
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
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("share", [1, 2, 4])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_ilist_kernels_on_sweep_edge_cases(cuda, eam_file, tdtype, share, nan):
    """K1, K1t, K1b, K2, K2b, K3 and K3b on chip_smoke.boundary_ilist_case
    (chip_smoke.sweep_edge_calls): pairs exactly at the cutoff and one ulp
    inside it, padding at 1e30, coinciding padding, NaN rows, an empty
    list, units without a pair inside (rows exactly 0), a tile whose every
    pair is inside, a unit whose pairs inside lie in one chunk; flat, and
    bucketed on a hand plan with a zero tier and dummy units (bit-equal to
    the flat kernels) and with a truncating bucket. NaN atoms take no
    pair, so with NaN rows the kernels must give the plain versions'
    values on the same rows as padding (rows 0-1 also on their own: their
    forces are small beside the dense rows'). Two launches give the same
    bits; with approx_rcp the LJ kernels stay within the tolerance in
    float32 and are bit-equal in float64."""
    np_dtype = np.float32 if tdtype == torch.float32 else np.float64
    calls, p_k, p_r, npad = sweep_edge_calls(torch, cuda, np_dtype, share, nan,
                                             fit_eam_poly(load_eam(eam_file)))
    got = {}
    for name, (kern, plain) in calls.items():
        out, again = kern(p_k), kern(p_k)
        torch.cuda.synchronize()
        want = plain(p_r)
        assert float(want[0].abs().max()) > 0, name
        for rows in (slice(0, 2), slice(0, npad)):
            a, b = [t[rows] for t in out], [t[rows] for t in want]
            if any(bool(t.any()) for t in b):
                assert _rel(a, b) <= TOL[tdtype], name
            else:  # a truncating bucket can leave rows 0-1 without a pair
                assert not any(bool(t.any()) for t in a), name
        for a, b in zip(out, again):
            assert torch.equal(a, b) and (a[4:] == 0).all(), name
        got[name] = out
        if name.startswith("K1"):
            approx = kern(p_k, approx_rcp=True)
            if tdtype == torch.float64:
                assert all(torch.equal(a, b) for a, b in zip(approx, out)), name
            else:
                assert _rel(approx, want) <= TOL[tdtype], name
    for flat in ("K1", "K2", "K3"):
        assert all(torch.equal(a, b) for a, b in zip(got[flat + "b"], got[flat])), flat


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
@pytest.mark.parametrize("share", [1, 2, 4])
def test_cuda_bf16_kernel_on_edge_cases(cuda, share):
    """The bf16 kernel (two sweeps, inside bits popped two at a time) on
    probes.bf16.edge_case against its plain twin within BF16_TOL: odd
    inside counts per lane (the last bit without a partner), lists that
    end mid-chunk, the all-padding unit exactly 0, and pairs whose
    bfloat16 rsq lies just inside or just outside cutforcesq 6.3001 (not
    a bfloat16 value), where a wrong pair set moves max |f| by ~1%; two
    launches give the same bits."""
    case = pbf16.edge_case(share, cuda)
    before = tlj.BF16_LAUNCHES
    got = pbf16.edge_force(case)
    again = pbf16.edge_force(case)
    torch.cuda.synchronize()
    assert tlj.BF16_LAUNCHES == before + 2
    want = pbf16.edge_force(case, plain=True)
    assert _rel(got, want) <= BF16_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for f in got:
        assert (f[share:2 * share] == 0).all()


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_id,n_ids", [
    (1, 1), *((1, 8 * 300 + t) for t in range(1, 8)), (1, 100_003), (8, 1),
    (8, 20_000)])
@pytest.mark.parametrize("mode", ["cp_async", "tma"])
def test_cuda_row_fetch_stages_and_tails(cuda, mode, rows_per_id, n_ids):
    """The row fetch equals index_select bit for bit on one id, on row
    lists whose last stage holds 1-7 rows, and on more rows than the TMA
    form's persistent blocks hold in their rings at once (100,003 rows, 1
    a id; 160,000, 8 a id; the rings hold at most 132 SMs x 16 blocks x 3
    slots x 8 rows, and 132 x 2 x 8 x 8), ids 0 and the last included."""
    rng = np.random.default_rng(n_ids)
    table = torch.tensor(rng.standard_normal((1024, 128)), dtype=torch.float32,
                         device=cuda)
    hi = 1024 // rows_per_id
    ids = rng.integers(0, hi, n_ids)
    ids[0], ids[-1] = 0, hi - 1
    ids = torch.tensor(ids, dtype=torch.int32, device=cuda)
    got = trf.row_fetch(table, ids, rows_per_id, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, trf.row_fetch_ref(table, ids, rows_per_id))


@pytest.fixture(scope="module")
def verlet_states():
    """16^3 verlet rowlist states on the card after a 20-step run (its
    calibrations and one rebuild with the re-sort), per precision."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    out = {}
    for precision in ("sp", "dp"):
        p = Params(nx=16, ny=16, nz=16, ntimes=20, precision=precision)
        sim = Simulation(p, device=torch.device("cuda"))
        out[precision] = (sim, sim.run(repeats=0).state)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("precision", ["sp", "dp"])
def test_cuda_kernels_on_verlet_row_lists(verlet_states, precision, approx):
    """K1 and K1b on the verlet scheme's 16-atom row lists (share 2, rows
    in atom order, sentinel-padded planes, cell-sorted ghosts) against
    their plain twins, which divide: 1e-5 / 1e-12 of max |f|, with and
    without the approximate reciprocal; K1b over a hand-set plan equals K1
    bit for bit."""
    sim, st = verlet_states[precision]
    nl = st.nlist
    dtype = sim.params.dtype
    planes = [st.x[:, k].reshape(-1, 8).contiguous() for k in range(3)]
    npad = sim.caps.nlocal_pad // 8
    lj = (CUT2, SIG6, EPS)
    want = tlj.lj_cluster_force_ilist_ref(*planes, nl.rows, npad, *lj, share=2)
    before = tlj.LAUNCHES
    got = tlj.lj_cluster_force_ilist(*planes, nl.rows, nl.numrows, npad, *lj, share=2,
                                     approx_rcp=approx)
    torch.cuda.synchronize()
    assert tlj.LAUNCHES == before + 1
    assert _rel(got, want) <= TOL[dtype]
    plan = hand_plan(nl.numrows.cpu().numpy(), nl.rows.shape[1])
    maps = bucket_maps_core(nl.rows, nl.numrows, npad, 2, planes[0].shape[0], *plan)
    assert not bool(maps[3])
    got_b = tlj.lj_cluster_force_buckets(*planes, *maps[:3], nl.numrows, npad, plan, *lj,
                                         share=2, approx_rcp=approx)
    assert all(torch.equal(a, b) for a, b in zip(got_b, got))
    want_b = tlj.lj_cluster_force_buckets_ref(*planes, *maps[:3], npad, plan, *lj, share=2)
    assert _rel(got_b, want_b) <= TOL[dtype]
    # the engine's step-0 force of these lists is K1's
    f = sim._force(st.x, st.types, nl, st.halo)
    assert f.shape == (sim.caps.nlocal_pad, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{"kernel": "auto"}, {"kernel": "xla"},
                                   {"half_neigh": 1}])
def test_cuda_verlet_engine_matches_cpu(cuda, extra):
    """A jittered 8^3 DP verlet box, card against the CPU plain path:
    step-0 forces <= 1e-10 of max |f|, 40-step temperatures <= 1e-9 (the
    half lists' index_add_ sums with atomics on the card); the row lists
    launch K1 and no other force kernel, and prune with the prune kernel;
    the planar paths launch neither; the row lists' rebuilds take their
    candidates from the ranges kernel."""
    kw = dict(nx=8, ny=8, nz=8, ntimes=40, reneigh_every=10, precision="dp", **extra)
    x, v, _ = create_fcc_lattice(Params(**kw))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    before = {n: getattr(tlj, n) for n in LJ_COUNTS}
    f_gpu = Simulation(Params(**kw), x=x, v=v, device=cuda).first_force()
    grew = {n: getattr(tlj, n) - before[n] for n in LJ_COUNTS}
    rowlist = extra.get("kernel") == "auto"
    assert grew["LAUNCHES"] >= (1 if rowlist else 0)
    assert all(n == 0 for k, n in grew.items() if k != "LAUNCHES" or not rowlist)
    f_cpu = Simulation(Params(**kw), x=x, v=v, device="cpu").first_force()
    assert np.abs(f_gpu - f_cpu).max() <= 1e-10 * np.abs(f_cpu).max()
    prunes, ranges = tver.PRUNE_LAUNCHES, tver.RANGES_LAUNCHES
    r_gpu = Simulation(Params(**kw), device=cuda).run(repeats=0)
    # the row lists' rebuilds (the ranges build: sorted atoms) take their
    # candidates from the ranges kernel and prune on the card, the planar
    # paths launch neither
    assert (tver.PRUNE_LAUNCHES > prunes) == rowlist
    assert (tver.RANGES_LAUNCHES > ranges) == rowlist
    r_cpu = Simulation(Params(**kw), device="cpu").run(repeats=0)
    np.testing.assert_allclose(r_gpu.temps, r_cpu.temps, rtol=1e-9)


PRUNE_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _prune_equal(args):
    """The prune kernel (one launch) against exact_prune_ref on the same
    operands: the same dtypes, rows and counts, bit for bit."""
    before = tver.PRUNE_LAUNCHES
    got = tver._exact_prune(*args)
    torch.cuda.synchronize()
    assert tver.PRUNE_LAUNCHES == before + 1
    want = tver.exact_prune_ref(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random", "overflow", "nan", "boundary", "wide"])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_prune_matches_plain(cuda, tdtype, name):
    """The prune kernel on chip_smoke.prune_edge_cases (sentinel ids
    mid-list, padding and all-padding units, rsq == cutsq and one ulp
    either side, NaN and inf, more kept rows than rcap, 300 candidates a
    unit) against exact_prune_ref, bit for bit, one launch a call."""
    case = prune_edge_cases(PRUNE_NP[tdtype])[name]
    rows, numrows = _prune_equal(prune_tensors(torch, case, cuda))
    if name == "overflow":
        assert bool((numrows > case["rcap"]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["x unaligned", "cand int32", "device"])
def test_cuda_prune_wrapper_raises(cuda, bad):
    """What the kernel does not take raises before any launch: x off a
    16-byte boundary (its rows are read as 16-byte loads), int32
    candidates, operands on two devices."""
    x, cand, npad, validu, *rest = prune_tensors(
        torch, prune_edge_cases(np.float32)["random"], cuda)
    if bad == "x unaligned":
        x = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    elif bad == "cand int32":
        cand = cand.int()
    else:
        validu = validu.cpu()
    before = tver.PRUNE_LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        tver._exact_prune(x, cand, npad, validu, *rest)
    assert tver.PRUNE_LAUNCHES == before


@pytest.mark.cuda
def test_cuda_prune_no_units(cuda):
    """nu = 0: empty rows and counts of the contract's shapes, no launch."""
    x, cand, _, validu, cutsq, rcap, sent16 = prune_tensors(
        torch, prune_edge_cases(np.float32)["random"], cuda)
    before = tver.PRUNE_LAUNCHES
    rows, numrows = tver._exact_prune(x, cand[:0], 0, validu[:0], cutsq, rcap, sent16)
    assert rows.shape == (0, rcap) and numrows.shape == (0,)
    assert rows.dtype == cand.dtype and numrows.dtype == torch.int64
    assert tver.PRUNE_LAUNCHES == before


@pytest.fixture(scope="module")
def prune_engine_operands():
    """The exact prune's operands of a rebuild of the 131k SP box on the
    card after a 20-step run, from derive_rowlists_from_ranges (the
    engine's build) and from derive_rowlists_from_cells (the same engine
    with its cells build switched on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    sim = Simulation(Params(nx=32, ny=32, nz=32, ntimes=20, precision="sp"),
                     device=torch.device("cuda"))
    st = sim.run(repeats=0).state
    out = {"ranges": prune_operands(sim, st)}
    sim._rowbuild_ranges = False
    out["cells"] = prune_operands(sim, st)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("build", ["ranges", "cells"])
def test_cuda_prune_on_engine_candidates(prune_engine_operands, build, tdtype):
    x, *rest = prune_engine_operands[build]
    _, numrows = _prune_equal((x.to(tdtype), *rest))
    assert int(numrows.min()) > 0


@pytest.mark.cuda
def test_cuda_prune_131k_engine_matches_cpu(cuda):
    """A jittered 131k DP box's t=0 rebuild and step-0 force, card (the
    prune kernel) against the CPU (exact_prune_ref) after the same
    capacity grows: the same row lists and counts bit for bit, forces
    within 1e-10 of max |f| (as the 8^3 engine test)."""
    p = Params(nx=32, ny=32, nz=32, precision="dp")
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    gpu = Simulation(p, x=x, v=v, device=cuda)
    before = tver.PRUNE_LAUNCHES
    f_gpu = gpu.first_force()
    assert tver.PRUNE_LAUNCHES > before
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        cpu = Simulation(p, x=x, v=v, device="cpu")
        f_cpu = cpu.first_force()
        nl_cpu = cpu.initial_state().nlist
    finally:
        torch.set_num_threads(threads)
    assert np.abs(f_gpu - f_cpu).max() <= 1e-10 * np.abs(f_cpu).max()
    nl_gpu = gpu.initial_state().nlist
    assert gpu.rcap == cpu.rcap
    assert torch.equal(nl_gpu.rows.cpu(), nl_cpu.rows)
    assert torch.equal(nl_gpu.numrows.cpu(), nl_cpu.numrows)


RANGES_CASES = ("random", "ucol", "kcap", "narrow", "gcap0", "nan")


@pytest.mark.cuda
@pytest.mark.parametrize("name", RANGES_CASES)
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_ranges_matches_plain(cuda, tdtype, name):
    """The candidate kernel on chip_smoke.ranges_edge_cases (padding atoms,
    units without a real atom, margin columns, overlapping and duplicate
    ranges, more columns than ucol, more ranges than kcap, ccap 40, no
    ghost block, a NaN coordinate) against range_candidates_ref on the
    same card tensors, one launch a call (chip_smoke.ranges_diff: cand
    and total bit for bit where no unit passes kcap; n_dc, nk, the maxima
    and the flags always); the overflow cases raise their flags."""
    case = ranges_edge_cases(PRUNE_NP[tdtype])[name]
    (_, _, _, _, stats), diff = ranges_diff(torch, ranges_tensors(torch, case, cuda))
    assert diff == []
    flags = [int(stats[0]) > case["ccap"], int(stats[1]) > case["ucol"],
             int(stats[2]) > case["kcap"]]
    assert flags == [name == "narrow", name == "ucol", name == "kcap"]


@pytest.mark.cuda
@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_ranges_total_at_ccap(cuda, tdtype, past):
    """ccap exactly the random case's largest union, and one below it:
    the kernel's candidates and totals are range_candidates_ref's, the
    largest total ccap or ccap + 1, the flag up only past it."""
    case = ranges_edge_cases(PRUNE_NP[tdtype])["random"]
    args = ranges_tensors(torch, case, cuda)
    top = int(tver.range_candidates_ref(*args)[1].max())
    (cand, total, _, _, stats), diff = ranges_diff(torch, (*args[:-1], top - past))
    assert diff == []
    assert int(total.max()) == int(stats[0]) == top and cand.shape[1] == top - past
    assert (cand[int(total.argmax())] != case["x"].shape[0] // 16 - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["x float16", "x strided", "kcap 0", "ccap negative"])
def test_cuda_ranges_wrapper_raises(cuda, bad):
    """What the kernel does not take raises before any launch."""
    args = list(ranges_tensors(torch, ranges_edge_cases(np.float32)["random"], cuda))
    if bad == "x float16":
        args[1] = args[1].half()
    elif bad == "x strided":
        args[1] = torch.cat([args[1], args[1]], 1)[:, ::2]
    elif bad == "kcap 0":
        args[7] = 0
    else:
        args[8] = -8
    before = tver.RANGES_LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        tver._range_candidates(*args)
    assert tver.RANGES_LAUNCHES == before


@pytest.mark.cuda
def test_cuda_ranges_no_units(cuda):
    """nu = 0: empty candidates and counts of the contract's shapes, zero
    maxima, no launch."""
    grid, x, _, _, gcap, cut, ucol, kcap, ccap = ranges_tensors(
        torch, ranges_edge_cases(np.float32)["random"], cuda)
    before = tver.RANGES_LAUNCHES
    cand, total, n_dc, nk, stats = tver._range_candidates(grid, x, 0, 0, gcap, cut, ucol,
                                                          kcap, ccap)
    assert cand.shape == (0, ccap) and total.shape == n_dc.shape == nk.shape == (0,)
    assert stats.tolist() == [0, 0, 0, 0]
    assert tver.RANGES_LAUNCHES == before


@pytest.fixture(scope="module")
def ranges_engine_inputs():
    """The ranges build's inputs in a rebuild of the 8^3 and the 131k SP
    boxes on the card after a 20-step run: (grid, x, nlocal, nlocal_pad,
    gcap, rcap, cutneigh) and the engine's (ucol, kcap, ccap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    out = {}
    for nx in (8, 32):
        sim = Simulation(Params(nx=nx, ny=nx, nz=nx, ntimes=20, precision="sp"),
                         device=torch.device("cuda"))
        x = prune_operands(sim, sim.run(repeats=0).state)[0]
        c = sim.caps
        out[nx] = ((sim.grid, x, sim.nlocal, c.nlocal_pad, c.ghost, sim.rcap,
                    sim.params.cutneigh), dict(ucol=sim.ucl, kcap=sim.ukr, ccap=sim.ccap))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx", [8, 32])
def test_cuda_derive_ranges_matches_cpu(ranges_engine_inputs, nx, tdtype):
    """derive_rowlists_from_ranges on the card (the ranges kernel, then the
    prune kernel: one launch each) against the CPU (range_candidates_ref,
    exact_prune_ref) on the same x of an engine's rebuild at 8^3 and 131k:
    the same rows, counts, stats and flag; the kernel's candidates
    range_candidates_ref's on the card."""
    (grid, x, *rest), caps = ranges_engine_inputs[nx]
    x = x.to(tdtype)
    before = (tver.RANGES_LAUNCHES, tver.PRUNE_LAUNCHES)
    card = tver.derive_rowlists_from_ranges(grid, x, *rest, **caps)
    torch.cuda.synchronize()
    assert (tver.RANGES_LAUNCHES, tver.PRUNE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        cpu = tver.derive_rowlists_from_ranges(grid, x.cpu(), *rest, **caps)
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(card[:3], cpu[:3]):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    assert bool(card[3]) == bool(cpu[3]) is False
    nlocal, npad, gcap, _, cut = rest
    args = (grid, x, nlocal, npad, gcap, cut, caps["ucol"], caps["kcap"], caps["ccap"])
    assert ranges_diff(torch, args)[1] == []


@pytest.mark.cuda
def test_cuda_derive_ranges_launches(ranges_engine_inputs):
    """One derive_rowlists_from_ranges call on the card at 131k queues at
    most 45 launches, copies or sets (no chunk loop: within 2 of an 8^3
    call's, whatever nu; torch's larger reductions may add a set), among
    them one ranges and one prune kernel."""
    counts = {}
    for nx in (8, 32):
        (grid, x, *rest), caps = ranges_engine_inputs[nx]
        before = (tver.RANGES_LAUNCHES, tver.PRUNE_LAUNCHES)
        counts[nx] = launches_of(torch, lambda: tver.derive_rowlists_from_ranges(
            grid, x, *rest, **caps))
        assert (tver.RANGES_LAUNCHES, tver.PRUNE_LAUNCHES) == (before[0] + 2,
                                                               before[1] + 2)
    assert max(counts.values()) <= 45 and abs(counts[32] - counts[8]) <= 2


def _verlet_eam_outputs_match(outs, tdtype):
    """K5's rho and fp and K6's f within TOL of their plain versions, two
    launches the same bits."""
    for name in ("rho", "fp", "f"):
        got, again, want = outs[name]
        assert torch.equal(got, again), name
        assert _rel((got,), (want,)) <= TOL[tdtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("poly", [False, True], ids=["spline", "poly"])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_verlet_eam_kernels_on_edge_cases(cuda, eam_file, seed, poly, tdtype):
    """K5 and K6 against their plain versions on chip_smoke.verlet_eam_case:
    numneigh 0 over real entries, sentinel and NaN rows in lists, a pair at
    the cutoff and one ulp inside, padding rows, lists past their width.
    Rows without a pair inside get rho and force exactly 0."""
    np_dtype = np.float32 if tdtype == torch.float32 else np.float64
    case = verlet_eam_case(np_dtype, seed)
    x, nb, nn, bmap = (torch.tensor(case[k], device=cuda)
                       for k in ("x", "neighbors", "numneigh", "border_map"))
    t = load_eam(eam_file)
    eam = tev.EamDevice.from_tables(t, cuda, tdtype)
    before = dict(tev.LAUNCHES)
    outs = verlet_eam_pair(torch, x, nb, nn, case["nlocal_pad"], VERLET_EAM_CUTSQ, eam,
                           fit_eam_poly(t) if poly else None, bmap)
    assert tev.LAUNCHES == {k: v + 2 for k, v in before.items()}
    _verlet_eam_outputs_match(outs, tdtype)
    rho, f = outs["rho"][0], outs["f"][0]
    assert bool((rho[case["empty"]] == 0).all()) and bool((f[case["empty"]] == 0).all())
    assert float(rho[case["inside"]]) > 0 and float(f[case["inside"], 1]) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lattice", "odd k", "one atom"])
@pytest.mark.parametrize("poly", [False, True], ids=["spline", "poly"])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_verlet_eam_kernels_bit_equal_on_edge_cases(cuda, eam_file, name, poly, tdtype):
    """K5 and K6 equal to their plain versions bit for bit on
    chip_smoke.verlet_eam_edge_cases (the lattice case; an odd width over
    53 atoms with a block of 16 empty rows and rows at and past the width;
    a single local atom): every row has fewer than 128 entries, where
    torch's row sum on the card adds in the kernels' order. Two launches
    give the same bits; rows without a pair inside get exactly 0."""
    np_dtype = np.float32 if tdtype == torch.float32 else np.float64
    case = verlet_eam_edge_cases(np_dtype)[name]
    x, nb, nn, bmap = (torch.tensor(case[k], device=cuda)
                       for k in ("x", "neighbors", "numneigh", "border_map"))
    t = load_eam(eam_file)
    outs = verlet_eam_pair(torch, x, nb, nn, case["nlocal_pad"], VERLET_EAM_CUTSQ,
                           tev.EamDevice.from_tables(t, cuda, tdtype),
                           fit_eam_poly(t) if poly else None, bmap)
    for out in ("rho", "fp", "f"):
        got, again, want = outs[out]
        assert torch.equal(got, again) and torch.equal(got, want), out
    rho, f = outs["rho"][0], outs["f"][0]
    assert bool((rho[case["empty"]] == 0).all()) and bool((f[case["empty"]] == 0).all())
    assert float(rho[case["inside"]]) > 0 and float(f[case["inside"], 1]) != 0


@pytest.mark.cuda
def test_cuda_verlet_eam_float32_occupancy(cuda):
    """The float32 K5 and K6 hold 8 blocks of 8 warps an SM, all 64 warps
    (their launch bounds cap them at 32 registers)."""
    for name in ("eam_rho_nlist", "eam_force_nlist"):
        for poly in (False, True):
            assert tev.nlist_blocks_per_sm(name, torch.float32, poly) == 8, (name, poly)


@pytest.mark.cuda
@pytest.mark.parametrize("poly", [False, True], ids=["spline", "poly"])
@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_cuda_verlet_eam_kernels_on_engine_lists(cuda, eam_file, poly, tdtype):
    """K5 and K6 on a jittered 8^3 verlet EAM engine's lists and halo,
    built on the card, against their plain versions."""
    kw = dict(nx=8, ny=8, nz=8, precision="dp", force_field=FF_EAM, eam_file=eam_file)
    x, v, _ = create_fcc_lattice(apply_eam_overrides(Params(**kw), load_eam(eam_file)))
    x = x + np.random.default_rng(5).normal(0.0, 0.15, x.shape)
    sim = Simulation(Params(**kw), x=x, v=v, device=cuda)
    st = sim.initial_state()
    eam = tev.EamDevice.from_tables(sim.eam_tables, cuda, tdtype)
    outs = verlet_eam_pair(torch, st.x.to(tdtype), st.nlist.neighbors, st.nlist.numneigh,
                           sim.caps.nlocal_pad, sim.params.cutforce**2, eam,
                           fit_eam_poly(sim.eam_tables) if poly else None,
                           st.halo.border_map)
    _verlet_eam_outputs_match(outs, tdtype)


@pytest.mark.cuda
def test_cuda_verlet_eam_wrappers_raise(cuda, eam_file):
    """On a CUDA tensor the wrappers check the operands and raise; they do
    not fall back to the plain version."""
    case = verlet_eam_case(np.float64)
    x, nb, nn = (torch.tensor(case[k], device=cuda) for k in ("x", "neighbors", "numneigh"))
    eam = tev.EamDevice.from_tables(load_eam(eam_file), cuda, torch.float64)
    npad = case["nlocal_pad"]
    with pytest.raises(TypeError):
        tev.eam_rho_nlist(x, nb.int(), nn, npad, VERLET_EAM_CUTSQ, eam)
    with pytest.raises(ValueError):
        tev.eam_rho_nlist(x, nb, nn, npad, VERLET_EAM_CUTSQ, eam._replace(frho=eam.frho.cpu()))
    fp = torch.zeros(x.shape[0], dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        tev.eam_force_nlist(x, nb, nn, fp[:npad].float(), fp, VERLET_EAM_CUTSQ, eam)


@pytest.mark.cuda
@pytest.mark.parametrize("eam_eval", ["spline", "poly"])
def test_cuda_verlet_eam_matches_cpu(cuda, eam_file, eam_eval):
    """A jittered 6^3 DP verlet EAM box, card against the CPU plain path:
    step-0 forces <= 1e-12 of max |f| (only reduction orders differ),
    20-step temperatures <= 1e-12; each card force launches K5 and K6
    once, and no LJ kernel launches."""
    kw = dict(nx=6, ny=6, nz=6, ntimes=20, reneigh_every=10, precision="dp",
              force_field=FF_EAM, eam_file=eam_file, eam_eval=eam_eval)
    x, v, _ = create_fcc_lattice(apply_eam_overrides(Params(**kw), load_eam(eam_file)))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    before = {n: getattr(tlj, n) for n in LJ_COUNTS}
    k56 = dict(tev.LAUNCHES)
    f_gpu = Simulation(Params(**kw), x=x, v=v, device=cuda).first_force()
    assert all(getattr(tlj, n) == before[n] for n in LJ_COUNTS)
    d5, d6 = (tev.LAUNCHES[k] - k56[k] for k in ("eam_rho_nlist", "eam_force_nlist"))
    assert d5 == d6 >= 1
    f_cpu = Simulation(Params(**kw), x=x, v=v, device="cpu").first_force()
    assert np.abs(f_gpu - f_cpu).max() <= 1e-12 * np.abs(f_cpu).max()
    r_gpu = Simulation(Params(**kw), device=cuda).run(repeats=0)
    r_cpu = Simulation(Params(**kw), device="cpu").run(repeats=0)
    np.testing.assert_allclose(r_gpu.temps, r_cpu.temps, rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["full", "half", "spline", "poly"])
def test_cuda_verlet_stub_first_force(cuda, eam_file, kind):
    """The verlet stub's first force on the card against the CPU, float64,
    <= 1e-12 of the largest finite value, non-finite entries equal."""
    from mdbench_tpu_torch.stub import run_stub

    kw = dict(half=kind == "half")
    if kind in ("spline", "poly"):
        kw = dict(force_field="eam", eam_file=eam_file, eam_eval=kind)
    f = [run_stub(natoms=4096, nneighs=40, ntimes=2, precision="dp", device=d,
                  **kw)["first_force"].cpu() for d in (cuda, "cpu")]
    fin = torch.isfinite(f[1])
    assert torch.equal(torch.isfinite(f[0]), fin) and fin.any()
    err = (f[0][fin] - f[1][fin]).abs().max() / f[1][fin].abs().max()
    assert float(err) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["verlet", "cluster"])
def test_cuda_cli_run(cuda, scheme, capsys):
    """A 4^3 DP CLI run on the card: the thermo rows equal the CPU run's
    (rel 1e-9), the device line names the card and the kernel."""
    import re

    from mdbench_tpu_torch.cli import main

    rows = {}
    for dev in ("cuda", "cpu"):
        assert main(f"-nx 4 -ny 4 -nz 4 -n 20 --precision dp --scheme {scheme} "
                    f"--device {dev}".split()) == 0
        out = capsys.readouterr().out
        rows[dev] = np.array([[float(g) for g in m.groups()] for m in
                              map(re.compile(r"^(\d+)\t(\S+)\t(\S+)$").match,
                                  out.splitlines()) if m])
        if dev == "cuda":
            assert f"Device: {torch.cuda.get_device_name()}, force: K1" in out
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("bucketed", [False, True])
def test_cuda_eam_fp_exchange_default_bits(cuda, eam_file, bucketed):
    """The cluster EAM split at the fp plane on the card: the density
    wrapper (K2, or K2b over a hand plan) leaves the ghost rows 0, and with
    the default ghost refresh between it and the pair-force wrapper (K3 or
    K3b) the two give eam_cluster_force's bits; another fill (the ghost fp
    halved) gives the plain split's forces for the same fill."""
    cl, pairs, border_map, _, npad, share = synthetic_eam_case(seed=3, share=2)
    c = clusters_from_numpy(cl, cuda, torch.float64)
    pr = pairs_from_numpy(pairs, cuda)
    bm = torch.tensor(border_map, dtype=torch.int64, device=cuda)
    tables = load_eam(eam_file)
    eam = tec.EamDevice.from_tables(tables, cuda, torch.float64)
    poly = fit_eam_poly(tables)
    planes = (c.xc, c.yc, c.zc)
    kw = dict(share=share)
    if bucketed:
        plan = hand_plan(pr.nji.cpu().numpy(), pr.ijlist.shape[1])
        kw.update(buckets=plan, bpairs=bucket_maps_core(
            pr.ijlist, pr.nji, npad, share, c.xc.shape[0], *plan)[:3])
    cut2 = poly.cut**2

    def split(fill, wrapper=True):
        if wrapper:
            fp = tec.eam_cluster_density(*planes, pr.ijlist, pr.nji, npad, cut2, eam,
                                         poly, **kw)
        else:
            fp = tec.eam_cluster_density_ref(*planes, pr.ijlist, npad, cut2, eam, poly,
                                             **kw)
        assert not fp[npad:].any()
        fill(fp)
        if wrapper:
            return tec.eam_cluster_pair_forces(*planes, fp, pr.ijlist, pr.nji, npad,
                                               cut2, poly, **kw)
        return tec.eam_cluster_pair_forces_ref(*planes, fp, pr.ijlist, npad, cut2, poly,
                                               **kw)

    def halve(fp):
        tec._fp_ghost_refresh(fp, bm, npad)
        fp[npad:] *= 0.5

    before = dict(tec.LAUNCHES)
    want = tec.eam_cluster_force(*planes, pr.ijlist, pr.nji, bm, npad, cut2, eam, poly,
                                 **kw)
    got = split(lambda fp: tec._fp_ghost_refresh(fp, bm, npad))
    torch.cuda.synchronize()
    assert sum(tec.LAUNCHES.values()) - sum(before.values()) == 4
    for x, y in zip(got, want[:3]):
        assert torch.equal(x, y)
    f_k, f_r = split(halve), split(halve, wrapper=False)
    assert _rel(f_k, f_r) <= TOL[torch.float64]
    assert not torch.equal(f_k[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_cuda_domain_matches_cpu(cuda, ndev, kernel):
    """The slab engine on an 8^3 DP box, card against CPU: 20-step
    temperatures within rel 1e-12; the row lists launch K1 and no other
    kernel, the planar path none."""
    from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation

    kw = dict(nx=8, ny=8, nz=8, ntimes=20, reneigh_every=10, precision="dp",
              kernel=kernel)
    before = {n: getattr(tlj, n) for n in LJ_COUNTS}
    r_gpu = DomainSimulation(Params(**kw), ndev=ndev, device=cuda).run(repeats=0)
    grew = {n: getattr(tlj, n) - before[n] for n in LJ_COUNTS}
    rowlist = kernel == "auto"
    assert grew["LAUNCHES"] >= (1 if rowlist else 0)
    assert all(n == 0 for k, n in grew.items() if k != "LAUNCHES" or not rowlist)
    r_cpu = DomainSimulation(Params(**kw), ndev=ndev, device="cpu").run(repeats=0)
    assert sum(int(n) for n in r_gpu.state.nlocal) == 2048
    np.testing.assert_allclose(r_gpu.temps, r_cpu.temps, rtol=1e-12)


@pytest.mark.cuda
def test_cuda_domain_rowlist_launches_k1_without_sync(cuda):
    """An SP row-list run on two slabs: each step's force launches K1 once
    per slab, and no call synchronises the host with the card."""
    from chip_smoke import sync_count
    from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation

    sim = DomainSimulation(Params(nx=16, ny=8, nz=8, ntimes=20, reneigh_every=10,
                                  precision="sp"), ndev=2, device=cuda)
    sim.run(repeats=0)
    assert sim.rbuckets is None  # 4096 atoms: too few units for a plan
    s0 = sim.initial_state()
    torch.cuda.synchronize()
    before = tlj.LAUNCHES
    assert sync_count(torch, lambda: sim._run_steps(s0, 20)) == 0
    assert tlj.LAUNCHES - before == 2 * 20


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lj", "eam", "pallas"])
def test_cuda_cluster_domain_matches_cpu(cuda, eam_file, case):
    """The cluster slab engine on two slabs, card against CPU in float64:
    a jittered 8^3 LJ box (exact lists: K1; kernel="pallas": K4) and a
    6^3 EAM box (K2/K3), a full rebuild every other interval. Step-0
    forces within 1e-12 of max |f| (each slab's atom window in order) and
    40-step temperatures within rel 1e-9; only the path's kernels
    launch."""
    from chip_smoke import domain_first_forces
    from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation

    kw = dict(nx=8, ny=8, nz=8, ntimes=40, reneigh_every=10, resort_every=20,
              precision="dp", scheme="cluster")
    if case == "eam":
        kw.update(nx=6, ny=6, nz=6, force_field=FF_EAM, eam_file=eam_file)
    if case == "pallas":
        kw.update(kernel="pallas")
    p0 = Params(**kw)
    if case == "eam":
        apply_eam_overrides(p0, load_eam(eam_file))
    x, v, _ = create_fcc_lattice(p0)
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    f_cpu = domain_first_forces(ClusterDomainSimulation(Params(**kw), ndev=2, x=x, v=v,
                                                        device="cpu"))
    lj_before = {n: getattr(tlj, n) for n in LJ_COUNTS}
    ec_before = dict(tec.LAUNCHES)
    f_gpu = domain_first_forces(ClusterDomainSimulation(Params(**kw), ndev=2, x=x, v=v,
                                                        device=cuda))
    r_gpu = ClusterDomainSimulation(Params(**kw), ndev=2, device=cuda).run(repeats=0)
    lj_grew = {n: getattr(tlj, n) - lj_before[n] for n in LJ_COUNTS
               if getattr(tlj, n) != lj_before[n]}
    ec_grew = {n: tec.LAUNCHES[n] - ec_before[n] for n in tec.LAUNCHES
               if tec.LAUNCHES[n] != ec_before[n]}
    want = {"lj": ({"LAUNCHES"}, set()), "pallas": ({"STREAM_LAUNCHES"}, set()),
            "eam": (set(), {"eam_rho_ilist", "eam_force_ilist"})}[case]
    assert (set(lj_grew), set(ec_grew)) == want
    r_cpu = ClusterDomainSimulation(Params(**kw), ndev=2, device="cpu").run(repeats=0)
    scale = max(np.abs(a).max() for a in f_cpu)
    for a, b in zip(f_gpu, f_cpu):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12 * scale
    np.testing.assert_array_equal(r_gpu.nlocal, r_cpu.nlocal)
    np.testing.assert_allclose(r_gpu.temps, r_cpu.temps, rtol=1e-9)


@pytest.mark.cuda
def test_cuda_cluster_domain_launches_without_sync(cuda):
    """An SP exact-list run on two slabs: each step's force launches K1
    once per slab, and nothing of the domain engine's own synchronises the
    host with the card (the shared cluster ops' rebuild tables may)."""
    from chip_smoke import sync_sites
    from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation

    sim = ClusterDomainSimulation(Params(nx=16, ny=8, nz=8, ntimes=20, reneigh_every=10,
                                         precision="sp", scheme="cluster"),
                                  ndev=2, device=cuda)
    sim.run(repeats=0)
    assert sim.buckets is None  # too few units a slab for a plan
    s0 = sim.initial_state()
    torch.cuda.synchronize()
    before = tlj.LAUNCHES
    sites = sync_sites(torch, lambda: sim._run_steps(s0, 20))
    assert not [w for w in sites if w.startswith("parallel/")], sites
    assert tlj.LAUNCHES - before == 2 * 20


def _mesh_engine(dims):
    from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation
    from mdbench_tpu_torch.parallel.verlet_domain3d import Domain3DSimulation

    return Domain2DSimulation if len(dims) == 2 else Domain3DSimulation


def _mesh_matches_cpu(cuda, eam_file, dims, case, box):
    """A DP run on the mesh `dims`, card against CPU: 20-step temperatures
    within rel 1e-12 and the same atoms per domain; the row lists launch
    K1 (or K1b) and no other kernel, EAM no hand kernel."""
    engine = _mesh_engine(dims)
    kw = dict(box, ntimes=20, reneigh_every=10, precision="dp")
    if case == "eam":
        kw.update(force_field=FF_EAM, eam_file=eam_file)
    lj_before = {n: getattr(tlj, n) for n in LJ_COUNTS}
    ec_before = dict(tec.LAUNCHES)
    r_gpu = engine(Params(**kw), *dims, device=cuda).run(repeats=0)
    lj_grew = {n for n in LJ_COUNTS if getattr(tlj, n) != lj_before[n]}
    assert dict(tec.LAUNCHES) == ec_before
    assert lj_grew == (set() if case == "eam" else {"LAUNCHES"})
    r_cpu = engine(Params(**kw), *dims, device="cpu").run(repeats=0)
    assert [int(n) for n in r_gpu.state.nlocal] == [int(n) for n in r_cpu.state.nlocal]
    np.testing.assert_allclose(r_gpu.temps, r_cpu.temps, rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("case,box", [("lj", dict(nx=8, ny=8, nz=4)),
                                      ("eam", dict(nx=6, ny=6, nz=4))])
def test_cuda_domain2d_matches_cpu(cuda, eam_file, case, box):
    """The pencil engine on (2, 2): the row lists (K1) and EAM (torch ops)."""
    _mesh_matches_cpu(cuda, eam_file, (2, 2), case, box)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,case,box", [
    ((2, 2, 2), "lj", dict(nx=8, ny=8, nz=8)),
    ((2, 2, 1), "lj", dict(nx=8, ny=8, nz=4)),
    ((2, 2, 2), "eam", dict(nx=4, ny=4, nz=4)),
])
def test_cuda_domain3d_matches_cpu(cuda, eam_file, dims, case, box):
    """The brick engine on (2, 2, 2) and (2, 2, 1) (the z seam by a
    self-send): the row lists (K1) and EAM (torch ops)."""
    _mesh_matches_cpu(cuda, eam_file, dims, case, box)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,box", [((2, 2), dict(nx=16, ny=16, nz=8)),
                                      ((2, 2, 2), dict(nx=16, ny=16, nz=16))])
def test_cuda_mesh_domain_launches_without_sync(cuda, dims, box):
    """An SP row-list run on pencils and on bricks: each step's force
    launches K1 (or K1b, after a plan) once per domain, and nothing of the
    engine's own synchronises the host with the card."""
    from chip_smoke import sync_sites

    sim = _mesh_engine(dims)(Params(**box, ntimes=20, reneigh_every=10,
                                    precision="sp"), *dims, device=cuda)
    sim.run(repeats=0)
    s0 = sim.initial_state()
    torch.cuda.synchronize()
    before = tlj.LAUNCHES + tlj.BUCKET_LAUNCHES
    sites = sync_sites(torch, lambda: sim._run_steps(s0, 20))
    assert not [w for w in sites if w.startswith("parallel/")], sites
    assert tlj.LAUNCHES + tlj.BUCKET_LAUNCHES - before == sim.ndev * 20


# 64-bit addressing: rows past 2^31 bytes of their operands (a 10.1M-atom
# plan's planes stay below it; these cases go past it on purpose)
FAR_J16 = 36_000_000  # K1: the last j16 row, (72M, 8) float32 planes
FAR_ROWS = 192_000_000  # K5/K6: rows of x, (192M, 3) float32


@pytest.mark.cuda
def test_cuda_k1_rows_past_2_31_bytes(cuda):
    """K1 on synthetic_case's lists with every j16 id moved up by
    FAR_J16 - cjn (the sentinel to the last j16 of planes of 2 * FAR_J16
    rows): the largest j16 id x 16 atoms x 3 x 4 bytes, and each plane's
    own byte offset, pass 2^31. Equal to the plain version, and to the
    kernel's bits on the same case at its own ids."""
    cl, pairs, npad, share = synthetic_case(seed=3, nu=64, share=2)
    c = clusters_from_numpy(cl, cuda, torch.float32)
    pr = pairs_from_numpy(pairs, cuda)
    near = tlj.lj_cluster_force_ilist(c.xc, c.yc, c.zc, pr.ijlist, pr.nji, npad,
                                      CUT2, SIG6, EPS, share=share)
    cjn = c.xc.shape[0] // 2
    off = FAR_J16 - cjn
    assert (FAR_J16 - 1) * 16 * 3 * 4 > 2**31 and (FAR_J16 - 1) * 16 * 4 > 2**31
    far = []
    for p in (c.xc, c.yc, c.zc):
        q = torch.full((2 * FAR_J16, 8), SENTINEL_COORD, dtype=torch.float32, device=cuda)
        q[:npad] = p[:npad]  # the i-side rows stay first
        q[2 * off:] = p  # every j16 row moved up by off
        far.append(q)
    ijl = (pr.ijlist.long() + off).to(torch.int32)
    got = tlj.lj_cluster_force_ilist(*far, ijl, pr.nji, npad, CUT2, SIG6, EPS,
                                     share=share)
    torch.cuda.synchronize()
    want = tlj.lj_cluster_force_ilist_ref(*far, ijl, npad, CUT2, SIG6, EPS, share=share)
    assert _rel(got, want) <= TOL[torch.float32]
    assert all(torch.equal(a, b) for a, b in zip(got, near))


@pytest.mark.cuda
@pytest.mark.parametrize("poly", [False, True], ids=["spline", "poly"])
def test_cuda_verlet_eam_rows_past_2_31_bytes(cuda, eam_file, poly):
    """K5 and K6 on chip_smoke.verlet_eam_case with its ghost rows and
    sentinel row moved to the end of an x of FAR_ROWS rows (the rows
    between them sentinel padding, their border map entries the
    sentinel): x's byte offsets pass 2^31. Bit for bit the plain versions,
    two launches the same bits, and the same bits as on the case itself."""
    case = verlet_eam_case(np.float32)
    x0, nb0, nn = (torch.tensor(case[k], device=cuda)
                   for k in ("x", "neighbors", "numneigh"))
    bmap0 = torch.tensor(case["border_map"], device=cuda)
    npad, n0 = case["nlocal_pad"], case["x"].shape[0]
    shift = FAR_ROWS - n0
    assert (FAR_ROWS - 1) * 3 * 4 > 2**31
    x = torch.full((FAR_ROWS, 3), SENTINEL_COORD, dtype=torch.float32, device=cuda)
    x[:npad] = x0[:npad]
    x[npad + shift:] = x0[npad:]
    nb = torch.where(nb0 >= npad, nb0 + shift, nb0)
    bmap = torch.full((FAR_ROWS - 1 - npad,), FAR_ROWS - 1, dtype=bmap0.dtype,
                      device=cuda)
    bmap[shift:] = torch.where(bmap0 >= npad, bmap0 + shift, bmap0)
    t = load_eam(eam_file)
    eam = tev.EamDevice.from_tables(t, cuda, torch.float32)
    fit = fit_eam_poly(t) if poly else None
    near = verlet_eam_pair(torch, x0, nb0, nn, npad, VERLET_EAM_CUTSQ, eam, fit, bmap0)
    far = verlet_eam_pair(torch, x, nb, nn, npad, VERLET_EAM_CUTSQ, eam, fit, bmap)
    for name in ("rho", "fp", "f"):
        got, again, want = far[name]
        assert torch.equal(got, again) and torch.equal(got, want), name
    assert torch.equal(far["rho"][0], near["rho"][0])
    assert torch.equal(far["fp"][0][:npad], near["fp"][0][:npad])
    assert not far["fp"][0][npad:].any()
    assert torch.equal(far["f"][0], near["f"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("share", [1, 2, 4])
def test_cuda_bf16_derive_matches_cpu(cuda, share):
    """derive_ilists(bf16=True) on the card equals the same call on the CPU
    bit for bit (ijlist, nji, iovf): each bfloat16 operation rounds on its
    own on both devices. A jittered 8^3 SP state with ghosts and units of
    padding, the capacity at the group lists' width and at the engine's."""
    from mdbench_tpu_torch.engine_cluster import GROUP
    from mdbench_tpu_torch.ops.cluster import derive_ilists

    kw = dict(nx=8, ny=8, nz=8, precision="sp", scheme="cluster", derive_bf16=True)
    x, v, _ = create_fcc_lattice(Params(**kw))
    x = x + np.random.default_rng(11).normal(0.0, 0.1, x.shape)
    sim = ClusterSimulation(Params(**kw), x=x, v=v, device="cpu")
    st = sim.initial_state()

    def on(nt, dev):
        return type(nt)(*(f.to(dev) if isinstance(f, torch.Tensor) else f for f in nt))

    for icap in (st.pairs.jlist.shape[1], sim.icap):
        args = (sim.n_clusters_pad, GROUP, sim.params.cutneigh, icap)
        want = derive_ilists(st.clusters, st.pairs, *args, share=share, bf16=True)
        got = derive_ilists(on(st.clusters, cuda), on(st.pairs, cuda), *args,
                            share=share, bf16=True)
        for name in ("ijlist", "nji", "iovf"):
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
        assert int(want.nji.sum()) > 0
