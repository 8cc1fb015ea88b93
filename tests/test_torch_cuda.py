"""The force kernels (the exact-list LJ kernel csrc/lj_cluster_ilist.cu,
the two EAM passes of csrc/eam_cluster.cu and the group-window LJ kernel
csrc/lj_cluster_stream.cu) against their plain torch versions, on a CUDA
card. This file imports no jax, so it runs on a machine that has
torch and a card but no jax:

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

from chip_smoke import random_group_lists, write_standin_funcfl
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.convert import clusters_from_numpy, pairs_from_numpy
from mdbench_tpu_torch.engine_cluster import ClusterSimulation
from mdbench_tpu_torch.models.eam_tables import (
    apply_eam_overrides,
    fit_eam_poly,
    load_eam,
)
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops import eam_cluster as tec
from mdbench_tpu_torch.ops import lj_cluster as tlj
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
    assert tec.LAUNCHES == {k: n + 1 for k, n in before.items()}
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
