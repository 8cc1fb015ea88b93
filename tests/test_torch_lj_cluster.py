"""The exact-list LJ force: the port's plain version against mdbench_tpu's
XLA twin (float64 and float32) and its Pallas kernel in interpret mode
(float32), on the same planes and lists carried across by convert.py —
an engine state with padding units, and a synthetic case with sentinel
ids inside the lists and all-padding units. Tolerances are relative to
max |f|: 1e-12 in float64, 1e-5 in float32 (summation order differs).

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops.pallas.lj_cluster import (
    lj_cluster_force_ilist_pallas,
    lj_cluster_force_xla_ilist,
)
from mdbench_tpu_torch.convert import clusters_from_numpy, pairs_from_numpy
from mdbench_tpu_torch.ops import lj_cluster as tlj
from test_torch_cuda import synthetic_case

torch.set_num_threads(1)

CUT2, SIG6, EPS = 2.5**2, 1.0, 1.0
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _engine_case():
    """Planes and exact lists of a jittered 6^3 box from mdbench_tpu."""
    p = JParams(nx=6, ny=6, nz=6, precision="dp", scheme="cluster")
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    sim = JSim(p, x=x, v=v)
    st = jax.jit(sim.initial_state)()
    cl = {k: np.asarray(getattr(st.clusters, k)) for k in st.clusters._fields}
    pairs = {k: np.asarray(getattr(st.pairs, k)) for k in
             ("jlist", "nj", "overflow", "ijlist", "nji", "iovf")}
    return cl, pairs, sim.n_clusters_pad, sim.ishare


CASES = {"engine": _engine_case, "synthetic": synthetic_case}


def _port(case, dtype, device="cpu"):
    cl, pairs, npad, share = case
    c = clusters_from_numpy(cl, device, dtype)
    pr = pairs_from_numpy(pairs, device)
    return c, pr, npad, share


def _rel(a, b):
    a = np.stack([np.asarray(t, np.float64) for t in a])
    b = np.stack([np.asarray(t, np.float64) for t in b])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return np.abs(a - b).max() / np.abs(b).max()


def _padding_units(cl, npad, share):
    real = np.abs(cl["xc"][:npad]) < 1e29
    return (~real.reshape(-1, share * 8).any(1)).sum()


@pytest.mark.parametrize("name", ["engine", "synthetic"])
@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
def test_plain_force_matches_jax(name, np_dtype):
    case = CASES[name]()
    cl, pairs, npad, share = case
    assert _padding_units(cl, npad, share) > 0
    sentinel16 = cl["xc"].shape[0] // 2 - 1
    assert (pairs["ijlist"] == sentinel16).any()
    tdtype = torch.float64 if np_dtype == np.float64 else torch.float32
    c, pr, _, _ = _port(case, tdtype)
    f_t = tlj.lj_cluster_force_ilist_ref(
        c.xc, c.yc, c.zc, pr.ijlist, npad, CUT2, SIG6, EPS, share=share)
    jp = [jnp.asarray(cl[k].astype(np_dtype)) for k in ("xc", "yc", "zc")]
    ijl = jnp.asarray(pairs["ijlist"])
    f_j = lj_cluster_force_xla_ilist(*jp, ijl, npad, CUT2, SIG6, EPS, share=share)
    assert np.abs(np.asarray(f_j[0])).max() > 1e-3  # forces are not trivial
    assert _rel(f_t, f_j) <= TOL[np_dtype]
    if np_dtype == np.float32:
        f_p = lj_cluster_force_ilist_pallas(
            *jp, ijl, npad, CUT2, SIG6, EPS, share=share, interpret=True)
        assert _rel(f_t, f_p) <= TOL[np_dtype]


def test_wrapper_on_cpu_is_the_plain_version():
    case = synthetic_case(seed=1)
    c, pr, npad, share = _port(case, torch.float64)
    before = tlj.LAUNCHES
    f_w = tlj.lj_cluster_force_ilist(
        c.xc, c.yc, c.zc, pr.ijlist, pr.nji, npad, CUT2, SIG6, EPS, share=share)
    f_r = tlj.lj_cluster_force_ilist_ref(
        c.xc, c.yc, c.zc, pr.ijlist, npad, CUT2, SIG6, EPS, share=share)
    for a, b in zip(f_w, f_r):
        assert torch.equal(a, b)
    assert tlj.LAUNCHES == before


def _args():
    case = synthetic_case(seed=2)
    c, pr, npad, share = _port(case, torch.float32)
    return dict(xc=c.xc, yc=c.yc, zc=c.zc, ijlist=pr.ijlist, nji=pr.nji,
                n_clusters_pad=npad, share=share)


@pytest.mark.parametrize("bad,exc", [
    (lambda a: {**a, "xc": a["xc"].double()}, ValueError),
    (lambda a: {**a, "xc": a["xc"].half(), "yc": a["yc"].half(),
                "zc": a["zc"].half()}, TypeError),
    (lambda a: {**a, "yc": a["yc"].t().contiguous().t()}, ValueError),
    (lambda a: {**a, "ijlist": a["ijlist"].long()}, TypeError),
    (lambda a: {**a, "share": 3}, ValueError),
    (lambda a: {**a, "n_clusters_pad": a["n_clusters_pad"] + 2}, ValueError),
    (lambda a: {**a, "nji": a["nji"][:-1]}, ValueError),
])
def test_kernel_argument_checks_raise(bad, exc):
    args = _args()
    tlj._check_cuda_args(**args)  # the good arguments pass
    with pytest.raises(exc):
        tlj._check_cuda_args(**bad(args))


def test_wrapper_refuses_other_devices():
    args = _args()
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in args.items()}
    with pytest.raises(ValueError, match="no force kernel"):
        tlj.lj_cluster_force_ilist(
            meta["xc"], meta["yc"], meta["zc"], meta["ijlist"], meta["nji"],
            meta["n_clusters_pad"], CUT2, SIG6, EPS, share=meta["share"])

