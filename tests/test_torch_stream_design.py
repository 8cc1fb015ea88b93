"""The group-window kernel's design on the CPU: the box cull that
csrc/lj_cluster_stream.cu applies before the pair math, mirrored by
`ops/lj_cluster.stream_cull`, and the kernel's work counts
(`stream_work_counts`).

- Every pair with 0 < rsq < cutforcesq (rsq in the kernel's order,
  (dx*dx + dy*dy) + dz*dz, each operation rounded in the planes' dtype)
  lies in a j-cluster that the cull keeps: on a jittered 6^3 box's group
  lists, on random lists, and on built edge cases (a pair exactly at the
  cutoff and one ulp inside it, boxes touching along one axis, padding at
  1e30, NaN planes), in float32 and float64; typed, the cull against the
  tables' largest cutsq keeps every pair inside its own cutsq.
- The force summed over the kept j-clusters only equals mdbench_tpu's
  Pallas stream kernel in interpret mode (float32, 1e-5 of max |f|).
- The per-member counts, and the lock-step design's lane-pairs that
  chip_smoke.py prints beside them, equal brute-force counts.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    boundary_group_lists,
    lockstep_lane_pairs,
    random_group_lists,
    random_tables,
)
from mdbench_tpu.ops.pallas.lj_cluster import lj_cluster_force_pallas_stream
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine_cluster import GROUP, ClusterSimulation
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops import lj_cluster as tlj

torch.set_num_threads(1)

CUT2, SIG6, EPS = 2.5**2, 1.0, 1.0
T_OF = {np.float32: torch.float32, np.float64: torch.float64}
DTYPES = [np.float32, np.float64]


@functools.lru_cache(maxsize=None)
def _engine_lists(np_dtype):
    """The port's own group lists and windows of a jittered 6^3 box
    (kernel="pallas", CPU), as numpy."""
    p = Params(nx=6, ny=6, nz=6, precision="sp" if np_dtype == np.float32 else "dp",
               scheme="cluster", kernel="pallas")
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.1, x.shape)
    sim = ClusterSimulation(p, x=x, v=v, device="cpu")
    st = sim.initial_state()
    cl, pr = st.clusters, st.pairs
    return ([q.numpy() for q in (cl.xc, cl.yc, cl.zc)], pr.jlist.numpy(),
            pr.ranges.numpy(), sim.n_clusters_pad)


def _case(name, np_dtype):
    """(planes as tensors, jlist, ranges, n_clusters_pad)."""
    if name == "engine":
        planes, jl, rg, npad = _engine_lists(np_dtype)
    elif name == "random":
        planes, jl, rg, npad = random_group_lists(seed=4)
    else:
        planes, jl, rg, npad = boundary_group_lists(np_dtype)
    return ([torch.tensor(np.asarray(q, np_dtype)) for q in planes],
            torch.tensor(jl), torch.tensor(rg), npad)


def _inside(planes, jl, rg, cut):
    """(NG*16, 2L) bool: window j-cluster slots holding a pair with 0 <
    rsq < cut, rsq in the kernel's order; `cut` a scalar or a (NG*16, 8,
    2L, 8) tensor of per-pair cutoffs."""
    ng, L = jl.shape
    inwin, jrows = tlj.stream_window(jl, rg)
    rsq = None
    for p in planes:
        d = (p[: ng * GROUP].reshape(ng, GROUP, 8, 1, 1)
             - p[jrows].reshape(ng, 1, 1, 2 * L, 8))
        rsq = d * d if rsq is None else rsq + d * d
    rsq = rsq.reshape(ng * GROUP, 8, 2 * L, 8)
    return inwin & ((rsq > 0) & (rsq < cut)).any(3).any(1), rsq


@pytest.mark.parametrize("np_dtype", DTYPES)
@pytest.mark.parametrize("name", ["engine", "random"])
def test_cull_keeps_every_pair_inside(name, np_dtype):
    planes, jl, rg, _ = _case(name, np_dtype)
    inwin, kept = tlj.stream_cull(*planes, jl, rg, CUT2)
    inside, _ = _inside(planes, jl, rg, CUT2)
    assert inside.any() and not (inside & ~kept).any()
    # the cull is not vacuous: it drops a good share of the window
    assert int(kept.sum()) < 0.9 * int(inwin.sum())


@pytest.mark.parametrize("np_dtype", DTYPES)
def test_cull_edge_cases(np_dtype):
    planes, jl, rg, _ = _case("boundary", np_dtype)
    inwin, kept = tlj.stream_cull(*planes, jl, rg, CUT2)
    inside, rsq = _inside(planes, jl, rg, CUT2)
    assert not (inside & ~kept).any()
    lo, hi = tlj.cluster_boxes(*planes)
    d2 = tlj.box_gap_sq(lo[0], hi[0], lo[48:56], hi[48:56])
    # member 0 meets ghost rows 48-55 in slots 16-23 of its window
    assert bool(inwin[0, 16:24].all())
    # row 48: box distance exactly the cutoff, four pairs exactly at it
    assert float(d2[0]) == CUT2 and not kept[0, 16]
    assert int((rsq[0, :, 16] == CUT2).sum()) == 4 and not inside[0, 16]
    # row 49: one ulp closer, kept, four pairs just inside
    assert float(d2[1]) < CUT2 and kept[0, 17]
    assert int(((rsq[0, :, 17] > 0) & (rsq[0, :, 17] < CUT2)).sum()) == 4
    # row 50 touches member 0's box along x: gap 0 there, 1.5 along y
    assert float(lo[50, 0]) == float(hi[0, 0]) == 1.0
    assert float(d2[2]) == 2.25 and kept[0, 18]
    # padding: a whole row is culled, half a row keeps the rest
    assert not kept[0, 20] and kept[0, 21] and inside[0, 21]
    # NaN: an all-NaN row has NaN bounds, gap 0 and is never culled; a half
    # NaN row's box is its real atoms'
    assert bool(lo[54].isnan().all()) and float(d2[6]) == 0.0 and kept[0, 22]
    assert not inside[0, 22]
    assert bool(torch.isfinite(lo[55]).all()) and kept[0, 23] and inside[0, 23]
    # the windows: member 1 empty, member 2 only tile 1 (njg bounds it),
    # group 2 one tile
    assert not inwin[1].any()
    assert inwin[2].nonzero().flatten().tolist() == list(range(16, 32))
    assert inwin[32:48, :16].all() and not inwin[32:48, 16:].any()
    # the all-padding group keeps only the half-padding row, whose box
    # spans the padding too, and the NaN row; no pair there is inside
    assert kept[16:32].nonzero()[:, 1].unique().tolist() == [5, 6]
    assert not inside[16:32].any()
    # planes all NaN (the cluster stub once its forces overflow): nothing
    # is culled
    nan = [torch.full_like(q, float("nan")) for q in planes]
    inwin_n, kept_n = tlj.stream_cull(*nan, jl, rg, CUT2)
    assert torch.equal(kept_n, inwin_n)


def _kept_force(planes, jl, rg, npad, kept, tc=None, tables=None):
    """The plain windowed force over the kept j-clusters only."""
    ng, L = jl.shape
    member = torch.arange(GROUP * 8) // 8
    slot = torch.arange(L * 16) // 8
    extra = kept.reshape(ng, GROUP, 2 * L)[:, member][:, :, slot]
    rows = torch.arange(ng)[:, None] * GROUP * 8 + torch.arange(GROUP * 8)[None, :]
    dx, dy, dz, gf = tlj._lj_pairs(*planes, jl.long(), rows, CUT2, SIG6, EPS,
                                   extra, tc, tables)
    return tuple((d * gf).sum(2).reshape(npad, 8) for d in (dx, dy, dz))


def _rel(a, b):
    a = np.stack([np.asarray(t, np.float64) for t in a])
    b = np.stack([np.asarray(t, np.float64) for t in b])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return np.abs(a - b).max() / np.abs(b).max()


def test_culled_force_equals_stream_interpret():
    """The force over the kept j-clusters, the pairs the kernel runs,
    against mdbench_tpu's stream kernel in interpret mode (float32)."""
    planes, jl, rg, npad = _case("random", np.float32)
    _, kept = tlj.stream_cull(*planes, jl, rg, CUT2)
    f_k = _kept_force(planes, jl, rg, npad, kept)
    f_p = lj_cluster_force_pallas_stream(
        *(jnp.asarray(p.numpy()) for p in planes), jnp.asarray(jl.numpy()[:, None, :]),
        jnp.asarray(rg.numpy()[:, None, :]), npad, GROUP, CUT2, SIG6, EPS,
        interpret=True)
    assert np.abs(np.asarray(f_p[0])).max() > 1.0
    assert _rel(f_k, f_p) <= 1e-5


@pytest.mark.parametrize("np_dtype", DTYPES)
def test_culled_force_equals_plain_on_edge_cases(np_dtype):
    """The same on the edge cases (padding where the NaN rows were), against
    the plain windowed force (mdbench_tpu's stream kernel takes only
    multiples of 8 groups)."""
    q, jl, rg, npad = boundary_group_lists(np_dtype, nan=False)
    planes, jl, rg = [torch.tensor(p) for p in q], torch.tensor(jl), torch.tensor(rg)
    _, kept = tlj.stream_cull(*planes, jl, rg, CUT2)
    f_k = _kept_force(planes, jl, rg, npad, kept)
    f_r = tlj.lj_cluster_force_group_ref(*planes, jl, npad, CUT2, SIG6, EPS, ranges=rg)
    assert float(f_r[0].abs().max()) > 1.0
    assert _rel(f_k, f_r) <= (1e-5 if np_dtype == np.float32 else 1e-12)


def _brute_counts(planes, jl, rg, cut):
    """Per member (tiles, window j-clusters, kept j-clusters), by loops."""
    ng, L = jl.shape
    dt = planes[0].dtype.type
    out = np.zeros((ng * GROUP, 3), np.int64)
    with np.errstate(over="ignore", invalid="ignore"):  # padding squares to inf
        _brute_loop(planes, jl, rg, cut, dt, out)
    return out


def _brute_loop(planes, jl, rg, cut, dt, out):
    ng, L = jl.shape
    for g in range(ng):
        njg = min(max(int(rg[g, 32]), 0), L // 8)
        for m in range(GROUP):
            s0, s1 = max(int(rg[g, m]), 0), min(int(rg[g, GROUP + m]), njg)
            r = g * GROUP + m
            ilo = [np.fmin.reduce(p[r]) for p in planes]
            ihi = [np.fmax.reduce(p[r]) for p in planes]
            kept = 0
            for e in range(8 * s0, 8 * max(s1, s0)):
                for half in (0, 1):
                    j = 2 * int(jl[g, e]) + half
                    sq = []
                    for a, p in enumerate(planes):
                        gap = np.fmax(np.fmax(ilo[a] - np.fmax.reduce(p[j]),
                                              np.fmin.reduce(p[j]) - ihi[a]), dt(0))
                        sq.append(gap * gap)
                    kept += not ((sq[0] + sq[1]) + sq[2] >= dt(cut))
            n = 16 * max(s1 - s0, 0)
            out[r] = (n // 16, n, kept)


@pytest.mark.parametrize("name", ["engine", "random", "boundary"])
def test_work_counts_match_brute_force(name):
    np_dtype = np.float32
    planes, jl, rg, _ = _case(name, np_dtype)
    got = tlj.stream_work_counts(*planes, jl, rg, CUT2)
    want = _brute_counts([p.numpy() for p in planes], jl.numpy(), rg.numpy(), CUT2)
    for c, key in enumerate(("tiles", "window_clusters", "kept_clusters")):
        np.testing.assert_array_equal(got[key].numpy(), want[:, c])
    np.testing.assert_array_equal(got["lane_pairs"].numpy(), 64 * want[:, 2])
    assert want[:, 2].sum() > 0
    # the lock-step design's lane-pairs: a warp of 4 members runs a tile
    # below njg when any of their windows holds it, 128 x 32 a warp tile
    r = rg.numpy()
    warp_tiles = sum(
        any(r[g, m] <= t < r[g, GROUP + m] for m in range(4 * w, 4 * w + 4))
        for g in range(r.shape[0]) for w in range(4) for t in range(r[g, 32]))
    assert lockstep_lane_pairs(torch, rg) == warp_tiles * 128 * 32


@pytest.mark.parametrize("np_dtype", DTYPES)
def test_typed_cull_keeps_pairs_inside_their_cutsq(np_dtype):
    """Three random types with cutoffs in [2.0, 2.2]: the cull against the
    tables' largest cutsq keeps every pair inside its own, and the force
    over the kept j-clusters equals the typed plain force."""
    planes, jl, rg, npad = _case("random", np_dtype)
    tc = torch.tensor(np.random.default_rng(7).integers(0, 3, tuple(planes[0].shape)),
                      dtype=torch.int32)
    tables = tuple(torch.tensor(t, dtype=T_OF[np_dtype])
                   for t in random_tables(8, 3, cutforce=2.2))
    cut = float(tables[2].max())
    inwin, kept = tlj.stream_cull(*planes, jl, rg, cut)
    ng, L = jl.shape
    _, jrows = tlj.stream_window(jl, rg)
    ti = tc[: ng * GROUP].reshape(ng, GROUP, 8, 1, 1).long()
    tj = tc[jrows].reshape(ng, 1, 1, 2 * L, 8).long()
    pair_cut = tables[2][ti, tj].reshape(ng * GROUP, 8, 2 * L, 8)
    inside, _ = _inside(planes, jl, rg, pair_cut)
    assert inside.any() and not (inside & ~kept).any()
    assert int(kept.sum()) < int(inwin.sum())
    f_k = _kept_force(planes, jl, rg, npad, kept, tc, tables)
    f_r = tlj.lj_cluster_force_group_ref(*planes, jl, npad, CUT2, SIG6, EPS,
                                         ranges=rg, tc=tc, tables=tables)
    assert _rel(f_k, f_r) <= (1e-5 if np_dtype == np.float32 else 1e-12)


def test_stream_args_refuse_misaligned_planes():
    """The kernel reads the planes as 16-byte vectors: a plane that starts
    off a 16-byte boundary is refused before any launch."""
    planes, jl, rg, npad = _case("random", np.float32)
    flat = torch.zeros(planes[0].numel() + 1)
    shifted = flat[1:].view(planes[0].shape)
    shifted.copy_(planes[0])
    tlj._check_stream_args(*planes, jl, rg, npad)
    with pytest.raises(ValueError, match="16-byte"):
        tlj._check_stream_args(shifted, *planes[1:], jl, rg, npad)
