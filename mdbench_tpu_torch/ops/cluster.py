"""GROMACS-style M x N cluster machinery in torch ops (the port of
``mdbench_tpu.ops.cluster``: the group lists with or without their
per-member tile windows, the windows' refresh, the exact unit lists, and
the capacity buckets over them: the planner and the per-rebuild maps).

Reference scheme (src/clusterpair/): atoms grouped into 8-atom i-clusters
and 16-atom j-clusters ("j16": two consecutive 8-atom rows), bounding-box
pruned cluster-pair lists, then exact per-i-unit lists by the minimum
atom-atom distance (neighbor.c:176-436, 663-1021).

The functions keep the JAX package's contracts: the same capacities, the
same padding (sentinel coordinates, sentinel j16 ids), the same overflow
flags, and the same list order where the order decides the force
summation. Compactions are written the torch way (cumsum + scatter or a
sort on a packed key), not as the TPU's sort-only forms. Everything stays
on the input tensors' device and does not synchronise with the host.

Layout, as in mdbench_tpu: coordinate planes are (C_total, 8) — local
clusters [0, n_clusters_pad), then ghost rows, then two all-sentinel rows
(the last j16 is the list padding target).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mdbench_tpu_torch.state import SENTINEL_COORD

M = 8  # atoms per i-cluster
N_J = 16  # atoms per j-cluster (M = N/2 geometry, reference force.h:74-91)
TILE_J = 8  # j16 clusters per window tile (128 atoms)


class ClusterGrid(NamedTuple):
    """Static geometry for cluster binning and pair search (host values;
    see ``mdbench_tpu.ops.cluster.ClusterGrid`` for each field)."""

    col_dims: tuple  # (ncx, ncy) interior columns
    col_size: tuple  # (sx, sy) >= cutneigh
    bin_dims: tuple  # (bx, by, bz) incl. 2-bin margin rings
    bin_size: tuple  # (sx, sy, sz)
    bin_capacity: int  # j16 clusters per search bin
    stencil: tuple  # (Wx, Wy, Wz) candidate window in bins
    slop_z: float  # assumed max half-z-extent of any cluster (checked)
    zspan_factor: float  # group z-extent headroom over the mean
    prd: tuple
    cutneigh: float
    slop_xy: float = 0.35  # assumed max xy half-extent excess (checked)
    drift_xy: float = 0.4  # group xy bbox growth budget between resorts

    @property
    def nbins(self) -> int:
        b = self.bin_dims
        return b[0] * b[1] * b[2]


def make_cluster_grid(
    prd, cutneigh: float, rho: float, group: int,
    bin_capacity: int = 0, slop_z: float = 0.0, zspan_factor: float = 1.4,
    slop_xy: float = 0.35, drift_xy: float = 0.4,
) -> ClusterGrid:
    """Column/bin geometry, identical to mdbench_tpu's (host arithmetic):
    xy columns of at least cutneigh, coarse z bins holding ~4.5 j16 on
    average, and a candidate window wide enough for a group's bbox plus
    cutneigh plus the j-cluster half-extent slop."""
    ncx = max(1, int(math.floor(prd[0] / cutneigh)))
    ncy = max(1, int(math.floor(prd[1] / cutneigh)))
    sx, sy = prd[0] / ncx, prd[1] / ncy
    zbin_occ = 4.5  # target mean j16 per z bin
    sz_t = max(zbin_occ * N_J / (rho * sx * sy), 1e-6)
    nz = max(1, int(round(prd[2] / sz_t)))
    sz = prd[2] / nz
    bin_dims = (ncx + 4, ncy + 4, nz + 4)
    if bin_capacity <= 0:
        mean16 = rho * sx * sy * sz / N_J
        bin_capacity = max(8, int(math.ceil(mean16 * 1.7 / 4.0)) * 4)
    if slop_z <= 0.0:
        slop_z = max(1.15 * N_J / (sx * sy * rho), 0.5)
    zspan = group * M / (sx * sy * rho) * zspan_factor

    def win(extent, c, slop, binsize, maxdim):
        span = extent + 2.0 * (c + slop)
        return min(int(math.ceil(span / binsize)) + 1, maxdim)

    wx = win(sx + 2 * drift_xy, cutneigh, sx / 2 + slop_xy, sx, bin_dims[0])
    wy = win(sy + 2 * drift_xy, cutneigh, sy / 2 + slop_xy, sy, bin_dims[1])
    wz = win(zspan, cutneigh, slop_z, sz, bin_dims[2])
    return ClusterGrid(
        col_dims=(ncx, ncy),
        col_size=(sx, sy),
        bin_dims=bin_dims,
        bin_size=(sx, sy, sz),
        bin_capacity=bin_capacity,
        stencil=(wx, wy, wz),
        slop_z=slop_z,
        zspan_factor=zspan_factor,
        prd=tuple(prd),
        cutneigh=cutneigh,
        slop_xy=slop_xy,
        drift_xy=drift_xy,
    )


class Clusters(NamedTuple):
    """Cluster-layout state. Planes are (C_total, 8); bbox rows are
    [xmin xmax ymin ymax zmin zmax 0 0]."""

    xc: torch.Tensor
    yc: torch.Tensor
    zc: torch.Tensor
    bbox: torch.Tensor  # (C_total, 8)
    atom_id: torch.Tensor  # (n_clusters_pad, 8) int64 atom row, -1 = pad
    inv_map: torch.Tensor  # (nlocal,) int64 atom row -> cluster*8+slot
    # (C_total, 8) int32 atom types (reference cl_type, clusterpair/
    # atom.h:36), 0 in padding and sentinel rows; None on untyped runs
    tc: Optional[torch.Tensor] = None


class ClusterHalo(NamedTuple):
    """Ghost j16 images: ghost j16 g copies owner j16 border_map[g]
    shifted by (shift_x, shift_y, shift_z)[g]."""

    border_map: torch.Tensor  # (gcap16,) int64 owner j16
    shift_x: torch.Tensor  # (gcap16,)
    shift_y: torch.Tensor
    shift_z: torch.Tensor
    nghost: torch.Tensor  # () int64
    overflow: torch.Tensor  # () bool


class ClusterPairList(NamedTuple):
    """Group-shared j16 lists, with either the per-member tile windows of
    the group-window force (`ranges`) or the exact per-i-unit lists derived
    from them (an i-unit = `share` consecutive i-clusters)."""

    # (NG, L) j16 ids, z-ordered: int64; int32 in the windowed form (the
    # group-window kernel's operand)
    jlist: torch.Tensor
    nj: torch.Tensor  # (NG,) int64 kept entries per group
    overflow: torch.Tensor  # (2,) bool: [nj > L, window coverage]
    ijlist: Optional[torch.Tensor] = None  # (n_units, icap) int32
    nji: Optional[torch.Tensor] = None  # (n_units,) int32
    iovf: Optional[torch.Tensor] = None  # () bool — nji > icap anywhere
    # (NG, 2*group+1) int32: each member's start tile, then its end tile,
    # then the group's tile bound njg (a tile = TILE_J j16 = 128 atoms)
    ranges: Optional[torch.Tensor] = None
    # capacity-bucket maps (attach_bucket_maps; untyped exact-list runs
    # with a bucket plan): units in nji order, padded with dummy units to
    # the plan's total
    bijlist: Optional[torch.Tensor] = None  # (total_units, icap) int32
    bcrows: Optional[torch.Tensor] = None  # (total_units*share,) int32 rows
    binv: Optional[torch.Tensor] = None  # (n_clusters_pad,) int32 inverse


def _zbits(z: torch.Tensor) -> torch.Tensor:
    """Monotonic int64 key of float32(z) (a signed int32 bit pattern,
    shifted non-negative)."""
    return z.to(torch.float32).view(torch.int32).to(torch.int64) + (1 << 31)


def build_clusters(
    grid: ClusterGrid,
    x: torch.Tensor,  # (nrows, 3) atom positions, locals [0, nlocal)
    nlocal: int,
    n_clusters_pad: int,  # local cluster capacity
    ghost_capacity: int,  # ghost row capacity
    group: int = 1,  # pad each column to a multiple of `group` clusters
    types: Optional[torch.Tensor] = None,  # (>= nlocal,) int atom types
) -> tuple[Clusters, torch.Tensor]:
    """Sort atoms by (column, float32 z, atom row) and chop each column's
    run into 8-atom clusters, padding each column's cluster count to a
    multiple of `group` (reference binAtoms + sortAtomsByZCoord +
    buildClusters, neighbor.c:599-753). With `types`, the clusters carry
    the atoms' types in the int32 plane `tc` (0 in padding, ghost and
    sentinel rows; update_cluster_pbc fills the ghost rows). Returns
    (clusters, overflow)."""
    dev, dtype = x.device, x.dtype
    xl = x[:nlocal]
    sx, sy = grid.col_size
    ncx, ncy = grid.col_dims
    ncol = ncx * ncy
    cx = (xl[:, 0] / sx).to(torch.int64).clamp(0, ncx - 1)
    cy = (xl[:, 1] / sy).to(torch.int64).clamp(0, ncy - 1)
    col = cx * ncy + cy
    # one stable sort on (col, zbits); stability breaks ties by atom row
    _, perm = torch.sort((col << 32) + _zbits(xl[:, 2]), stable=True)
    sorted_col = col[perm]

    ar = torch.arange(ncol + 1, device=dev)
    col_start = torch.searchsorted(sorted_col, ar)
    col_count = col_start[1:] - col_start[:-1]
    clusters_per_col = (col_count + (M - 1)) // M
    if group > 1:
        clusters_per_col = (clusters_per_col + (group - 1)) // group * group
    base = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=dev),
         torch.cumsum(clusters_per_col, 0)]
    )
    n_clusters = base[-1]
    overflow = n_clusters > n_clusters_pad

    # inverse map: cluster row -> (column, rank within column)
    c_ids = torch.arange(n_clusters_pad, device=dev)
    c_col = (torch.searchsorted(base, c_ids, right=True) - 1).clamp(0, ncol - 1)
    within = c_ids - base[c_col]
    slot = torch.arange(M, device=dev)[None, :]
    rank = within[:, None] * M + slot  # (n_clusters_pad, M)
    valid = (rank < col_count[c_col][:, None]) & (c_ids < n_clusters)[:, None]
    src = (col_start[c_col][:, None] + rank).clamp(0, nlocal - 1)
    atom_rows = perm[src]

    # two trailing sentinel rows keep the row count even and make the
    # last j16 all-sentinel (the list padding target)
    total = n_clusters_pad + ghost_capacity + 2
    # per-slot padding displacement (computed in float32, as in
    # mdbench_tpu): no two padding atoms coincide
    slot_rank = (
        torch.arange(n_clusters_pad, dtype=torch.float32, device=dev)[:, None] * M
        + torch.arange(M, dtype=torch.float32, device=dev)[None, :]
    )
    pad_coord = (SENTINEL_COORD * (1.0 + slot_rank * 1e-6)).to(dtype)

    def plane(c):
        full = torch.full((total, M), SENTINEL_COORD, dtype=dtype, device=dev)
        full[:n_clusters_pad] = torch.where(valid, xl[atom_rows, c], pad_coord)
        return full

    xc, yc, zc = plane(0), plane(1), plane(2)
    tc = None
    if types is not None:
        tc = torch.zeros((total, M), dtype=torch.int32, device=dev)
        tc[:n_clusters_pad] = torch.where(valid, types[:nlocal][atom_rows], 0)
    aid = torch.where(valid, atom_rows, -1)
    slots = torch.arange(n_clusters_pad * M, device=dev)
    dest = torch.where(valid, atom_rows, nlocal).reshape(-1)
    inv = torch.zeros(nlocal + 1, dtype=torch.int64, device=dev)
    inv[dest] = slots  # invalid slots all land in the dropped last entry
    return Clusters(
        xc=xc, yc=yc, zc=zc, bbox=compute_bboxes(xc, yc, zc),
        atom_id=aid, inv_map=inv[:nlocal], tc=tc,
    ), overflow


def compute_bboxes(xc, yc, zc) -> torch.Tensor:
    """Per-cluster bounding boxes over real (non-sentinel) atoms
    (reference buildClusters bbox fill, neighbor.c:739-752); an
    all-sentinel row gets lo=+SENTINEL, hi=-SENTINEL."""
    valid = xc.abs() < SENTINEL_COORD * 0.5

    def mm(p):
        lo = torch.where(valid, p, SENTINEL_COORD).amin(1)
        hi = torch.where(valid, p, -SENTINEL_COORD).amax(1)
        return lo, hi

    xlo, xhi = mm(xc)
    ylo, yhi = mm(yc)
    zlo, zhi = mm(zc)
    pad = torch.zeros_like(xlo)
    return torch.stack([xlo, xhi, ylo, yhi, zlo, zhi, pad, pad], dim=1)


def make_j16_bboxes(bbox: torch.Tensor) -> torch.Tensor:
    """Combine row pairs (2k, 2k+1) into 16-atom j-cluster bboxes
    (reference defineJClusters, neighbor.c:755-873)."""
    b0 = bbox[0::2]
    b1 = bbox[1::2]
    z = torch.zeros_like(b0[:, 0])
    return torch.stack(
        [
            torch.minimum(b0[:, 0], b1[:, 0]),
            torch.maximum(b0[:, 1], b1[:, 1]),
            torch.minimum(b0[:, 2], b1[:, 2]),
            torch.maximum(b0[:, 3], b1[:, 3]),
            torch.minimum(b0[:, 4], b1[:, 4]),
            torch.maximum(b0[:, 5], b1[:, 5]),
            z,
            z,
        ],
        dim=1,
    )


_SHIFTS = np.array(
    [
        (sx, sy, sz)
        for sx in (-1, 0, 1)
        for sy in (-1, 0, 1)
        for sz in (-1, 0, 1)
        if (sx, sy, sz) != (0, 0, 0)
    ],
    dtype=np.int64,
)


def setup_cluster_pbc(
    clusters: Clusters,
    n_clusters_pad: int,
    ghost_capacity: int,  # ghost ROW capacity (must be even)
    prd,
    pbc,
    cutneigh: float,
) -> ClusterHalo:
    """Ghost creation at j16 granularity (reference setupPbc,
    src/clusterpair/pbc.c:144-299): local j16 k spawns an image for shift
    s iff its bbox lies within cutneigh of the boundary s points away
    from. Images are ordered by (k, shift index), as in mdbench_tpu."""
    if ghost_capacity % 2:
        raise ValueError("ghost_capacity must be even")
    dev, dtype = clusters.xc.device, clusters.xc.dtype
    gcap16 = ghost_capacity // 2
    bb16 = make_j16_bboxes(clusters.bbox[:n_clusters_pad])
    prd_v = np.asarray(prd, np.float64)
    nshift = _SHIFTS.shape[0]

    lo = torch.stack([bb16[:, 0], bb16[:, 2], bb16[:, 4]], dim=1) < cutneigh
    hi = torch.stack([bb16[:, 1], bb16[:, 3], bb16[:, 5]], dim=1) >= (
        torch.as_tensor(prd_v, dtype=dtype, device=dev) - cutneigh
    )
    pbc_ok = torch.as_tensor(
        np.all((_SHIFTS == 0) | (np.asarray(pbc)[None, :] != 0), axis=1),
        device=dev,
    )
    sh = torch.as_tensor(_SHIFTS, device=dev)
    pos_ok = torch.where(sh[None] == 1, lo[:, None, :], True)
    neg_ok = torch.where(sh[None] == -1, hi[:, None, :], True)
    # all-sentinel j16 fail both boundary tests automatically
    flat = ((pos_ok & neg_ok).all(dim=2) & pbc_ok[None, :]).reshape(-1)
    nghost = flat.sum()
    overflow = nghost > gcap16

    # order-preserving compaction; unused slots hold (sentinel16, shift 0)
    sentinel16 = clusters.xc.shape[0] // 2 - 1
    pos = torch.cumsum(flat, 0) - 1
    dst = torch.where(flat & (pos < gcap16), pos, gcap16)
    packed = torch.full(
        (gcap16 + 1,), sentinel16 * nshift, dtype=torch.int64, device=dev
    )
    packed[dst] = torch.arange(flat.shape[0], device=dev)
    packed = packed[:gcap16]
    border_map = packed // nshift
    sidx = packed - border_map * nshift
    shift_tab = torch.as_tensor(
        _SHIFTS.astype(np.float64) * prd_v[None, :], dtype=dtype, device=dev
    )
    sxyz = shift_tab[sidx]
    return ClusterHalo(
        border_map=border_map, shift_x=sxyz[:, 0], shift_y=sxyz[:, 1],
        shift_z=sxyz[:, 2], nghost=nghost, overflow=overflow,
    )


def update_cluster_pbc(
    clusters: Clusters, halo: ClusterHalo, n_clusters_pad: int,
    update_bbox: bool,
) -> Clusters:
    """Refresh the ghost rows from their owners (reference updatePbc,
    clusterpair/pbc.c:45-113): ghost rows (2g, 2g+1) = owner rows
    (2b, 2b+1) + shift. Updates the planes (and, with update_bbox, the
    bboxes and the type plane, if any) IN PLACE, where mdbench_tpu
    rebuilt them with .at[].set;
    owners are local or sentinel rows, never ghost rows, so reads and
    writes do not overlap. Returns `clusters` for chaining."""
    g0 = n_clusters_pad
    nrows_g = 2 * halo.border_map.shape[0]
    row_map = (
        2 * halo.border_map[:, None]
        + torch.arange(2, device=halo.border_map.device)[None, :]
    ).reshape(-1)
    shx = halo.shift_x.repeat_interleave(2)
    shy = halo.shift_y.repeat_interleave(2)
    shz = halo.shift_z.repeat_interleave(2)
    clusters.xc[g0 : g0 + nrows_g] = clusters.xc[row_map] + shx[:, None]
    clusters.yc[g0 : g0 + nrows_g] = clusters.yc[row_map] + shy[:, None]
    clusters.zc[g0 : g0 + nrows_g] = clusters.zc[row_map] + shz[:, None]
    if update_bbox:
        z = torch.zeros_like(shx)
        shift8 = torch.stack([shx, shx, shy, shy, shz, shz, z, z], dim=1)
        clusters.bbox[g0 : g0 + nrows_g] = clusters.bbox[row_map] + shift8
        if clusters.tc is not None:
            clusters.tc[g0 : g0 + nrows_g] = clusters.tc[row_map]
    return clusters


def bin_clusters(grid: ClusterGrid, bb: torch.Tensor):
    """Bin j16 clusters by bbox center into (col, zslab) search bins
    (reference binClusters, neighbor.c:875-1021). Returns
    (bb_cells, (ovf_cap, ovf_zext)): bb_cells (nbins+1, cap, 8) holds each
    binned j16's bbox with its id in column 6. Empty slots hold the last
    (all-sentinel) j16, whose empty bbox fails every distance test."""
    dev = bb.device
    dims = grid.bin_dims
    size = grid.bin_size
    cap = grid.bin_capacity
    nbins = grid.nbins

    def bin_of(lo, hi, s, n):
        b = torch.floor(0.5 * (lo + hi) / s).clamp(-4, n) + 2
        return b.to(torch.int64).clamp(0, n - 1)

    bx = bin_of(bb[:, 0], bb[:, 1], size[0], dims[0])
    by = bin_of(bb[:, 2], bb[:, 3], size[1], dims[1])
    bz = bin_of(bb[:, 4], bb[:, 5], size[2], dims[2])
    flat = (bx * dims[1] + by) * dims[2] + bz
    # an all-sentinel bbox's center averages to ~0: test the corner
    invalid = ~(bb[:, 0] < SENTINEL_COORD * 0.25)
    ids = torch.where(invalid, nbins, flat)
    # the pair search assumes z half-extent <= slop_z and xy half-extent
    # <= col_size/2 + slop_xy
    ext_ok = (
        (0.5 * (bb[:, 5] - bb[:, 4]) <= grid.slop_z)
        & (0.5 * (bb[:, 1] - bb[:, 0]) <= size[0] / 2 + grid.slop_xy)
        & (0.5 * (bb[:, 3] - bb[:, 2]) <= size[1] / 2 + grid.slop_xy)
    )
    ovf_zext = (~(ext_ok | invalid)).any()

    nrows = bb.shape[0]
    sorted_ids, order = torch.sort(ids, stable=True)
    iota = torch.arange(nrows, device=dev)
    newrun = torch.ones(nrows, dtype=torch.bool, device=dev)
    newrun[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(torch.where(newrun, iota, 0), 0).values
    rank = iota - run_start
    valid = sorted_ids < nbins
    in_cap = rank < cap
    ovf_cap = (valid & ~in_cap).any()
    pos = torch.where(valid & in_cap, sorted_ids * cap + rank, (nbins + 1) * cap)
    cells = torch.full(((nbins + 1) * cap + 1,), nrows - 1, dtype=torch.int64,
                       device=dev)
    cells[pos] = order
    bb_id = bb.clone()
    bb_id[:, 6] = iota.to(bb.dtype)
    return bb_id[cells[:-1].reshape(nbins + 1, cap)], (ovf_cap, ovf_zext)


def build_cluster_pairs(
    grid: ClusterGrid,
    bb_cells: torch.Tensor,  # (nbins+1, cap, 8) bbox + id, from bin_clusters
    ibbox: torch.Tensor,  # (>= n_clusters_pad, 8) i-cluster bboxes
    n_clusters_pad: int,
    group: int,
    list_capacity: int,
    need_ranges: bool = False,
) -> ClusterPairList:
    """Shared j16 list per group of `group` consecutive i-clusters
    (reference buildNeighbor, neighbor.c:176-436): every j16 in the
    group's bin window whose bbox is within cutneigh of the group bbox;
    the rest of each row holds the sentinel j16.

    need_ranges=False (the exact-list path): kept entries are ordered by
    (quantised bbox zmin, id), the order of mdbench_tpu's packed-key path,
    which the exact lists inherit.

    need_ranges=True (the group-window path): kept entries are ordered by
    (exact bbox zmin, id) and each member gets the tile window of the
    entries it can reach, [start, end) in tiles of TILE_J entries:
        start = #{prefix-max zmax < zmin_i - cutneigh}
        end   = min(#{zmin <= zmax_i + cutneigh}, nj, L)
    (mdbench_tpu sorts by zmin alone, unstably, and the id breaks ties
    here: entries whose zmin ties, such as ghost images shifted along x
    or y, may stand in another order there. The windows are the same.)"""
    dev = ibbox.device
    ng = n_clusters_pad // group
    dims = grid.bin_dims
    size = grid.bin_size
    cap = grid.bin_capacity
    wx, wy, wz = grid.stencil
    cutsq = grid.cutneigh * grid.cutneigh

    bb_local = ibbox[:n_clusters_pad].reshape(ng, group, 8)
    gmin = [bb_local[:, :, c].amin(1) for c in (0, 2, 4)]
    gmax = [bb_local[:, :, c].amax(1) for c in (1, 3, 5)]
    slop = (size[0] / 2 + grid.slop_xy, size[1] / 2 + grid.slop_xy,
            grid.slop_z)
    win = (wx, wy, wz)

    b0, covered = [], None
    for d in range(3):
        lo = torch.floor((gmin[d] - grid.cutneigh - slop[d]) / size[d])
        hi = torch.floor((gmax[d] + grid.cutneigh + slop[d]) / size[d])
        lo = lo.clamp(-4, dims[d]).to(torch.int64) + 2
        hi = hi.clamp(-4, dims[d]).to(torch.int64) + 2
        lo = lo.clamp(0, dims[d] - win[d])
        hi = hi.clamp(max=dims[d] - 1)
        ok = hi - lo < win[d]
        covered = ok if covered is None else covered & ok
        b0.append(lo)
    offs = torch.as_tensor(
        np.array(
            [((ox * dims[1]) + oy) * dims[2] + oz
             for ox in range(wx) for oy in range(wy) for oz in range(wz)],
            dtype=np.int64,
        ),
        device=dev,
    )
    base = (b0[0] * dims[1] + b0[1]) * dims[2] + b0[2]
    g = bb_cells[base[:, None] + offs[None, :]].reshape(ng, -1, 8)

    def gap(lo_i, hi_i, lo_j, hi_j):
        return torch.maximum(lo_i[:, None] - hi_j, lo_j - hi_i[:, None]).clamp(min=0.0)

    dx = gap(gmin[0], gmax[0], g[:, :, 0], g[:, :, 1])
    dy = gap(gmin[1], gmax[1], g[:, :, 2], g[:, :, 3])
    dz = gap(gmin[2], gmax[2], g[:, :, 4], g[:, :, 5])
    keep = (dx * dx + dy * dy + dz * dz) <= cutsq  # empty slots fail
    nj = keep.sum(1)
    overflow = torch.stack([(nj > list_capacity).any(), (~covered).any()])
    n16 = ibbox.shape[0] // 2
    sentinel_id = n16 - 1
    cand = g[:, :, 6].to(torch.int64)
    if need_ranges:
        jl, ranges = _windowed_lists(
            g, keep, nj, cand, bb_local, grid.cutneigh, list_capacity,
            sentinel_id,
        )
        return ClusterPairList(jlist=jl, nj=nj, overflow=overflow,
                               ranges=ranges)

    # packed sort key (quantised zmin, id); dropped entries sort last
    zq_off = -(grid.cutneigh + grid.slop_z + 1.0)
    zq_scale = 16383.0 / (grid.prd[2] + 2.0 * (grid.cutneigh + grid.slop_z + 1.0))
    zq = ((g[:, :, 4] - zq_off) * zq_scale).clamp(-1.0, 16384.0)
    zq = zq.to(torch.int64).clamp(0, 16383)
    dropped = 16384 * n16
    key = torch.where(keep, zq * n16 + cand, dropped + cand)
    ks = torch.sort(key, dim=1).values[:, :list_capacity]
    jl = torch.where(ks < dropped, ks % n16, sentinel_id)
    if jl.shape[1] < list_capacity:
        jl = torch.nn.functional.pad(
            jl, (0, list_capacity - jl.shape[1]), value=sentinel_id
        )
    return ClusterPairList(jlist=jl, nj=nj, overflow=overflow)


def _windowed_lists(g, keep, nj, cand, bb_local, cutneigh: float,
                    list_capacity: int, sentinel_id: int):
    """The need_ranges=True compaction of build_cluster_pairs: kept
    candidates sorted by (zmin, id), zmax carried along, and the members'
    tile windows from them. Returns (jlist int32, ranges)."""
    zmin = torch.where(keep, g[:, :, 4], SENTINEL_COORD)
    zmax = torch.where(keep, g[:, :, 5], SENTINEL_COORD)
    # two stable sorts: by id, then by zmin (ties keep id order)
    by_id = torch.argsort(cand, dim=1, stable=True)
    zs, o = torch.sort(torch.gather(zmin, 1, by_id), dim=1, stable=True)
    order = torch.gather(by_id, 1, o)[:, :list_capacity]
    zs = zs[:, :list_capacity]
    zx = torch.gather(zmax, 1, order)
    lpos = torch.arange(order.shape[1], device=g.device)
    jl = torch.where(lpos < nj[:, None], torch.gather(cand, 1, order),
                     sentinel_id)
    if jl.shape[1] < list_capacity:
        pad = list_capacity - jl.shape[1]
        jl = torch.nn.functional.pad(jl, (0, pad), value=sentinel_id)
        zs = torch.nn.functional.pad(zs, (0, pad), value=SENTINEL_COORD)
        zx = torch.nn.functional.pad(zx, (0, pad), value=SENTINEL_COORD)
    # zmax is not monotone in zmin order, its running max is: counting
    # the positions whose prefix max stays below the bound is exact
    rmax = torch.cummax(zx, dim=1).values
    return (jl.to(torch.int32).contiguous(),
            _tile_windows(rmax, zs, nj, bb_local, cutneigh))


def _tile_windows(rmax, rmin, nj, bb_local, cutneigh: float):
    """(NG, 2*group+1) int32 tile windows from a per-position running max
    of zmax (`rmax`, non-decreasing) and a lower bound of every later
    zmin (`rmin`, non-decreasing), both (NG, L), and the members' bboxes
    (NG, group, 8)."""
    L = rmax.shape[1]
    lo = bb_local[:, :, 4] - cutneigh  # (NG, group)
    hi = bb_local[:, :, 5] + cutneigh
    start = (rmax[:, None, :] < lo[:, :, None]).sum(2)
    end = (rmin[:, None, :] <= hi[:, :, None]).sum(2)
    end = torch.minimum(end, nj.clamp(max=L)[:, None])
    start = torch.minimum(start, end)
    start_t = start // TILE_J
    end_t = (end + TILE_J - 1) // TILE_J
    njg = end_t.amax(1, keepdim=True)
    return torch.cat([start_t, end_t, njg], dim=1).to(torch.int32)


def refresh_pair_ranges(
    clusters: Clusters,
    pairs: ClusterPairList,
    n_clusters_pad: int,
    group: int,
    cutneigh: float,
) -> ClusterPairList:
    """The prune pass (reference pruneNeighbor, neighbor.c:483-531):
    recompute the members' tile windows from CURRENT coordinates without
    re-binning or rebuilding the lists. The list keeps its order, which
    drifts from sorted; the bounds stay exact for any order through the
    prefix max of zmax (start) and the suffix min of zmin (end)."""
    ng = pairs.jlist.shape[0]
    bbox = compute_bboxes(clusters.xc, clusters.yc, clusters.zc)
    bb16 = make_j16_bboxes(bbox)
    zmin_j = bb16[pairs.jlist, 4]  # (NG, L)
    zmax_j = bb16[pairs.jlist, 5]
    rmax = torch.cummax(zmax_j, dim=1).values
    rmin = torch.cummin(zmin_j.flip(1), dim=1).values.flip(1)
    bb_local = bbox[:n_clusters_pad].reshape(ng, group, 8)
    return pairs._replace(
        ranges=_tile_windows(rmax, rmin, pairs.nj, bb_local, cutneigh)
    )


BF16_BIG = 3.0e4  # the bf16 derive's padding coordinates: -BIG i side, +BIG j side
BF16_U = 2.0 ** -8  # bfloat16's unit roundoff (8 significand bits)


def _centre_i(a3):
    """One axis of the bf16 derive's i side, a3 (ng, units, i-atoms) in the
    working dtype: the atoms centred on each unit's first atom in
    bfloat16 (padding at -BF16_BIG), the centre (ng, units, 1), and the
    unit's real extent from it (ng, units; 0 for a unit of padding)."""
    c = a3[:, :, 0:1]
    real = a3.abs() < SENTINEL_COORD * 0.5
    ac = torch.where(real, a3 - c, -BF16_BIG).to(torch.bfloat16)
    ext = torch.where(real, (a3 - c).abs(), 0.0).amax(2)
    return ac, c, ext


def bf16_cutoff(ext, cutneigh: float):
    """The bf16 derive's cutoff per unit from its per-axis real extents
    `ext` (three tensors): (cut_eff, err_r), err_r the 2-norm over the
    axes of the distance error bound (2 B + 2 cutneigh) * 2^-8 and
    cut_eff = (cutneigh + err_r)^2 * (1 + 2^-5) the inflated rsq."""
    ex, ey, ez = ((2.0 * b + 2.0 * cutneigh) * BF16_U for b in ext)
    err_r = torch.sqrt(ex * ex + ey * ey + ez * ez)
    r = cutneigh + err_r
    return r * r * (1.0 + 2.0 ** -5), err_r


def bf16_reach(ext, cutneigh: float):
    """The farthest true minimum distance (float64, per unit) at which the
    bf16 derive can keep an entry (tests and chip_smoke.py only): with
    u = 2^-8, B the 2-norm of the unit's extents and d the computed
    (bfloat16) distance vector, a kept entry has |d| <= sqrt(cut_eff) /
    (1 - u)^1.5 (three roundings in the square and sum chain), and the
    true distance D meets D <= |d| + 2 u (1 + u) (B + D) (per axis the two
    input roundings and the subtraction's, |xi_c| <= B_axis, |xj_c| <=
    B_axis + |dx|), so D <= (sqrt(cut_eff) / (1 - u)^1.5 + 2 u (1 + u) B)
    / (1 - 2 u (1 + u))."""
    u = BF16_U
    ext = [b.double() for b in ext]
    cut = bf16_cutoff(ext, cutneigh)[0]
    b = torch.sqrt(sum(e * e for e in ext))
    k = 2.0 * u * (1.0 + u)
    return (torch.sqrt(cut) / (1.0 - u) ** 1.5 + k * b) / (1.0 - k)


def bf16_extents(clusters: Clusters, n_clusters_pad: int, group: int, share: int):
    """Each unit's per-axis real extent from its first atom (the bf16
    derive's B), three (units,) tensors in the working dtype (tests and
    chip_smoke.py only)."""
    ng = n_clusters_pad // group
    return [_centre_i(p[:n_clusters_pad].reshape(ng, group // share, share * M))[2]
            .reshape(-1) for p in (clusters.xc, clusters.yc, clusters.zc)]


def derive_ilists(
    clusters: Clusters,
    pairs: ClusterPairList,
    n_clusters_pad: int,
    group: int,
    cutneigh: float,
    icap: int,
    share: int = 1,
    max_elems: int = 1 << 25,
    bf16: bool = False,
) -> ClusterPairList:
    """Exact per-i-unit j16 lists (the reference's atomDistanceInRange
    prune, src/clusterpair/neighbor.c:262-436, at (share*8-atom i-unit) x
    (16-atom j-cluster) granularity, against cutneigh so the list
    survives a reneighbor interval): a group-list entry is kept for a unit
    iff some atom of the unit and some atom of the j16 are within
    cutneigh. Kept entries keep the group list's order; the rest of each
    row holds the sentinel j16 id (its coordinates fail any cutoff).

    Groups are processed in chunks so the (units, i-atoms, j-atoms)
    distance block stays under `max_elems` elements; the lists do not
    depend on the chunk.

    bf16=True (mdbench_tpu's derive_bf16, operation for operation) runs
    the dominant distance math in bfloat16 after centring both sides on
    each unit's first atom: centring bounds the magnitudes to the unit's
    extent plus cutneigh, so a rounding error is ~0.01 instead of ~0.1 at
    raw box coordinates. Padding atoms (|a| >= SENTINEL_COORD / 2) are
    masked to -BF16_BIG on the i side and +BF16_BIG on the j side, since
    their per-slot displacement is invisible at bfloat16 precision. The
    cutoff is inflated by a worst-case bound of that error, so the lists
    are a SUPERSET of the exact ones: the force kernels apply the exact
    cutoff, and only a boundary shell of extra j16 entries survives.
    The bound, per unit: bfloat16 keeps 8 significand bits, so a
    round-to-nearest errs by at most |v| * 2^-8. A pair at the keep
    boundary has |xi_c| <= B (the unit's real extent from its centring
    atom, per axis), |xj_c| <= B + cutneigh and |dx| <= cutneigh; the two
    input roundings and the subtraction's give a per-axis distance error
    of at most err = (2 B + 2 cutneigh) * 2^-8, combined as the 2-norm
    err_r over the axes; the square and sum chain adds at most ~3
    roundings relative (2^-5 is taken, generously). So an entry is kept
    iff its bfloat16 minimum rsq <= cut_eff = (cutneigh + err_r)^2 *
    (1 + 2^-5) (bf16_cutoff), and no kept entry lies farther from its
    unit than bf16_reach (a unit of padding alone keeps nothing: its j
    distances overflow to inf). Each bfloat16 operation rounds on its own
    (no fused forms), as in mdbench_tpu, so the card's lists equal the
    CPU's bit for bit."""
    if group % share:
        raise ValueError("group must be a multiple of share")
    dev = clusters.xc.device
    gs_units = group // share
    ng, L = pairs.jlist.shape
    cjn = clusters.xc.shape[0] // 2
    sentinel16 = cjn - 1
    half = SENTINEL_COORD * 0.5
    ps = (clusters.xc, clusters.yc, clusters.zc)
    jplanes = [p.reshape(cjn, N_J) for p in ps]
    if bf16:
        # per unit, per axis: the bfloat16 centred i-atoms, the centre and
        # the real extent, and the inflated cutoff (ng, gs_units)
        iside = [_centre_i(p[:n_clusters_pad].reshape(ng, gs_units, share * M))
                 for p in ps]
        cut = bf16_cutoff([e for *_, e in iside], cutneigh)[0]
    else:
        # i-side sentinels flip sign: i-pad vs j-pad pairs land ~2e30
        # apart instead of aliasing to 0 when a ghost j16 carries an
        # exact copy of its owner's padding coordinates
        iplanes = []
        for p in ps:
            a = p[:n_clusters_pad].reshape(ng, gs_units, share * M, 1)
            iplanes.append(torch.where(a.abs() < half, a, -a))
    lpos = torch.arange(L, device=dev)
    chunk = max(1, max_elems // (group * M * L * N_J))
    ijls, njis = [], []
    for g0 in range(0, ng, chunk):
        g1 = min(g0 + chunk, ng)
        jl = pairs.jlist[g0:g1]  # (c, L)
        c = g1 - g0
        rsq = None
        if bf16:
            for (ai, ci, _), pj in zip(iside, jplanes):
                aj = pj[jl].reshape(c, 1, L * N_J)
                cj = ci[g0:g1]
                ajc = torch.where(aj.abs() < half, aj - cj, BF16_BIG).to(torch.bfloat16)
                d = ai[g0:g1, :, :, None] - ajc[:, :, None, :]
                rsq = d * d if rsq is None else rsq + d * d
        else:
            for pi, pj in zip(iplanes, jplanes):
                d = pi[g0:g1] - pj[jl].reshape(c, 1, 1, L * N_J)
                rsq = d * d if rsq is None else rsq + d * d
        mind = rsq.amin(2).reshape(c, gs_units, L, N_J).amin(3)
        if bf16:
            within = mind.to(clusters.xc.dtype) <= cut[g0:g1, :, None]
        else:
            within = mind <= cutneigh * cutneigh
        keep = within & (lpos[None, None, :] < pairs.nj[g0:g1, None, None])
        njis.append(keep.sum(2))
        # stable compaction: kept entries first, list order kept
        key, order = torch.sort(torch.where(keep, lpos, L + lpos), dim=2)
        sj = torch.gather(jl[:, None, :].expand(c, gs_units, L), 2, order)
        ijls.append(torch.where(key < L, sj, sentinel16))
    ijl = torch.cat(ijls).reshape(-1, L)
    nji = torch.cat(njis).reshape(-1).to(torch.int32)
    if L >= icap:
        ijl = ijl[:, :icap]
    else:
        ijl = torch.nn.functional.pad(ijl, (0, icap - L), value=sentinel16)
    return pairs._replace(
        ijlist=ijl.to(torch.int32).contiguous(), nji=nji, iovf=(nji > icap).any()
    )


def plan_capacity_buckets(nji: np.ndarray, cap: int, share: int,
                          margin: int = 4, zero_tier: bool = False):
    """Capacity buckets for the exact-list force from an observed list-
    length distribution, number for number mdbench_tpu's planner: every
    multiple of 8 below `cap` is a candidate cap (with `zero_tier`, also a
    cap-0 tier for the units whose lists are exactly empty); a tier keeps
    int(0.99 * #{nji + margin <= cap}) units rounded down to the size
    granule max(128 // share, 8) (a TPU tiling constant, kept so that the
    static sizes, and with them the overflow and grow sequence, are
    mdbench_tpu's), when that adds at least one granule; the rest go to a
    last tier at `cap`. Returns (sizes, caps), or None for boxes of fewer
    than 4096 units or when no tier forms."""
    nu = nji.shape[0]
    if nu < 4096:
        return None
    gran = max(128 // share, 8)
    srt = np.sort(nji) + margin
    cand = list(range(8, cap, 8))
    if zero_tier:
        cand = [0] + cand
    sizes, caps = [], []
    used = 0
    for c_k in cand:
        fit = (np.sort(nji) <= 0) if c_k == 0 else (srt <= c_k)
        n_fit = int(fit.sum() * 0.99) // gran * gran - used
        if n_fit >= gran:
            sizes.append(n_fit)
            caps.append(c_k)
            used += n_fit
    if not sizes:
        return None
    sizes.append(max(gran, (nu - used + gran - 1) // gran * gran))
    caps.append(cap)
    return tuple(sizes), tuple(caps)


def bucket_maps_core(ijlist, nji, n_clusters_pad: int, share: int,
                     total_rows: int, sizes, caps):
    """The bucket maps of one set of exact lists (mdbench_tpu's
    bucket_maps_core, the same arrays bit for bit). Units are ordered by
    list length with a STABLE argsort (ties keep unit order, as jnp.argsort
    does) and padded to sum(sizes) with dummy units, which read the
    sentinel j16 total_rows // 2 - 1 and the last `share` rows. Returns
    (bijlist (total, icap) int32: the lists in that order; bcrows
    (total*share,) int32: each position's cluster rows; binv
    (n_clusters_pad,) int32: each cluster row's position row; bovf: a
    bucket's longest list exceeds its cap)."""
    nu, icap = ijlist.shape
    dev = ijlist.device
    total = int(sum(sizes))
    if total < nu:
        raise ValueError(f"bucket sizes hold {total} units, fewer than {nu}")
    i32 = dict(dtype=torch.int32, device=dev)
    order = torch.argsort(nji, stable=True)
    if total > nu:
        order = torch.cat([order, torch.full((total - nu,), nu, dtype=order.dtype,
                                             device=dev)])
    sent16 = total_rows // 2 - 1
    ijl_ext = torch.cat([ijlist, torch.full((1, icap), sent16, **i32)])
    bijlist = ijl_ext[order].contiguous()
    crow0 = torch.where(order < nu, order * share, total_rows - share)
    bcrows = (crow0[:, None] + torch.arange(share, device=dev)[None, :]).reshape(-1)
    # slot nu takes one write per dummy unit; on CUDA such duplicate
    # scatters land in no set order, which is harmless because nothing
    # reads slot nu (c // share < nu below)
    inv_u = torch.zeros(nu + 1, dtype=torch.int64, device=dev)
    inv_u[order] = torch.arange(total, device=dev)
    c = torch.arange(n_clusters_pad, device=dev)
    binv = inv_u[c // share] * share + c % share
    # each bucket's longest list is its last unit's (dummies have none);
    # compared one scalar view at a time: a host list or host tensor
    # indexing a CUDA tensor is a copy that synchronises the stream
    nji_sorted = torch.cat([nji, torch.zeros(1, dtype=nji.dtype, device=dev)])[order]
    bovf = torch.zeros((), dtype=torch.bool, device=dev)
    off = 0
    for n_k, c_k in zip(sizes, caps):
        last = min(off + n_k, nu) - 1
        if last >= off:
            bovf = bovf | (nji_sorted[last] > c_k)
        off += n_k
    return (bijlist, bcrows.to(torch.int32).contiguous(),
            binv.to(torch.int32).contiguous(), bovf)


def attach_bucket_maps(pairs: ClusterPairList, n_clusters_pad: int, share: int,
                       total_rows: int, sizes, caps) -> ClusterPairList:
    """The pair list with its bucket maps (bucket_maps_core) and the
    buckets' overflow folded into iovf (the engine grows the caps and
    retries)."""
    bijlist, bcrows, binv, bovf = bucket_maps_core(
        pairs.ijlist, pairs.nji, n_clusters_pad, share, total_rows, sizes, caps)
    return pairs._replace(bijlist=bijlist, bcrows=bcrows, binv=binv,
                          iovf=pairs.iovf | bovf)
