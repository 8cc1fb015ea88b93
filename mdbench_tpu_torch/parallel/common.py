"""Helpers the domain engines share (the port of
``mdbench_tpu.parallel.common``, and the wrap and the atom migration along
one mesh axis that each of mdbench_tpu's domain engines carries): the
per-domain spatial resort with a device-side atom count, the row-list
layout rules, and the melted-probe capacity calibration. Every number
is mdbench_tpu's for every input; the resort breaks ties by row id
(below)."""

from __future__ import annotations

import numpy as np
import torch

from mdbench_tpu_torch.ops.cluster import plan_capacity_buckets
from mdbench_tpu_torch.state import SENTINEL_COORD

BIG = 2**31 - 1  # the padding rows' bin key (they sort last)


def live_rows(nloc, n: int):
    """(n,) bool: rows below the 0-d atom count `nloc`."""
    return torch.arange(n, device=nloc.device) < nloc


def wrap_dims(x, nloc, dims):
    """Wrap the live rows into the box along each (dim, prd) of `dims`, in
    place: the dimensions no mesh axis cuts (a slab's y and z); the cut
    ones are left to the migration. Returns x."""
    live = live_rows(nloc, x.shape[0])
    for d, prd in dims:
        c = x[:, d]
        c = torch.where(live & (c < 0), c + prd, c)
        c = torch.where(live & (c >= prd), c - prd, c)
        x[:, d] = c
    return x


def _pack_leavers(x, v, nloc, acap: int, migcap: int, width: float, dim: int):
    """The migration's first half on one domain along box dimension `dim`
    (the multi-device updateAtomsPbc, pbc.c:59-84; mdbench_tpu's
    _migrate_axis, verlet_domain2d.py:206-268): the leavers packed into two
    (migcap, 6) [x | v] buffers in the receiver's frame, the stayers
    compacted to the front. Returns (buf_l, buf_r, x2, v2, n_stay,
    overflow), x2 and v2 one row longer than acap (the dropped scatters'
    row); the overflow flag also marks an atom that drifted more than one
    domain `width` (verlet_domain3d.py:192-194)."""
    dtype, dev = x.dtype, x.device
    live = live_rows(nloc, acap)
    xl = x[:acap]
    go_l = live & (xl[:, dim] < 0.0)
    go_r = live & (xl[:, dim] >= width)
    ovf_drift = torch.any(live & ((xl[:, dim] < -width) | (xl[:, dim] >= 2 * width)))
    stay = live & ~go_l & ~go_r

    def pack(mask, shift):
        pos = torch.cumsum(mask, 0) - 1
        cnt = mask.sum()
        pos = torch.where(mask & (pos < migcap), pos, migcap)
        payload = torch.cat([xl, v[:acap]], dim=1)
        payload[:, dim] += shift
        buf = torch.full((migcap + 1, 6), SENTINEL_COORD, dtype=dtype, device=dev)
        buf[pos] = payload
        return buf[:migcap], cnt

    # leavers to the left arrive at the left neighbour's right edge
    buf_l, cnt_l = pack(go_l, +width)
    buf_r, cnt_r = pack(go_r, -width)
    ovf = (cnt_l > migcap) | (cnt_r > migcap) | ovf_drift
    pos = torch.where(stay, torch.cumsum(stay, 0) - 1, acap)
    x2 = torch.full((acap + 1, 3), SENTINEL_COORD, dtype=dtype, device=dev)
    v2 = torch.zeros((acap + 1, 3), dtype=dtype, device=dev)
    x2[pos] = xl
    v2[pos] = v[:acap]
    return buf_l, buf_r, x2, v2, stay.sum(), ovf


def _append(x2, v2, n, buf, acap: int):
    """Append a received buffer's valid rows after the first n rows."""
    valid = buf[:, 0].abs() < SENTINEL_COORD * 0.5
    pos = torch.cumsum(valid, 0) - 1 + n
    pos = torch.where(valid & (pos < acap), pos, acap)
    x2[pos] = buf[:, 0:3]
    v2[pos] = buf[:, 3:6]
    return n + valid.sum()


def migrate(exchange, xs, vs, ns, acap: int, migcap: int, width: float, dim: int = 0):
    """Move the atoms that crossed a domain face along box dimension `dim`
    to the neighbouring domain along mesh axis `dim` (mdbench_tpu's
    _migrate: pack, shift left and right, merge; one staged hop of the
    pencil and brick engines), for every domain `exchange` holds; `width`
    is the domain's extent along `dim`. Returns lists (xs, vs, ns,
    overflow flags): each domain's (acap, 3) atoms (sentinel padded) and
    velocities, its 0-d atom count and its migration flag (a buffer or the
    local region overflowed, or an atom drifted more than a domain)."""
    packs = [_pack_leavers(x, v, n, acap, migcap, width, dim)
             for x, v, n in zip(xs, vs, ns)]
    from_right = exchange.shift([pk[0] for pk in packs], -1, dim)
    from_left = exchange.shift([pk[1] for pk in packs], +1, dim)
    out_x, out_v, out_n, ovfs = [], [], [], []
    for (_, _, x2, v2, n, ovf), bl, br in zip(packs, from_left, from_right):
        n = _append(x2, v2, n, bl, acap)
        n = _append(x2, v2, n, br, acap)
        out_x.append(x2[:acap])
        out_v.append(v2[:acap])
        out_n.append(n)
        ovfs.append(ovf | (n > acap))
    return out_x, out_v, out_n, ovfs


def resort_by_cell(grid, x, v, nloc, acap: int):
    """Spatial resort of a domain's locals by cell id (sortAtom per
    domain): migration appends arrivals at the END of the local region,
    so without a resort the 16-atom row-list units decay into spatially
    arbitrary groups and their candidate sets blow up. `nloc` is a 0-d
    tensor (never read on the host). One sort on the unique key (bin, row):
    ties within a bin keep row order, where mdbench_tpu's one-key unstable
    sort leaves them unordered; padding sorts last. Writes x's local rows
    in place; returns (x, the permuted v)."""
    xl = x[:acap]
    live = torch.arange(acap, device=x.device) < nloc
    cols = []
    for d in range(3):
        # truncation toward zero, as mdbench_tpu's astype(int32); padding
        # rows (at ~1e30) are binned at 0 and keyed BIG below
        c = torch.where(live, xl[:, d], 0.0)
        b = (c / grid.binsize[d]).to(torch.int64) + 1
        cols.append(b.clamp(0, grid.dims[d] - 1))
    flat = (cols[0] * grid.dims[1] + cols[1]) * grid.dims[2] + cols[2]
    key = torch.where(live, flat, BIG) * acap + torch.arange(acap, device=x.device)
    perm = torch.sort(key).indices
    x[:acap] = xl[perm]
    return x, v[perm]


def align_acap(rowlist: bool, on_card: bool, acap: int) -> int:
    """The row-list local region's alignment: 1024 atoms on the card (the
    single-device engine's nlocal_pad; mdbench_tpu's Pallas output
    blocks), 16 (whole rows) elsewhere, as mdbench_tpu's XLA backend."""
    if not rowlist:
        return acap
    align = 1024 if on_card else 16
    return (acap + align - 1) // align * align


def round16(cap: int) -> int:
    """Ghost blocks round up to whole 16-atom rows on the row-list path so
    that block boundaries never split a row."""
    return (cap + 15) // 16 * 16


def apply_rowlist_caps(eng, nr, st, want_buckets: bool = False):
    """Set an engine's row-build capacities from OBSERVED melted
    per-domain maxima (mdbench_tpu's margins, shared by the domain
    engines).

    nr: (ndev, units) observed numrows per 16-atom unit row;
    st: (ndev, 4) build stats of derive_rowlists_from_cells —
        [max candidates, max unit columns, max z-span, max rows/cell].

    Sets eng.rcap / ccap / ucl / zw / ubr in place. With want_buckets
    (the card's bucketed kernel K1b) it also plans static capacity buckets
    from the rank-wise maximum across domains of each domain's sorted
    numrows, a distribution that dominates every domain, so one plan
    holds for all of them. Returns the plan (or None)."""
    nr = np.asarray(nr)
    st = np.asarray(st)
    eng.rcap = max((int(nr.max() * 1.3) + 7) // 8 * 8, 16)
    eng.ccap = max((int(st[:, 0].max() * 1.3) + 7) // 8 * 8, 24)
    eng.ucl = max(int(st[:, 1].max()) + 1, 2)
    eng.zw = max(int(st[:, 2].max()) + 3, 3)
    eng.ubr = max(int(st[:, 3].max()) + 2, 4)
    if not want_buckets:
        return None
    nr_sorted = np.sort(nr, axis=1)
    return plan_capacity_buckets(
        nr_sorted.max(axis=0), eng.rcap, 2, margin=4, zero_tier=True
    )


def calibrated_block_cap(observed_max: int, floor: int) -> int:
    """Ghost/export block capacity from an observed melted maximum: 1.25x
    margin, whole 16-atom rows (the ghost refresh and the border exchange
    move the FULL padded block every step; the overflow grow-retry
    backstops a larger drift)."""
    return max((int(observed_max * 1.25) + 15) // 16 * 16, floor)
