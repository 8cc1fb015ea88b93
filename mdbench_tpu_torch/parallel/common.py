"""Helpers the domain engines share (the port of
``mdbench_tpu.parallel.common``): the per-domain spatial resort with a
device-side atom count, the row-list layout rules, and the melted-probe
capacity calibration. Every number is mdbench_tpu's for every input; the
resort breaks ties by row id (below)."""

from __future__ import annotations

import numpy as np
import torch

from mdbench_tpu_torch.ops.cluster import plan_capacity_buckets

BIG = 2**31 - 1  # the padding rows' bin key (they sort last)


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
