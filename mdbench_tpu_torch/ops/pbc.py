"""Ghost atoms of the verlet scheme in torch ops (the port of
``mdbench_tpu.ops.pbc``; reference src/verletlist/pbc.c:42-227 setupPbc
and updatePbc).

`setup_pbc` keeps mdbench_tpu's ghost order exactly, since the order of
ghost rows decides the order of the force sums: (atom, canonical shift
index) ascending, or with `sort_grid` by the ghost's cell first (the
rowlist path's spatially compact ghost rows). Boxes wider than twice
cutneigh take the two-stage form (the atoms near a periodic face, then
their <= 7 images); narrower ones the flat 26-candidate form. Both sort
on one int64 key (rank << 31 | tie), the lexicographic sort of
mdbench_tpu's two keys. The per-step refresh (`update_pbc`) is one
gather and add, in place. Nothing synchronises with the host.
"""

from __future__ import annotations

import numpy as np
import torch

from mdbench_tpu_torch.ops.cells import CellGrid, coord_to_bin, np_dtype
from mdbench_tpu_torch.state import Halo

BIG = 2**31 - 1


def shift_ints(device) -> torch.Tensor:
    """(26, 3) int64 PBC shifts in the canonical order: (sx, sy, sz) over
    (-1, 0, 1)^3 without (0, 0, 0), sz fastest (made on `device` by
    arithmetic, so no host copy)."""
    idx = torch.arange(26, device=device)
    flat = idx + (idx >= 13).to(idx.dtype)
    return torch.stack([flat // 9 - 1, flat // 3 % 3 - 1, flat % 3 - 1], dim=1)


def shift_table(prd, dtype, device) -> torch.Tensor:
    """The (26, 3) shifts times the box lengths in `dtype`."""
    s = shift_ints(device)
    prd_d = np.asarray(prd, np_dtype(dtype))
    return torch.stack([s[:, d].to(dtype) * float(prd_d[d]) for d in range(3)], dim=1)


def _faces(xl, prd, cutneigh: float, pbc=None):
    """(lo, hi): (n, 3) bools, x_d < cutneigh and x_d >= prd_d - cutneigh
    (the bound in x's precision, as mdbench_tpu forms it); with `pbc`,
    False on the dimensions without PBC."""
    thr = np.asarray(prd, np_dtype(xl.dtype)) - np_dtype(xl.dtype)(cutneigh)
    lo, hi = [], []
    for d in range(3):
        on = pbc is None or bool(pbc[d])
        lo.append((xl[:, d] < cutneigh) & on)
        hi.append((xl[:, d] >= float(thr[d])) & on)
    return torch.stack(lo, dim=1), torch.stack(hi, dim=1)


def _compact(rank, tie, ghost_capacity: int, nlocal: int, sentinel_row: int,
             shifts: torch.Tensor, dtype) -> tuple:
    """Sort candidates by (rank, tie), keep the first ghost_capacity, and
    decode tie = atom * 26 + shift index into (border_map, shift); slots
    of invalid candidates (rank BIG) get the sentinel row and shift 0."""
    if rank.shape[0] < ghost_capacity:  # pool smaller than the halo
        pad = ghost_capacity - rank.shape[0]
        rank = torch.cat([rank, rank.new_full((pad,), BIG)])
        tie = torch.cat([tie, tie.new_full((pad,), BIG)])
    key, _ = torch.sort((rank.to(torch.int64) << 31) | tie.to(torch.int64))
    key = key[:ghost_capacity]
    live = (key >> 31) < BIG
    slot_tie = (key & BIG).clamp(max=nlocal * 26 - 1)
    border_map = torch.where(live, slot_tie // 26, sentinel_row)
    shift = torch.where(live[:, None], shifts[slot_tie % 26],
                        torch.zeros((), dtype=dtype, device=shifts.device))
    return border_map, shift


def setup_pbc(x: torch.Tensor, nlocal: int, nlocal_pad: int, ghost_capacity: int,
              prd, pbc, cutneigh: float, sort_grid: CellGrid = None) -> Halo:
    """The halo map (reference setupPbc semantics, pbc.c:90-227): shift s
    is valid for atom i iff per dimension s_d = +1 needs x_d < cutneigh,
    s_d = -1 needs x_d >= prd_d - cutneigh, and s_d != 0 needs PBC. Ghosts
    in mdbench_tpu's order (module docstring). `nlocal_pad` is unused, as
    in mdbench_tpu."""
    del nlocal_pad
    dtype, dev = x.dtype, x.device
    xl = x[:nlocal]
    shifts = shift_table(prd, dtype, dev)
    sentinel_row = x.shape[0] - 1
    small_box = any(pbc[d] and 2.0 * float(cutneigh) >= float(prd[d]) for d in range(3))
    if small_box:
        return _setup_pbc_flat26(x, nlocal, ghost_capacity, prd, pbc, cutneigh,
                                 sort_grid, shifts)

    lo, hi = _faces(xl, prd, cutneigh, pbc)
    bdim = lo | hi  # boundary dimensions
    bmask = bdim.any(dim=1)
    # exact ghost count: the non-empty subsets of each atom's boundary dims
    nvalid = (1 + bdim.to(torch.int64)).prod(dim=1) - 1
    nghost = nvalid.sum()
    nboundary = bmask.sum()
    bcap = min(int(ghost_capacity), int(nlocal))
    overflow = (nghost > ghost_capacity) | (nboundary > bcap)

    idx = torch.arange(nlocal, device=dev)
    batom = torch.sort(torch.where(bmask, idx, BIG)).values[:bcap]
    blive = batom < BIG
    ba = batom.clamp(max=nlocal - 1)
    xb = xl[ba]
    lob, hib = _faces(xb, prd, cutneigh, pbc)
    vdim = lob | hib
    sign = torch.where(lob, 1, -1)  # the +prd image iff near the low face

    subsets = [p for p in range(1, 8)
               if all(pbc[d] for d in range(3) if p & (4 >> d))]
    if not subsets:  # no periodic dimension: no ghosts at all
        return Halo(
            border_map=torch.full((ghost_capacity,), sentinel_row, dtype=torch.int64,
                                  device=dev),
            shift=torch.zeros((ghost_capacity, 3), dtype=dtype, device=dev),
            nghost=torch.zeros((), dtype=torch.int64, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
        )
    prd_d = np.asarray(prd, np_dtype(dtype))
    ranks, ties = [], []
    for p in subsets:
        in_p = [bool(p & (4 >> d)) for d in range(3)]
        ok = blive.clone()
        for d in range(3):
            if in_p[d]:
                ok &= vdim[:, d]
        s = torch.stack([sign[:, d] if in_p[d] else torch.zeros_like(sign[:, d])
                         for d in range(3)], dim=1)
        flat = (s[:, 0] + 1) * 9 + (s[:, 1] + 1) * 3 + (s[:, 2] + 1)
        tie = ba * 26 + flat - (flat > 13).to(flat.dtype)  # canonical index
        if sort_grid is not None:
            gx = torch.stack([xb[:, d] + s[:, d].to(dtype) * float(prd_d[d])
                              for d in range(3)], dim=1)
            rank = coord_to_bin(sort_grid, gx)
        else:
            rank = tie
        ranks.append(torch.where(ok, rank, BIG))
        ties.append(torch.where(ok, tie, BIG))
    border_map, shift = _compact(torch.stack(ranks, 1).reshape(-1),
                                 torch.stack(ties, 1).reshape(-1), ghost_capacity,
                                 nlocal, sentinel_row, shifts, dtype)
    return Halo(border_map=border_map, shift=shift, nghost=nghost, overflow=overflow)


def _setup_pbc_flat26(x, nlocal, ghost_capacity, prd, pbc, cutneigh, sort_grid,
                      shifts):
    """The flat (nlocal, 26)-candidate halo: the small-box form, where
    2 * cutneigh >= prd lets both images of a dimension be valid."""
    dtype, dev = x.dtype, x.device
    xl = x[:nlocal]
    lo, hi = _faces(xl, prd, cutneigh)
    sh = shift_ints(dev)
    pos_ok = torch.where(sh[None] == 1, lo[:, None, :], True)
    neg_ok = torch.where(sh[None] == -1, hi[:, None, :], True)
    pbc_ok = torch.ones(26, dtype=torch.bool, device=dev)
    for d in range(3):
        if not pbc[d]:
            pbc_ok &= sh[:, d] == 0
    valid = (pos_ok & neg_ok).all(dim=2) & pbc_ok[None, :]  # (nlocal, 26)
    flat_valid = valid.reshape(-1)
    nghost = flat_valid.sum()
    overflow = nghost > ghost_capacity
    idx = torch.arange(nlocal * 26, device=dev)
    if sort_grid is not None:
        gx = (xl[:, None, :] + shifts[None, :, :]).reshape(-1, 3)
        rank = coord_to_bin(sort_grid, gx)
    else:
        rank = idx
    border_map, shift = _compact(torch.where(flat_valid, rank, BIG), idx,
                                 ghost_capacity, nlocal, x.shape[0] - 1, shifts, dtype)
    return Halo(border_map=border_map, shift=shift, nghost=nghost, overflow=overflow)


def update_pbc(x: torch.Tensor, halo: Halo, nlocal_pad: int) -> torch.Tensor:
    """Refresh the ghost rows from their owners (reference updatePbc,
    pbc.c:42-55), in place: one gather and add. Padding slots point at the
    sentinel row with shift 0 and stay inert. Returns x."""
    gcap = halo.border_map.shape[0]
    x[nlocal_pad : nlocal_pad + gcap] = x[halo.border_map] + halo.shift
    return x


def ghost_types(types: torch.Tensor, halo: Halo, nlocal_pad: int) -> torch.Tensor:
    """Atom types copied to the ghost slots (reference ADDGHOST type copy,
    pbc.c:90-97). Returns a new tensor."""
    gcap = halo.border_map.shape[0]
    out = types.clone()
    out[nlocal_pad : nlocal_pad + gcap] = types[halo.border_map]
    return out
