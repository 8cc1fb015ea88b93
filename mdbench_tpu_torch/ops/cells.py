"""Cell binning of the verlet scheme in torch ops (the port of
``mdbench_tpu.ops.cells``; reference src/verletlist/neighbor.c:64-184
setupNeighbor, :298-358 coord2bin/binatoms, :360-426 sortAtom).

Bins have an edge of at least cutneigh, so a fixed 3x3x3 stencil covers
every neighbour, with one margin ring of bins for ghosts. The cell table
is (nbins + 1, capacity) atom rows from one stable sort by bin id; a bin
that overflows its capacity raises a flag (the engine grows and retries).
Every function keeps mdbench_tpu's contract and its order of atoms; all
work stays on the input's device without a host synchronisation.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mdbench_tpu_torch.state import SENTINEL_COORD


def np_dtype(dtype) -> type:
    """The numpy float type of a torch float dtype (host values rounded to
    a tensor's precision, as mdbench_tpu forms them as arrays of x's
    dtype)."""
    return np.float32 if dtype == torch.float32 else np.float64


class CellGrid(NamedTuple):
    """Static bin geometry (host values, computed once per run)."""

    nbins_interior: tuple  # (nbx, nby, nbz) bins covering the box
    dims: tuple  # grid dims with one margin ring: (nbx+2, nby+2, nbz+2)
    binsize: tuple  # (bsx, bsy, bsz), each >= cutneigh
    capacity: int  # atoms per bin
    prd: tuple

    @property
    def nbins(self) -> int:
        d = self.dims
        return d[0] * d[1] * d[2]


def make_cell_grid(prd, cutneigh: float, rho: float, capacity: int = 0) -> CellGrid:
    """Bins no smaller than cutneigh and one margin ring; the default
    capacity is the expected atoms per bin x 1.35, rounded up to 8."""
    nb = [max(1, int(math.floor(p / cutneigh))) for p in prd]
    bs = [p / n for p, n in zip(prd, nb)]
    if capacity <= 0:
        mean = rho * bs[0] * bs[1] * bs[2]
        capacity = int(math.ceil(mean * 1.35 / 8.0)) * 8
    return CellGrid(nbins_interior=tuple(nb), dims=tuple(n + 2 for n in nb),
                    binsize=tuple(bs), capacity=capacity, prd=tuple(prd))


def stencil_offsets(grid: CellGrid, device) -> torch.Tensor:
    """Flat offsets of the 27-bin stencil, (dx, dy, dz) in (-1, 0, 1) with
    dz fastest (mdbench_tpu's CellGrid.stencil), as an int64 tensor made on
    `device` (arithmetic on an arange, so no host copy)."""
    _, ny, nz = grid.dims
    a = torch.arange(27, device=device)
    return ((a // 9 - 1) * ny + (a // 3 % 3 - 1)) * nz + (a % 3 - 1)


def stencil_bins(grid: CellGrid, ib: torch.Tensor) -> torch.Tensor:
    """(n, 27) flat bins of the stencil around the flat bins `ib` (n,), in
    stencil_offsets' order; a stencil bin outside the grid (around an atom
    in the margin ring: a local that has left the box since its last wrap)
    is the trap bin `grid.nbins`, whose slots hold only the sentinel row."""
    _, ny, nz = grid.dims
    a = torch.arange(27, device=ib.device)
    b = [ib[:, None] // (ny * nz) + (a // 9 - 1), ib[:, None] // nz % ny
         + (a // 3 % 3 - 1), ib[:, None] % nz + (a % 3 - 1)]
    inside = torch.ones_like(b[0], dtype=torch.bool)
    for c, n in zip(b, grid.dims):
        inside &= (c >= 0) & (c < n)
    flat = ib[:, None] + stencil_offsets(grid, ib.device)[None, :]
    return torch.where(inside, flat, grid.nbins)


def column_offsets(grid: CellGrid, device) -> torch.Tensor:
    """The 9 flat xy-column offsets (dx, dy) in (-1, 0, 1), dy fastest."""
    a = torch.arange(9, device=device)
    return (a // 3 - 1) * grid.dims[1] + (a % 3 - 1)


def bin_coords(grid: CellGrid, x: torch.Tensor) -> torch.Tensor:
    """(nrows, 3) int64 bin coordinates floor(x / binsize) + 1, clipped
    into the grid (mdbench_tpu's floor, +1 margin shift and clip; the clip
    is taken in floating point so sentinel rows convert safely)."""
    cols = []
    for d in range(3):
        b = torch.floor(x[:, d] / grid.binsize[d]) + 1
        cols.append(b.clamp(0, grid.dims[d] - 1).to(torch.int64))
    return torch.stack(cols, dim=1)


def flat_bin(grid: CellGrid, b: torch.Tensor) -> torch.Tensor:
    """Flat bin id of (.., 3) bin coordinates, z fastest."""
    return (b[..., 0] * grid.dims[1] + b[..., 1]) * grid.dims[2] + b[..., 2]


def coord_to_bin(grid: CellGrid, x: torch.Tensor) -> torch.Tensor:
    """Flat bin id per atom row (reference coord2bin, neighbor.c:298-327);
    sentinel rows go to the trap bin `grid.nbins`, which no stencil reads."""
    flat = flat_bin(grid, bin_coords(grid, x))
    invalid = x[:, 0].abs() >= SENTINEL_COORD * 0.5
    return torch.where(invalid, grid.nbins, flat)


class CellList(NamedTuple):
    cells: torch.Tensor  # (nbins + 1, capacity) int64 atom row ids
    bin_of: torch.Tensor  # (nrows,) int64 flat bin id per atom row
    overflow: torch.Tensor  # () bool


def build_cells(grid: CellGrid, x: torch.Tensor) -> CellList:
    """Bin every row of x (locals, ghosts, padding) into the cell table:
    a stable sort by bin id, per-bin starts by searchsorted, and one
    gather of the sorted order per (bin, slot). Within a bin, atoms keep
    row order (the reference's sequential binatoms fill order); empty
    slots and the trap bin hold the sentinel row (the last row)."""
    nrows = x.shape[0]
    dev = x.device
    ids = coord_to_bin(grid, x)
    sorted_ids, order = torch.sort(ids, stable=True)
    starts = torch.searchsorted(sorted_ids, torch.arange(grid.nbins + 2, device=dev))
    counts = starts[1:] - starts[:-1]  # (nbins + 1,)
    overflow = (counts[: grid.nbins] > grid.capacity).any()
    slot = torch.arange(grid.capacity, device=dev)
    pos = starts[:-1, None] + slot[None, :]
    live = (slot[None, :] < counts[:, None]) & (
        torch.arange(grid.nbins + 1, device=dev)[:, None] < grid.nbins)
    cells = torch.where(live, order[pos.clamp(max=nrows - 1)], nrows - 1)
    return CellList(cells=cells, bin_of=ids, overflow=overflow)


def sort_atoms_device(grid: CellGrid, x, v, types, nlocal: int):
    """Spatial resort of the local atoms by bin id (reference sortAtom,
    neighbor.c:360-426): one stable argsort of the truncated bin
    coordinates, then row gathers. Ghost rows and padding are untouched
    (the caller rebuilds them). Returns new (x, v, types)."""
    xl = x[:nlocal]
    cols = []
    for d in range(3):
        b = (xl[:, d] / grid.binsize[d]).to(torch.int64) + 1
        cols.append(b.clamp(0, grid.dims[d] - 1))
    perm = torch.argsort(flat_bin(grid, torch.stack(cols, dim=1)), stable=True)
    x, v, types = x.clone(), v.clone(), types.clone()
    x[:nlocal] = xl[perm]
    v[:nlocal] = v[:nlocal][perm]
    types[:nlocal] = types[:nlocal][perm]
    return x, v, types


def sort_atoms_host(grid: CellGrid, x: np.ndarray) -> np.ndarray:
    """Spatial sort permutation by bin id (reference sortAtom), host-side
    at set-up."""
    bs = np.asarray(grid.binsize)
    b = np.floor(x / bs).astype(np.int64) + 1
    b = np.clip(b, 0, np.asarray(grid.dims) - 1)
    flat = (b[:, 0] * grid.dims[1] + b[:, 1]) * grid.dims[2] + b[:, 2]
    return np.argsort(flat, kind="stable")
