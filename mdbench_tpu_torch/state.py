"""Sentinel constants and the verlet scheme's state (the port's copy of
``mdbench_tpu.state``: its constants, and its `TypeTables`, `Halo` and
`NeighborList` as NamedTuples of torch tensors; the cluster scheme's pytrees are the
NamedTuples of ``ops/cluster.py`` and ``engine_cluster.py``).

Padding atoms sit at ~SENTINEL_COORD, so every distance from them fails
any cutoff test. In float32, SENTINEL_COORD**2 overflows to inf: every
comparison against it must select, never multiply by a 0/1 mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

SENTINEL_COORD = 1.0e30


class TypeTables(NamedTuple):
    """Per-type-pair interaction tables of a typed run (reference
    atom.c:78-89), each (ntypes, ntypes) on the device."""

    types: torch.Tensor  # (nrows,) int32
    epsilon: torch.Tensor
    sigma6: torch.Tensor
    cutforcesq: torch.Tensor
    cutneighsq: torch.Tensor


class Halo(NamedTuple):
    """Ghost atoms of the verlet scheme (reference pbc.c setupPbc and
    updatePbc): ghost g is local atom border_map[g] moved by shift[g] (the
    PBC shift times the box lengths). Slots past the ghost count point at
    the sentinel row with a zero shift."""

    border_map: torch.Tensor  # (ghost_cap,) int64
    shift: torch.Tensor  # (ghost_cap, 3) float
    nghost: torch.Tensor  # () int64
    overflow: torch.Tensor  # () bool: ghost capacity exceeded


class NeighborList(NamedTuple):
    """Padded per-atom verlet lists (reference neighbor.h:55-65,
    neighbor.c:186-264), or the row lists of the rowlist path.

    neighbors[i, k] indexes the coordinate rows (locals, ghosts, padding);
    padding entries hold the sentinel row (the last row of x). On the
    rowlist path neighbors and numneigh are (1, 8) / (8,) placeholders and
    `rows` holds, per 16-atom unit, the ids of the 16-atom rows of x it
    interacts with (padding: the last, all-sentinel row id); `brows`,
    `bcrows` and `binv` are the capacity-bucket maps of those lists
    (ops/cluster.bucket_maps_core) when the engine has a plan, and `ncmax`
    the rebuild's observed maxima that drive the cap calibration."""

    neighbors: torch.Tensor  # (nlocal_pad, maxneighs) int64
    numneigh: torch.Tensor  # (nlocal_pad,) int64
    overflow: torch.Tensor  # () bool: maxneighs exceeded
    rows: Optional[torch.Tensor] = None  # (nlocal_pad/16, rcap) int32
    numrows: Optional[torch.Tensor] = None  # (nlocal_pad/16,) int32
    brows: Optional[torch.Tensor] = None  # (total_units, rcap) int32
    bcrows: Optional[torch.Tensor] = None  # (total_units*2,) int32
    binv: Optional[torch.Tensor] = None  # (nlocal_pad/8,) int32
    ncmax: Optional[torch.Tensor] = None  # (4,) int64 observed maxima
