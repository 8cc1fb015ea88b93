"""Carry state and EAM tables from mdbench_tpu into the port.

The system has no weights: its state is the cluster layout (cluster
scheme) or the atom rows (verlet scheme), the ghost map and the pair
lists, and its parameters are the EAM spline tables and pair
polynomials, and on typed runs the per-type-pair LJ tables. Each
function takes the arrays of one of
mdbench_tpu's NamedTuples — the NamedTuple itself (its arrays convert
with numpy.asarray), any object with the same attribute names, or a
mapping of names to numpy arrays — and returns the port's NamedTuple
on `device`, with floating arrays in `dtype`. This module imports
neither jax nor mdbench_tpu.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from mdbench_tpu_torch.engine import StepState
from mdbench_tpu_torch.engine_cluster import CStepState
from mdbench_tpu_torch.models.eam_tables import EamPoly
from mdbench_tpu_torch.ops.eam import EamDevice
from mdbench_tpu_torch.ops.cluster import ClusterHalo, ClusterPairList, Clusters
from mdbench_tpu_torch.state import Halo, NeighborList


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _get(src, name):
    return np.asarray(_field(src, name))


def _float(src, name, device, dtype):
    return torch.tensor(_get(src, name), dtype=dtype, device=device)


def _int(src, name, device, dtype=torch.int64):
    return torch.tensor(_get(src, name).astype(np.int64), dtype=dtype, device=device)


def _bool(src, name, device):
    return torch.tensor(_get(src, name).astype(bool), device=device)


def clusters_from_numpy(src, device, dtype, typed: bool = False) -> Clusters:
    """mdbench_tpu Clusters -> port Clusters. mdbench_tpu's clusters always
    hold a type plane (float-encoded, zeros on untyped runs); with `typed`
    it comes across as the port's int32 `tc`, else `tc` is None, as on the
    port's untyped runs."""
    return Clusters(
        xc=_float(src, "xc", device, dtype),
        yc=_float(src, "yc", device, dtype),
        zc=_float(src, "zc", device, dtype),
        bbox=_float(src, "bbox", device, dtype),
        atom_id=_int(src, "atom_id", device),
        inv_map=_int(src, "inv_map", device),
        tc=_int(src, "tc", device, torch.int32) if typed else None,
    )


def tables_from_numpy(tables, device, dtype) -> tuple:
    """mdbench_tpu's EXPLICIT_TYPES tables -> the port's: (eps, sig6,
    cutsq), each a (T, T) tensor on `device` in `dtype`. `tables` is the
    engine's `type_tables` (three arrays), its `_tables_static` (three
    nested tuples of floats) or `_tables_jnp`."""
    eps, sig6, cutsq = (torch.tensor(np.asarray(t, np.float64), dtype=dtype,
                                     device=device) for t in tables)
    return eps, sig6, cutsq


def halo_from_numpy(src, device, dtype) -> ClusterHalo:
    """mdbench_tpu ClusterHalo -> port ClusterHalo."""
    return ClusterHalo(
        border_map=_int(src, "border_map", device),
        shift_x=_float(src, "shift_x", device, dtype),
        shift_y=_float(src, "shift_y", device, dtype),
        shift_z=_float(src, "shift_z", device, dtype),
        nghost=_int(src, "nghost", device),
        overflow=_bool(src, "overflow", device),
    )


def pairs_from_numpy(src, device) -> ClusterPairList:
    """mdbench_tpu ClusterPairList -> port ClusterPairList, in either
    form. The group list and the tile windows lose their TPU block axis:
    jlist (NG, 1, L) -> (NG, L) int64, ranges (NG, 1, 2G+1) -> (NG, 2G+1)
    int32. The exact-list fields (ijlist, nji, iovf), the windows and the
    capacity-bucket maps (bijlist, bcrows, binv, int32) carry over where
    the source holds them and are None where it does not."""
    jl = _get(src, "jlist")
    ng = jl.shape[0]

    def opt(name, conv):
        present = _has(src, name) and _field(src, name) is not None
        return conv() if present else None

    return ClusterPairList(
        jlist=torch.tensor(jl.reshape(ng, -1).astype(np.int64), device=device),
        nj=_int(src, "nj", device),
        overflow=_bool(src, "overflow", device),
        ijlist=opt("ijlist", lambda: _int(src, "ijlist", device, torch.int32)),
        nji=opt("nji", lambda: _int(src, "nji", device, torch.int32)),
        iovf=opt("iovf", lambda: _bool(src, "iovf", device)),
        ranges=opt("ranges", lambda: torch.tensor(
            _get(src, "ranges").reshape(ng, -1).astype(np.int32),
            device=device)),
        **{name: opt(name, lambda name=name: _int(src, name, device, torch.int32))
           for name in ("bijlist", "bcrows", "binv")},
    )


def step_state_from_numpy(src, device, dtype, typed: bool = False) -> CStepState:
    """mdbench_tpu CStepState -> port CStepState (`typed` as for
    clusters_from_numpy)."""
    planes = [_float(src, n, device, dtype)
              for n in ("vxc", "vyc", "vzc", "fxc", "fyc", "fzc")]
    return CStepState(
        clusters_from_numpy(_field(src, "clusters"), device, dtype, typed),
        *planes,
        halo_from_numpy(_field(src, "halo"), device, dtype),
        pairs_from_numpy(_field(src, "pairs"), device),
        _bool(src, "overflow", device),
    )


def verlet_halo_from_numpy(src, device, dtype) -> Halo:
    """mdbench_tpu state.Halo (verlet scheme) -> port state.Halo."""
    return Halo(
        border_map=_int(src, "border_map", device),
        shift=_float(src, "shift", device, dtype),
        nghost=_int(src, "nghost", device),
        overflow=_bool(src, "overflow", device),
    )


def neighbor_list_from_numpy(src, device) -> NeighborList:
    """mdbench_tpu state.NeighborList -> port state.NeighborList: the
    per-atom lists as int64, the row lists and their bucket maps as int32
    and the observed maxima (ncmax) as int64 where the source holds them,
    None where it does not."""
    def opt(name, dtype):
        if not (_has(src, name) and _field(src, name) is not None):
            return None
        return _int(src, name, device, dtype)

    return NeighborList(
        neighbors=_int(src, "neighbors", device),
        numneigh=_int(src, "numneigh", device),
        overflow=_bool(src, "overflow", device),
        **{name: opt(name, torch.int32)
           for name in ("rows", "numrows", "brows", "bcrows", "binv")},
        ncmax=opt("ncmax", torch.int64),
    )


def verlet_step_state_from_numpy(src, device, dtype) -> StepState:
    """mdbench_tpu engine.StepState -> port engine.StepState."""
    return StepState(
        x=_float(src, "x", device, dtype),
        v=_float(src, "v", device, dtype),
        f=_float(src, "f", device, dtype),
        types=_int(src, "types", device, torch.int32),
        halo=verlet_halo_from_numpy(_field(src, "halo"), device, dtype),
        nlist=neighbor_list_from_numpy(_field(src, "nlist"), device),
        overflow=_bool(src, "overflow", device),
    )


def eam_from_numpy(tables, poly, device, dtype) -> tuple[EamDevice, EamPoly]:
    """mdbench_tpu EAM parameters -> (port EamDevice, port EamPoly).

    `tables` is an EamTables (spline arrays `*_spline`) or an EamDevice
    (`rhor`, `frho`, `z2r`), either with `rdr`, `rdrho`, `nr`, `nrho`;
    `poly` is an EamPoly. The splines land on `device` in `dtype`; the
    polynomial stays on the host in float64, as its coefficients are
    folded into the kernels as constants."""
    names = ("rhor", "frho", "z2r")
    if all(_has(tables, f"{n}_spline") for n in names):
        names = tuple(f"{n}_spline" for n in names)
    rhor, frho, z2r = (_float(tables, n, device, dtype) for n in names)
    dev = EamDevice(
        rhor=rhor, frho=frho, z2r=z2r,
        rdr=float(_field(tables, "rdr")), rdrho=float(_field(tables, "rdrho")),
        nr=int(_field(tables, "nr")), nrho=int(_field(tables, "nrho")),
    )
    host = EamPoly(**{
        f: (np.asarray(_field(poly, f), np.float64)
            if f in ("dens", "g1", "g2") else float(_field(poly, f)))
        for f in EamPoly._fields
    })
    return dev, host


def _has(src, name) -> bool:
    return name in src if isinstance(src, Mapping) else hasattr(src, name)
