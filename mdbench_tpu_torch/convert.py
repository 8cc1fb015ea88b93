"""Carry cluster state and EAM tables from mdbench_tpu into the port.

The system has no weights: its state is the cluster layout, the ghost
map and the pair lists, and its parameters are the EAM spline tables and
pair polynomials. Each function takes the arrays of one of
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

from mdbench_tpu_torch.engine_cluster import CStepState
from mdbench_tpu_torch.models.eam_tables import EamPoly
from mdbench_tpu_torch.ops.eam import EamDevice
from mdbench_tpu_torch.ops.cluster import ClusterHalo, ClusterPairList, Clusters


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


def clusters_from_numpy(src, device, dtype) -> Clusters:
    """mdbench_tpu Clusters -> port Clusters (the type plane is dropped:
    the port runs untyped)."""
    return Clusters(
        xc=_float(src, "xc", device, dtype),
        yc=_float(src, "yc", device, dtype),
        zc=_float(src, "zc", device, dtype),
        bbox=_float(src, "bbox", device, dtype),
        atom_id=_int(src, "atom_id", device),
        inv_map=_int(src, "inv_map", device),
    )


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
    int32. The exact-list fields (ijlist, nji, iovf) and the windows carry
    over where the source holds them and are None where it does not; the
    bucket maps have no counterpart (ROADMAP 1a)."""
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
    )


def step_state_from_numpy(src, device, dtype) -> CStepState:
    """mdbench_tpu CStepState -> port CStepState."""
    planes = [_float(src, n, device, dtype)
              for n in ("vxc", "vyc", "vzc", "fxc", "fyc", "fzc")]
    return CStepState(
        clusters_from_numpy(_field(src, "clusters"), device, dtype),
        *planes,
        halo_from_numpy(_field(src, "halo"), device, dtype),
        pairs_from_numpy(_field(src, "pairs"), device),
        _bool(src, "overflow", device),
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
