"""EAM spline tables on a torch device and the per-atom lookups the
cluster-scheme EAM force needs (the port of the parts of
``mdbench_tpu.ops.eam`` that ``ops/eam_cluster.py`` uses; reference
src/verletlist/force_eam.c:20-231). The verlet-scheme EAM forces
(`compute_force_eam`, `compute_force_eam_poly`) come with the verlet
slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EamDevice(NamedTuple):
    """Spline tables on a torch device: (n+1, 7) rows, row 0 unused
    (1-indexed like the reference), as in mdbench_tpu."""

    rhor: torch.Tensor  # (nr+1, 7)
    frho: torch.Tensor  # (nrho+1, 7)
    z2r: torch.Tensor  # (nr+1, 7)
    rdr: float
    rdrho: float
    nr: int
    nrho: int

    @classmethod
    def from_tables(cls, t, device, dtype) -> "EamDevice":
        """Tables of a host `EamTables` on `device`, in `dtype`."""
        def put(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(
            rhor=put(t.rhor_spline), frho=put(t.frho_spline),
            z2r=put(t.z2r_spline), rdr=t.rdr, rdrho=t.rdrho, nr=t.nr,
            nrho=t.nrho,
        )


def _grid_index(r_or_rho, rd, n):
    """p = x*rd + 1; m = floor(p) clamped to [1, n-1]; frac = min(p - m, 1)
    (reference: force_eam.c:74-79, 100-105). Returns (m int64, frac)."""
    p = r_or_rho * rd + 1.0
    m = torch.floor(p).to(torch.int32).clamp(1, n - 1)
    frac = torch.clamp(p - m, max=1.0)
    return m.long(), frac


def _horner(coefs, t):
    """Power-basis Horner, highest degree first, with the coefficients as
    Python floats (so they round to t's dtype, as mdbench_tpu's static
    coefficients do). `coefs` ascending (numpy polynomial convention)."""
    acc = torch.full_like(t, float(coefs[-1]))
    for c in coefs[-2::-1]:
        acc = acc * t + float(c)
    return acc
