"""Velocity-Verlet integration and the PBC position wrap of the verlet
scheme (the port of ``mdbench_tpu.ops.integrate``; reference
src/verletlist/integrate.c:21-40 and pbc.c:59-84).

The two integration halves update their tensors IN PLACE (mdbench_tpu
rebuilt them with .at[].add); each returns what it updated.
"""

from __future__ import annotations

import torch


def initial_integrate(x, v, f, dt: float, dtforce: float, nlocal: int):
    """v += dtforce * f; x += dt * v on the local rows (reference
    integrate.c:21-31); padding and ghost rows are untouched."""
    v[:nlocal] += dtforce * f[:nlocal]
    x[:nlocal] += dt * v[:nlocal]
    return x, v


def final_integrate(v, f, dtforce: float, nlocal: int):
    """v += dtforce * f (reference integrate.c:33-40)."""
    v[:nlocal] += dtforce * f[:nlocal]
    return v


def wrap_into_box(x, prd, nlocal: int):
    """A copy of x with the local atoms that left the box moved back by one
    period (reference pbc.c:59-84: one add or subtract, not a modulo).
    `prd` is three host floats, so nothing is copied to the device."""
    cols = []
    for d in range(3):
        c = x[:nlocal, d]
        p = float(prd[d])
        c = torch.where(c < 0.0, c + p, c)
        cols.append(torch.where(c >= p, c - p, c))
    out = x.clone()
    out[:nlocal] = torch.stack(cols, dim=1)
    return out
