"""Lennard-Jones forces over per-atom verlet lists, planar torch ops (the
port of ``mdbench_tpu.ops.lj``; an XLA path there, torch ops on every
device here; reference src/verletlist/force_lj.c).

Pair math in the reference's order (force_lj.c:69-75): sr2 = 1/rsq;
sr6 = sr2^3 * sigma6; F = 48 * sr6 * (sr6 - 0.5) * sr2 * epsilon.
Intermediates are planar (N, K) tensors per coordinate, as in
mdbench_tpu. Masked lanes take rsq = 1 before the divide and 0 after: a
sentinel neighbour's rsq may be inf in float32, so the mask selects and
never multiplies.

The half-list force (force_lj.c:107-198) adds the Newton reaction
f[j] -= f_ij for local j with `index_add_`: on the CPU it sums in a fixed
order; on CUDA it sums with atomics in no fixed order, so two runs on the
card may differ in the last bits (mdbench_tpu's scatter-add is
deterministic). The tests hold it to the reference's half-list
tolerance.

Typed runs pass `types` (all coordinate rows) and `tables` (a
state.TypeTables): each pair then takes its cutoff^2, sigma^6 and epsilon
from the (T, T) tables.
"""

from __future__ import annotations

import torch


def _planar_delta_rsq(x, neighbors, nlocal_pad: int):
    """One row gather, then planar (N, K) deltas and rsq."""
    xj = x[neighbors]  # (N, K, 3)
    xi = x[:nlocal_pad]
    dx = xi[:, 0, None] - xj[:, :, 0]
    dy = xi[:, 1, None] - xj[:, :, 1]
    dz = xi[:, 2, None] - xj[:, :, 2]
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


def _pair_force(rsq, mask, sigma6, epsilon):
    sr2 = 1.0 / torch.where(mask, rsq, 1.0)
    sr6 = sr2 * sr2 * sr2 * sigma6
    return torch.where(mask, 48.0 * sr6 * (sr6 - 0.5) * sr2 * epsilon, 0.0)


def _pair_tables(tables, types, nlocal_pad: int, neighbors):
    """Per-pair (cutforcesq, sigma6, epsilon) from the (T, T) tables."""
    nt = tables.epsilon.shape[0]
    idx = types[:nlocal_pad].long()[:, None] * nt + types[neighbors].long()
    return tuple(t.reshape(-1)[idx]
                 for t in (tables.cutforcesq, tables.sigma6, tables.epsilon))


def _masked(x, neighbors, numneigh, nlocal_pad, cutforcesq, sigma6, epsilon,
            types, tables):
    k = neighbors.shape[1]
    valid = torch.arange(k, device=x.device)[None, :] < numneigh[:, None]
    dx, dy, dz, rsq = _planar_delta_rsq(x, neighbors, nlocal_pad)
    if tables is not None:
        cutforcesq, sigma6, epsilon = _pair_tables(tables, types, nlocal_pad,
                                                   neighbors)
    mask = valid & (rsq < cutforcesq)
    return dx, dy, dz, rsq, mask, sigma6, epsilon


def compute_force_lj_full(x, neighbors, numneigh, nlocal_pad: int, cutforcesq,
                          sigma6, epsilon, types=None, tables=None):
    """Full-list LJ forces, (nlocal_pad, 3)."""
    dx, dy, dz, rsq, mask, sigma6, epsilon = _masked(
        x, neighbors, numneigh, nlocal_pad, cutforcesq, sigma6, epsilon, types,
        tables)
    g = _pair_force(rsq, mask, sigma6, epsilon)
    return torch.stack([(dx * g).sum(1), (dy * g).sum(1), (dz * g).sum(1)], dim=1)


def compute_force_lj_half(x, neighbors, numneigh, nlocal: int, nlocal_pad: int,
                          cutforcesq, sigma6, epsilon, types=None, tables=None):
    """Half-list LJ forces with the Newton reaction on local j (reference
    force_lj.c:176-180), (nlocal_pad, 3); module docstring on its order."""
    dx, dy, dz, rsq, mask, sigma6, epsilon = _masked(
        x, neighbors, numneigh, nlocal_pad, cutforcesq, sigma6, epsilon, types,
        tables)
    g = _pair_force(rsq, mask, sigma6, epsilon)
    jj = torch.where(mask & (neighbors < nlocal), neighbors, nlocal_pad).reshape(-1)
    cols = []
    for d in (dx, dy, dz):
        c = d * g
        acc = torch.zeros(nlocal_pad + 1, dtype=x.dtype, device=x.device)
        acc.index_add_(0, jj, -c.reshape(-1))
        cols.append(c.sum(1) + acc[:nlocal_pad])
    return torch.stack(cols, dim=1)


def lj_energy_virial(x, neighbors, numneigh, nlocal_pad: int, cutforcesq, sigma6,
                     epsilon):
    """(potential energy, virial) from a full list, each a 0-dim tensor
    (mdbench_tpu's sums; its virial multiplies rsq by a masked 0, which is
    NaN for an inf rsq in float32, where this one selects)."""
    dx, dy, dz, rsq, mask, sigma6, epsilon = _masked(
        x, neighbors, numneigh, nlocal_pad, cutforcesq, sigma6, epsilon, None, None)
    sr2 = 1.0 / torch.where(mask, rsq, 1.0)
    sr6 = sr2 * sr2 * sr2 * sigma6
    epair = torch.where(mask, 4.0 * epsilon * sr6 * (sr6 - 1.0), 0.0)
    # rsq * F selected, not multiplied: a masked lane's rsq may be inf
    virial = torch.where(mask, rsq * (48.0 * epsilon * sr6 * (sr6 - 0.5) * sr2), 0.0)
    return 0.5 * epair.sum(), 0.5 * virial.sum()
