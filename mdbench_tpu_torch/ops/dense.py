"""All-pairs O(N^2) LJ forces with the minimum image, the correctness
oracle of the list-based forces (the port of ``mdbench_tpu.ops.dense``;
the reference validates its kernels against a scalar version the same
way, USE_REFERENCE_VERSION, src/clusterpair/force_lj.c:47-165). Exact for
a cutoff under half the box; for tests on small boxes.
"""

from __future__ import annotations

import torch


def _pairwise_min_image(x, prd):
    """delta[i, j] = x[i] - x[j], minimum image over the periodic dims."""
    delta = x[:, None, :] - x[None, :, :]
    prd = torch.as_tensor(prd, dtype=x.dtype, device=x.device)
    return delta - prd * torch.round(delta / prd)


def _pair_force(delta, cutsq, sigma6, epsilon):
    """(rsq, mask, F/r) with the reference's pair math (force_lj.c:69-75)."""
    n = delta.shape[0]
    rsq = torch.sum(delta * delta, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=delta.device)
    mask = (rsq < cutsq) & ~eye
    sr2 = 1.0 / torch.where(mask, rsq, 1.0)
    sr6 = sr2 * sr2 * sr2 * sigma6
    force = torch.where(mask, 48.0 * sr6 * (sr6 - 0.5) * sr2 * epsilon, 0.0)
    return rsq, mask, sr6, force


def lj_force_dense(x, prd, cutforce: float, sigma6: float, epsilon: float):
    """All-pairs LJ forces. Returns (forces (N, 3), potential energy,
    virial)."""
    delta = _pairwise_min_image(x, prd)
    rsq, mask, sr6, force = _pair_force(delta, cutforce * cutforce, sigma6, epsilon)
    f = torch.sum(delta * force[..., None], dim=1)
    epair = torch.where(mask, 4.0 * epsilon * sr6 * (sr6 - 1.0), 0.0)
    return f, 0.5 * torch.sum(epair), 0.5 * torch.sum(rsq * force)


def lj_force_dense_typed(x, types, prd, tables):
    """All-pairs LJ with per-type-pair tables (reference EXPLICIT_TYPES,
    force_lj.c:61-67); `tables` is a state.TypeTables."""
    t = types[: x.shape[0]].long()
    pair = t[:, None], t[None, :]
    delta = _pairwise_min_image(x, prd)
    force = _pair_force(delta, tables.cutforcesq[pair], tables.sigma6[pair],
                        tables.epsilon[pair])[3]
    return torch.sum(delta * force[..., None], dim=1)
