"""Plain reference for an LJ box: velocity Verlet in which every pair inside
cutforce acts at every step, in plain torch, on whatever device holds the
atoms. It imports nothing of the program.

The program follows MD-Bench (reference src/verletlist/main.c:129-344):
lists rebuilt every `reneigh_every` steps at cutforce + skin. This
reference keeps its own lists at cutforce + REF_SKIN and rebuilds them as
soon as any atom has moved REF_SKIN / 2 since the last build, so no pair
inside cutforce is ever missing: it is the trajectory the physics asks
for. Positions stay unwrapped; every distance takes the minimum image.

Pair term (reference src/verletlist/force_lj.c): for r^2 < cutforce^2,
sr2 = 1 / r^2, sr6 = sr2^3 sigma^6, F_i += (x_i - x_j) 48 eps sr6 (sr6 - 1/2)
sr2. Thermo (src/common/thermo.c:55-80, LJ units): T = m sum v^2 / (3N - 3),
P = T (3N - 3) / (3 V).

`dtype` is the precision of the state and the sums; `pair_dtype`, where
given, that of the pair term alone (the control computes it in bfloat16).
Rows go in blocks of BLOCK atoms so that 1M atoms fit beside the program.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional

import torch

BLOCK = 65536
REF_SKIN = 0.6
# pairs with |r^2 - cutforce^2| under CUT_BAND * cutforce^2 lie within
# single-precision rounding of r^2 (positions up to ~110, r^2 from three
# rounded differences: under 1.1e-5 relative) of the cutoff, where the
# unshifted LJ term jumps by F(cutforce) (0.039 at 2.5): a program in
# float32 may count them either way
CUT_BAND = 5e-5


class Band(NamedTuple):
    """Each atom's pairs within CUT_BAND of the cutoff: (N, 3) sum of their
    forces, (N,) sum of their force magnitudes, (N,) their number."""
    vec: torch.Tensor
    mag: torch.Tensor
    n: torch.Tensor


class Trajectory(NamedTuple):
    temps: torch.Tensor  # (steps,) after each step
    press: torch.Tensor
    x: torch.Tensor  # (N, 3) unwrapped, after the last step
    v: torch.Tensor


def min_image(d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return d - box * torch.round(d / box)


def _candidates(xw: torch.Tensor, box: torch.Tensor, rcut: float):
    """A function of a row range giving (b, M) candidate ids, -1 for none:
    the atoms of the 27 cells around each row's cell where every box side
    holds 3 cells of at least rcut, else every atom."""
    n = xw.shape[0]
    dev = xw.device
    nc = [int(math.floor(float(L) / rcut)) for L in box]
    if min(nc) < 3:
        every = torch.arange(n, device=dev)
        return lambda s, e: every.expand(e - s, n)
    ncv = torch.tensor(nc, device=dev)
    c3 = torch.minimum(torch.floor(xw / (box / ncv)).long(), ncv - 1)
    cid = (c3[:, 0] * nc[1] + c3[:, 1]) * nc[2] + c3[:, 2]
    ncells = nc[0] * nc[1] * nc[2]
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=ncells)
    start = torch.cumsum(counts, 0) - counts
    sorted_cid = cid[order]
    slot = torch.arange(n, device=dev) - start[sorted_cid]
    cells = torch.full((ncells, int(counts.max())), -1, dtype=torch.long, device=dev)
    cells[sorted_cid, slot] = order
    cc = torch.stack(torch.meshgrid(*(torch.arange(k, device=dev) for k in nc),
                                    indexing="ij"), -1).reshape(-1, 3)
    offs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)), device=dev)
    nb = (cc[:, None, :] + offs) % ncv
    nb = (nb[..., 0] * nc[1] + nb[..., 1]) * nc[2] + nb[..., 2]  # (ncells, 27)
    return lambda s, e: cells[nb[cid[s:e]]].reshape(e - s, -1)


def build_lists(x: torch.Tensor, box: torch.Tensor, rcut: float,
                block: int = BLOCK) -> list:
    """Every other atom within rcut of each atom (minimum image): per block
    of rows, (first row, (b, K) neighbour ids, (b, K) mask)."""
    n = x.shape[0]
    xw = x - box * torch.floor(x / box)
    cand_of = _candidates(xw, box, rcut)
    blocks = []
    for s in range(0, n, block):
        e = min(s + block, n)
        cand = cand_of(s, e)
        ok = cand >= 0
        cj = cand.clamp(min=0)
        d = min_image(xw[s:e, None, :] - xw[cj], box)
        r2 = (d * d).sum(-1)
        rows = torch.arange(s, e, device=x.device)[:, None]
        ok &= (r2 < rcut * rcut) & (cj != rows)
        k = max(int(ok.sum(1).max()), 1) if e > s else 1
        pick = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)[:, :k]
        blocks.append((s, cj.gather(1, pick), ok.gather(1, pick)))
    return blocks


def pair_counts(x: torch.Tensor, box: torch.Tensor, r_outer: float,
                r_inner: float) -> tuple[int, int]:
    """Ordered pairs (i, j), i != j, within r_outer and within r_inner."""
    lists = build_lists(x, box, r_outer)
    outer = inner = 0
    for s, nbr, ok in lists:
        d = min_image(x[s:s + nbr.shape[0], None, :] - x[nbr], box)
        r2 = (d * d).sum(-1)
        outer += int(ok.sum())
        inner += int((ok & (r2 < r_inner * r_inner)).sum())
    return outer, inner


def lj_forces(x: torch.Tensor, lists: list, box: torch.Tensor, cfg: dict,
              pair_dtype: Optional[torch.dtype] = None,
              band: float = 0.0):
    """(N, 3) LJ forces in x's dtype, the pair term in pair_dtype. With
    band > 0, returns (forces without the pairs within band * cutforce^2
    of the cutoff, those pairs as a Band)."""
    cutsq = cfg["cutforce"] ** 2
    sigma6 = cfg["sigma"] ** 6
    eps48 = 48.0 * cfg["epsilon"]
    f = torch.empty_like(x)
    edges = Band(torch.zeros_like(x), torch.zeros_like(x[:, 0]),
                 torch.zeros_like(x[:, 0], dtype=torch.long))
    for s, nbr, ok in lists:
        e = s + nbr.shape[0]
        d = min_image(x[s:e, None, :] - x[nbr], box)
        r2 = (d * d).sum(-1)
        inside = ok & (r2 < cutsq)
        edge = ok & ((r2 - cutsq).abs() < band * cutsq)
        r2 = torch.where(inside | edge, r2, torch.ones_like(r2))
        if pair_dtype is not None:
            r2 = r2.to(pair_dtype)
        sr2 = 1.0 / r2
        sr6 = sr2 * sr2 * sr2 * sigma6
        fpair = (eps48 * sr6 * (sr6 - 0.5) * sr2).to(x.dtype)
        zero = torch.zeros_like(d[..., 0])
        f[s:e] = (d * torch.where(inside & ~edge, fpair, zero)[..., None]).sum(1)
        if band > 0:
            fe = torch.where(edge, fpair, zero)
            edges.vec[s:e] = (d * fe[..., None]).sum(1)
            edges.mag[s:e] = (fe.abs() * d.norm(dim=-1)).sum(1)
            edges.n[s:e] = edge.sum(1)
    return (f, edges) if band > 0 else f


def forces_at(x: torch.Tensor, box: torch.Tensor, cfg: dict):
    """float64 forces at positions x (any dtype) without the pairs at the
    cutoff's edge (CUT_BAND), and those pairs as a Band."""
    x = x.to(torch.float64)
    box = box.to(torch.float64)
    return lj_forces(x, build_lists(x, box, cfg["cutforce"] + 0.05), box, cfg,
                     band=CUT_BAND)


def thermo(v: torch.Tensor, cfg: dict, volume: float):
    n = v.shape[0]
    t = (v * v).sum() * cfg["mass"] / (3 * n - 3)
    return t, t * (3 * n - 3) / (3.0 * volume)


def trajectory(x0, v0, box, cfg: dict, steps: int, dtype=torch.float64,
               pair_dtype: Optional[torch.dtype] = None,
               skin: float = REF_SKIN) -> Trajectory:
    """`steps` velocity-Verlet steps from (x0, v0) (torch tensors on the
    device to run on), thermo after each."""
    x = x0.to(dtype).clone()
    v = v0.to(dtype).clone()
    box = box.to(dtype)
    volume = float(box.prod())
    dt = cfg["dt"]
    dtf = 0.5 * dt
    rlist = cfg["cutforce"] + skin
    x_built = x.clone()
    lists = build_lists(x, box, rlist)
    f = lj_forces(x, lists, box, cfg, pair_dtype)
    temps, press = [], []
    for _ in range(steps):
        v += dtf * f
        x += dt * v
        if float((x - x_built).norm(dim=1).max()) > 0.5 * skin:
            x_built = x.clone()
            lists = build_lists(x, box, rlist)
        f = lj_forces(x, lists, box, cfg, pair_dtype)
        v += dtf * f
        t, p = thermo(v, cfg, volume)
        temps.append(t)
        press.append(p)
    return Trajectory(torch.stack(temps), torch.stack(press), x, v)
