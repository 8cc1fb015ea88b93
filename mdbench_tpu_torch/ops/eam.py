"""EAM over verlet neighbor lists, two passes with a ghost-fp refresh
between them (the port of ``mdbench_tpu.ops.eam``; reference
src/verletlist/force_eam.c:20-231), and the spline tables and per-atom
lookups that the cluster-scheme EAM force (``ops/eam_cluster.py``) shares.

Pass 1: per-atom density rho_i from the rhor spline, then fp_i = F'(rho_i)
from the frho spline; the ghost rows of fp are copied from their local
atoms through the halo's border_map (force_eam.c:117-120). Pass 2: pair
forces from the rhor' and z2r splines, psip = fp_i*rhoip + fp_j*rhoip +
phip, F = -psip/r. The passes are also callable one by one
(`eam_density`, then the caller's ghost fp, then `eam_pair_forces`): the
domain engine runs pass 1 on every domain before it exchanges the
boundary fp.

Torch ops on every device, with mdbench_tpu's arithmetic and order: one
packed (N, K, 14) row gather of [rhor | z2r] by the (N, K) grid index
serves both passes, and every intermediate is a planar (N, K) tensor.
Masked lanes take r = 1 before the square root (a sentinel neighbour's
rsq is inf in float32) and a force of 0 after. The sums over the list
axis may round differently from XLA's in the last bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mdbench_tpu_torch.ops.lj import _planar_delta_rsq


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

    @property
    def rz_packed(self) -> torch.Tensor:  # (nr+1, 14) [rhor | z2r]
        return torch.cat([self.rhor, self.z2r], dim=1)


def use_poly_eval(params, device) -> bool:
    """The eam_eval axis: "poly" evaluates the fitted pair polynomials,
    "spline" the reference's gathered splines, and "auto" takes poly for
    single precision on a CUDA device, the spline elsewhere (mdbench_tpu:
    poly for SP on a TPU)."""
    return params.eam_eval == "poly" or (
        params.eam_eval == "auto" and params.precision == "sp"
        and torch.device(device).type == "cuda"
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


def _lanes(x, neighbors, numneigh, nlocal_pad: int, cutforcesq: float):
    """Planar deltas, the pair mask and r (1 on masked lanes)."""
    k = neighbors.shape[1]
    valid = torch.arange(k, device=x.device)[None, :] < numneigh[:, None]
    dx, dy, dz, rsq = _planar_delta_rsq(x, neighbors, nlocal_pad)
    mask = valid & (rsq < cutforcesq)
    return dx, dy, dz, mask, torch.sqrt(torch.where(mask, rsq, 1.0))


class EamPass(NamedTuple):
    """What pass 2 of the verlet EAM force needs of pass 1: the planar
    deltas and the pair mask, the pair terms (spline: r, rhoip, z2p, z2;
    poly: t) and the local rows' fp."""

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    mask: torch.Tensor
    terms: tuple
    fp_local: torch.Tensor  # (nlocal_pad,)


def _embedding(rhoi, eam: EamDevice, nrows: int):
    """fp = F'(rho) on the local rows from the frho spline. Returns
    (fp_local (nlocal_pad,), fp (nrows,)), fp's other rows 0."""
    mf, pf = _grid_index(rhoi, eam.rdrho, eam.nrho)
    fs = eam.frho[mf]  # (nlocal_pad, 7)
    fp_local = (fs[:, 0] * pf + fs[:, 1]) * pf + fs[:, 2]
    fp = torch.zeros((nrows,), dtype=rhoi.dtype, device=rhoi.device)
    fp[: fp_local.shape[0]] = fp_local
    return fp_local, fp


def ghost_fp_refresh(fp, border_map, nlocal_pad: int):
    """The single-device ghost fp (force_eam.c:117-120), in place: ghost
    slot g takes fp[border_map[g]], gathered before the slice is written
    (dead slots read the sentinel row, whose fp stays 0). Returns fp."""
    fp[nlocal_pad : nlocal_pad + border_map.shape[0]] = fp[border_map]
    return fp


def eam_density(x, neighbors, numneigh, nlocal_pad: int, cutforcesq: float,
                eam: EamDevice, poly=None):
    """Pass 1 of the verlet EAM force (force_eam.c:60-90): per local atom
    rho_i over its list, then fp_i = F'(rho_i). Pair terms from the
    reference's gathered splines, or from the fitted polynomials of `poly`
    (models/eam_tables.fit_eam_poly) in t = clip((r - mid) * iscale, -1,
    1). Returns (EamPass, fp (nrows,)) with fp's ghost rows 0: the caller
    fills them (ghost_fp_refresh, or a domain engine's exchange) before
    `eam_pair_forces`."""
    dx, dy, dz, mask, r = _lanes(x, neighbors, numneigh, nlocal_pad, cutforcesq)
    if poly is None:
        m, p = _grid_index(r, eam.rdr, eam.nr)
        # one packed row gather for both passes; only (N, K) planes stay
        # live across the fp refresh
        rows = eam.rz_packed.index_select(0, m.reshape(-1)).reshape(*m.shape, 14)
        rs, zs = rows[..., 0:7], rows[..., 7:14]
        dens = ((rs[..., 3] * p + rs[..., 4]) * p + rs[..., 5]) * p + rs[..., 6]
        rhoip = (rs[..., 0] * p + rs[..., 1]) * p + rs[..., 2]
        z2p = (zs[..., 0] * p + zs[..., 1]) * p + zs[..., 2]
        z2 = ((zs[..., 3] * p + zs[..., 4]) * p + zs[..., 5]) * p + zs[..., 6]
        del rows, rs, zs
        terms = (r, rhoip, z2p, z2)
    else:
        # the clamp covers r < lo and the masked lanes' r = 1
        t = torch.clamp((r - float(poly.mid)) * float(poly.iscale), -1.0, 1.0)
        dens = _horner(poly.dens, t)
        terms = (t,)
    rhoi = torch.sum(torch.where(mask, dens, 0.0), dim=1)
    fp_local, fp = _embedding(rhoi, eam, x.shape[0])
    return EamPass(dx, dy, dz, mask, terms, fp_local), fp


def eam_pair_forces(st: EamPass, fp, neighbors, poly=None):
    """Pass 2 (force_eam.c:122-227) from pass 1's `st` and the fp of every
    row, ghosts filled: spline psip = fp_i*rhoip + fp_j*rhoip + phip, F =
    -psip/r; poly fpair = -((fp_i + fp_j) g1(t) + g2(t)). Returns the
    forces (nlocal_pad, 3)."""
    if poly is None:
        r, rhoip, z2p, z2 = st.terms
        recip = 1.0 / r
        phi = z2 * recip
        phip = z2p * recip - phi * recip
        psip = st.fp_local[:, None] * rhoip + fp[neighbors] * rhoip + phip
        fpair = torch.where(st.mask, -psip * recip, 0.0)
    else:
        (t,) = st.terms
        fpair = torch.where(
            st.mask,
            -((st.fp_local[:, None] + fp[neighbors]) * _horner(poly.g1, t)
              + _horner(poly.g2, t)),
            0.0,
        )
    return torch.stack([torch.sum(st.dx * fpair, dim=1),
                        torch.sum(st.dy * fpair, dim=1),
                        torch.sum(st.dz * fpair, dim=1)], dim=1)


def _two_pass(x, neighbors, numneigh, border_map, nlocal_pad, cutforcesq, eam, poly):
    st, fp = eam_density(x, neighbors, numneigh, nlocal_pad, cutforcesq, eam, poly)
    fp = ghost_fp_refresh(fp, border_map, st.fp_local.shape[0])
    return eam_pair_forces(st, fp, neighbors, poly), fp


def compute_force_eam(x, neighbors, numneigh, border_map, nlocal: int,
                      nlocal_pad: int, cutforcesq: float, eam: EamDevice):
    """EAM forces over the per-atom lists with the reference's gathered
    splines: `eam_density`, the single-device ghost fp (ghost_fp_refresh),
    `eam_pair_forces`. Returns (forces (nlocal_pad, 3), fp (nrows,)). A
    domain engine fills the ghost fp by its own exchange and so calls the
    three parts itself (parallel/verlet_domain)."""
    return _two_pass(x, neighbors, numneigh, border_map, nlocal_pad, cutforcesq, eam,
                     None)


def compute_force_eam_poly(x, neighbors, numneigh, border_map, nlocal: int,
                           nlocal_pad: int, cutforcesq: float, eam: EamDevice,
                           poly):
    """The gather-free twin of compute_force_eam: the per-pair rhor and z2r
    lookups become the fitted polynomials of `poly`
    (models/eam_tables.fit_eam_poly) in t = clip((r - mid) * iscale, -1, 1),

      pass 1: rho_i = sum dens(t)
      pass 2: fpair = -((fp_i + fp_j) * g1(t) + g2(t)),

    the per-atom frho lookup stays on its spline. Same two passes and
    outputs."""
    return _two_pass(x, neighbors, numneigh, border_map, nlocal_pad, cutforcesq, eam,
                     poly)
