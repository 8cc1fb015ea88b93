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
domain engines run pass 1 on every domain before they exchange the
boundary fp. Pass 2 recomputes each pair's distance from x, so nothing of
size (N, K) lives across the ghost-fp refresh.

On a CUDA tensor the passes launch the hand-written kernels of
``csrc/eam_verlet.cu`` (`eam_rho_nlist`, K5: the density and the frho
spline; `eam_force_nlist`, K6: the pair force), and the ghost refresh runs
as torch ops between them on the same stream. On a CPU tensor they run
the plain versions (`eam_rho_nlist_ref`, `eam_force_nlist_ref`): torch
ops with mdbench_tpu's arithmetic and order over planar (N, K) tensors.
Masked lanes take r = 1 before the square root (a sentinel neighbour's
rsq is inf in float32) and every masked lane is selected away, never
multiplied by 0 (mdbench_tpu multiplies d by a masked 0, so a NaN row
in a list gives it a NaN force and the port 0). The sums over the list
axis may round differently from XLA's in the last bits. Nothing falls
back from one to the other: another device, or a build or launch
failure, raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mdbench_tpu_torch import _build
from mdbench_tpu_torch.ops.lj import _planar_delta_rsq

# kernel launches made by the wrappers, by kernel (a run's proof that it
# went through the CUDA kernels); callers may reset them to 0
LAUNCHES = {"eam_rho_nlist": 0, "eam_force_nlist": 0}

N_COEF = 17  # coefficients per polynomial (degree 16) the kernels take


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


def poly_coefs(poly, cutforcesq: float) -> np.ndarray:
    """The EAM kernels' scalar block, float64 on the host: [mid, iscale,
    cutforcesq, dens[17], g1[17], g2[17]]. The C launchers copy it into a
    by-value kernel argument, rounded to the kernel's type."""
    polys = [np.asarray(c, np.float64).reshape(-1)
             for c in (poly.dens, poly.g1, poly.g2)]
    if any(c.shape != (N_COEF,) for c in polys):
        raise ValueError(
            f"the EAM kernels take degree-{N_COEF - 1} polynomials "
            f"({N_COEF} coefficients each)")
    return np.ascontiguousarray(np.concatenate(
        [[float(poly.mid), float(poly.iscale), float(cutforcesq)], *polys]))


def _lanes(x, neighbors, numneigh, nlocal_pad: int, cutforcesq: float):
    """Planar deltas, the pair mask and r (1 on masked lanes)."""
    k = neighbors.shape[1]
    valid = torch.arange(k, device=x.device)[None, :] < numneigh[:, None]
    dx, dy, dz, rsq = _planar_delta_rsq(x, neighbors, nlocal_pad)
    mask = valid & (rsq < cutforcesq)
    return dx, dy, dz, mask, torch.sqrt(torch.where(mask, rsq, 1.0))


def _poly_t(r, poly):
    """The fit variable; the clamp covers r < lo and the masked lanes' r = 1."""
    return torch.clamp((r - float(poly.mid)) * float(poly.iscale), -1.0, 1.0)


def _embedding(rhoi, eam: EamDevice, nrows: int):
    """fp = F'(rho) on the local rows from the frho spline: fp (nrows,),
    its other rows 0."""
    mf, pf = _grid_index(rhoi, eam.rdrho, eam.nrho)
    fs = eam.frho[mf]  # (nlocal_pad, 7)
    fp = torch.zeros((nrows,), dtype=rhoi.dtype, device=rhoi.device)
    fp[: rhoi.shape[0]] = (fs[:, 0] * pf + fs[:, 1]) * pf + fs[:, 2]
    return fp


def eam_rho_nlist_ref(x, neighbors, numneigh, nlocal_pad: int, cutforcesq: float,
                      eam: EamDevice, poly=None):
    """Plain torch pass 1 (force_eam.c:60-90): (fp (nrows,), rho
    (nlocal_pad,)), rho_i the sum over the listed pairs inside the cutoff
    of the rhor spline's value, or with `poly` (models/eam_tables.
    fit_eam_poly) of the dens polynomial; fp = F'(rho) on the local rows,
    0 on the others."""
    _, _, _, mask, r = _lanes(x, neighbors, numneigh, nlocal_pad, cutforcesq)
    if poly is None:
        m, p = _grid_index(r, eam.rdr, eam.nr)
        rs = eam.rhor[m]  # (N, K, 7)
        dens = ((rs[..., 3] * p + rs[..., 4]) * p + rs[..., 5]) * p + rs[..., 6]
    else:
        dens = _horner(poly.dens, _poly_t(r, poly))
    rho = torch.sum(torch.where(mask, dens, 0.0), dim=1)
    return _embedding(rho, eam, x.shape[0]), rho


def eam_force_nlist_ref(x, neighbors, numneigh, fp_local, fp, cutforcesq: float,
                        eam: EamDevice, poly=None):
    """Plain torch pass 2 (force_eam.c:122-227): the forces (nlocal_pad, 3)
    with fp_i from `fp_local` (nlocal_pad,) and fp_j from `fp` (nrows,),
    its ghost rows filled. Spline: psip = fp_i*rhoip + fp_j*rhoip + phip,
    F = -psip/r; poly: fpair = -((fp_i + fp_j) g1(t) + g2(t))."""
    dx, dy, dz, mask, r = _lanes(x, neighbors, numneigh, fp_local.shape[0],
                                 cutforcesq)
    fpj = fp[neighbors]
    if poly is None:
        m, p = _grid_index(r, eam.rdr, eam.nr)
        rs, zs = eam.rhor[m], eam.z2r[m]  # (N, K, 7) each
        rhoip = (rs[..., 0] * p + rs[..., 1]) * p + rs[..., 2]
        z2p = (zs[..., 0] * p + zs[..., 1]) * p + zs[..., 2]
        z2 = ((zs[..., 3] * p + zs[..., 4]) * p + zs[..., 5]) * p + zs[..., 6]
        del rs, zs
        recip = 1.0 / r
        phi = z2 * recip
        phip = z2p * recip - phi * recip
        psip = fp_local[:, None] * rhoip + fpj * rhoip + phip
        fpair = -psip * recip
    else:
        t = _poly_t(r, poly)
        fpair = -((fp_local[:, None] + fpj) * _horner(poly.g1, t)
                  + _horner(poly.g2, t))
    return torch.stack([torch.sum(torch.where(mask, d * fpair, 0.0), dim=1)
                        for d in (dx, dy, dz)], dim=1)


def check_nlist_args(x, neighbors, numneigh, nlocal_pad: int, eam: EamDevice):
    """The operands the verlet EAM kernels take, checked before a launch:
    x a contiguous float32 or float64 (nrows, 3) tensor, the lists
    contiguous int64 (nlocal_pad, k) and (nlocal_pad,) on x's device,
    nlocal_pad <= nrows, the spline tables contiguous (n+1, 7) of x's
    dtype and device."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (nrows, 3) tensor")
    if neighbors.dtype != torch.int64 or numneigh.dtype != torch.int64:
        raise TypeError("neighbors and numneigh must be int64")
    if (neighbors.dim() != 2 or neighbors.shape[0] != nlocal_pad
            or numneigh.shape != (nlocal_pad,) or nlocal_pad > x.shape[0]):
        raise ValueError("neighbors must be (nlocal_pad, k) and numneigh "
                         "(nlocal_pad,), nlocal_pad <= nrows")
    for t in (neighbors, numneigh, eam.rhor, eam.frho, eam.z2r):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("the lists and tables must be contiguous on x's device")
    for t in (eam.rhor, eam.frho, eam.z2r):
        if t.dtype != x.dtype or t.dim() != 2 or t.shape[1] != 7:
            raise ValueError("the spline tables must be (n+1, 7) of x's dtype")


def _scalars(eam: EamDevice, poly, cutforcesq: float) -> np.ndarray:
    """The scalar block of csrc/eam_verlet.cu: poly_coefs (zeros for the
    spline form's polynomials), then rdr, rdrho."""
    head = (np.concatenate([[0.0, 0.0, float(cutforcesq)], np.zeros(3 * N_COEF)])
            if poly is None else poly_coefs(poly, cutforcesq))
    return np.ascontiguousarray(np.concatenate([head, [eam.rdr, eam.rdrho]]))


def nlist_blocks_per_sm(name: str, dtype, poly: bool) -> int:
    """The blocks of K5 (`eam_rho_nlist`) or K6 that an SM of the current
    card holds (the occupancy API)."""
    n = _build.load().eam_nlist_blocks_per_sm(
        5 if name == "eam_rho_nlist" else 6, int(dtype == torch.float64), int(poly))
    if n < 0:
        raise RuntimeError(f"{name} occupancy query failed: CUDA error {-n}")
    return n


def _launch(name, x, ptrs, sizes, scalars):
    """Launch kernel `name` (the f32 or f64 entry point by x's dtype) on the
    current stream; raises on a launch error."""
    fn = getattr(_build.load(), f"{name}_{'f32' if x.dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(x.device):
        err = fn(*ptrs, *sizes, scalars.ctypes.data,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _device_rule(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no verlet EAM kernel for device {x.device}")
    return x.device.type == "cuda"


def eam_rho_nlist(x, neighbors, numneigh, nlocal_pad: int, cutforcesq: float,
                  eam: EamDevice, poly=None, want_rho: bool = False):
    """Pass 1 and the frho spline: (fp (nrows,), rho (nlocal_pad,) or
    None), fp's non-local rows 0. A CPU tensor takes the plain version
    (which returns rho whatever `want_rho` says); a CUDA tensor launches
    K5 (built from csrc/ at first use) after the operands are checked, and
    rho only with `want_rho`. Other devices raise ValueError."""
    if not _device_rule(x):
        return eam_rho_nlist_ref(x, neighbors, numneigh, nlocal_pad, cutforcesq,
                                 eam, poly)
    check_nlist_args(x, neighbors, numneigh, nlocal_pad, eam)
    fp = torch.empty((x.shape[0],), dtype=x.dtype, device=x.device)
    rho = (torch.empty((nlocal_pad,), dtype=x.dtype, device=x.device)
           if want_rho else None)
    _launch("eam_rho_nlist", x,
            (x.data_ptr(), neighbors.data_ptr(), numneigh.data_ptr(),
             None if poly is not None else eam.rhor.data_ptr(), eam.frho.data_ptr(),
             fp.data_ptr(), None if rho is None else rho.data_ptr()),
            (x.shape[0], nlocal_pad, neighbors.shape[1], eam.nr, eam.nrho,
             int(poly is not None)),
            _scalars(eam, poly, cutforcesq))
    return fp, rho


def eam_force_nlist(x, neighbors, numneigh, fp_local, fp, cutforcesq: float,
                    eam: EamDevice, poly=None):
    """Pass 2, the forces (nlocal_pad, 3): the plain version on a CPU
    tensor, K6 on a CUDA tensor (fp_local (nlocal_pad,) and fp (nrows,)
    contiguous of x's dtype and device)."""
    if not _device_rule(x):
        return eam_force_nlist_ref(x, neighbors, numneigh, fp_local, fp, cutforcesq,
                                   eam, poly)
    nlocal_pad = fp_local.shape[0]
    check_nlist_args(x, neighbors, numneigh, nlocal_pad, eam)
    for t, n in ((fp_local, nlocal_pad), (fp, x.shape[0])):
        if (t.shape != (n,) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError("fp_local and fp must be contiguous (nlocal_pad,) and "
                             "(nrows,) tensors of x's dtype and device")
    f = torch.empty((nlocal_pad, 3), dtype=x.dtype, device=x.device)
    spline = poly is None
    _launch("eam_force_nlist", x,
            (x.data_ptr(), neighbors.data_ptr(), numneigh.data_ptr(),
             eam.rhor.data_ptr() if spline else None,
             eam.z2r.data_ptr() if spline else None,
             fp_local.data_ptr(), fp.data_ptr(), f.data_ptr()),
            (x.shape[0], nlocal_pad, neighbors.shape[1], eam.nr, eam.nrho,
             int(not spline)),
            _scalars(eam, poly, cutforcesq))
    return f


class EamPass(NamedTuple):
    """What pass 2 of the verlet EAM force needs of pass 1: the
    coordinates, list lengths, cutoff and tables (pass 2 recomputes each
    pair's distance) and the local rows' fp (a view of fp's first rows,
    which no ghost refresh writes)."""

    x: torch.Tensor
    numneigh: torch.Tensor
    cutforcesq: float
    eam: EamDevice
    fp_local: torch.Tensor  # (nlocal_pad,)


def ghost_fp_refresh(fp, border_map, nlocal_pad: int):
    """The single-device ghost fp (force_eam.c:117-120), in place: ghost
    slot g takes fp[border_map[g]], gathered before the slice is written
    (dead slots read the sentinel row, whose fp stays 0). Returns fp."""
    fp[nlocal_pad : nlocal_pad + border_map.shape[0]] = fp[border_map]
    return fp


def eam_density(x, neighbors, numneigh, nlocal_pad: int, cutforcesq: float,
                eam: EamDevice, poly=None):
    """Pass 1 of the verlet EAM force (force_eam.c:60-90): per local atom
    rho_i over its list, then fp_i = F'(rho_i) (`eam_rho_nlist`: K5 on the
    card). Pair terms from the reference's gathered splines, or from the
    fitted polynomials of `poly` (models/eam_tables.fit_eam_poly) in t =
    clip((r - mid) * iscale, -1, 1). Returns (EamPass, fp (nrows,)) with
    fp's ghost rows 0: the caller fills them (ghost_fp_refresh, or a
    domain engine's exchange) before `eam_pair_forces`."""
    fp, _ = eam_rho_nlist(x, neighbors, numneigh, nlocal_pad, cutforcesq, eam, poly)
    return EamPass(x, numneigh, cutforcesq, eam, fp[:nlocal_pad]), fp


def eam_pair_forces(st: EamPass, fp, neighbors, poly=None):
    """Pass 2 (force_eam.c:122-227) from pass 1's `st` and the fp of every
    row, ghosts filled (`eam_force_nlist`: K6 on the card): spline psip =
    fp_i*rhoip + fp_j*rhoip + phip, F = -psip/r; poly fpair = -((fp_i +
    fp_j) g1(t) + g2(t)). Returns the forces (nlocal_pad, 3)."""
    return eam_force_nlist(st.x, neighbors, st.numneigh, st.fp_local, fp,
                           st.cutforcesq, st.eam, poly)


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
