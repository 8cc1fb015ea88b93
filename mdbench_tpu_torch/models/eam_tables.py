"""EAM funcfl tables: file reader, grid re-interpolation, spline builder.

The port's copy of ``mdbench_tpu.models.eam_tables`` (numpy only, so the
two packages build bit-equal tables from one file); only `Params` is the
port's. Host-side NumPy port of the reference pipeline (src/common/eam_utils.c):
readEamFile (funcfl parser, eam_utils.c:42-93) -> file2array (cubic
re-interpolation onto uniform grids incl. z2r = 27.2*0.529*zri*zrj,
eam_utils.c:95-220) -> array2spline/interpolate (7-coefficient spline
tables, eam_utils.c:222-284). Same math, float64 throughout; the device
gets (n+1, 7) spline arrays instead of the reference's flat 64-padded
strides (padding was a CPU alignment concern only).

initEam's parameter overrides (eam_utils.c:22-40) are reproduced by
`apply_eam_overrides`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mdbench_tpu_torch.config import Params


class Funcfl(NamedTuple):
    mass: float
    nrho: int
    drho: float
    nr: int
    dr: float
    cut: float
    frho: np.ndarray  # (nrho+1,) 1-indexed
    zr: np.ndarray  # (nr+1,)
    rhor: np.ndarray  # (nr+1,)


class EamTables(NamedTuple):
    nr: int
    nrho: int
    rdr: float
    rdrho: float
    cut: float
    mass: float
    frho_spline: np.ndarray  # (nrho+1, 7)
    rhor_spline: np.ndarray  # (nr+1, 7)
    z2r_spline: np.ndarray  # (nr+1, 7)


def read_funcfl(filename: str) -> Funcfl:
    """Parse a single-element DYNAMO funcfl file (eam_utils.c:42-93)."""
    with open(filename) as fp:
        tokens = []
        fp.readline()  # comment line
        line2 = fp.readline().split()
        mass = float(line2[1])
        line3 = fp.readline().split()
        nrho, drho, nr, dr, cut = (
            int(line3[0]), float(line3[1]), int(line3[2]),
            float(line3[3]), float(line3[4]),
        )
        for line in fp:
            tokens.extend(line.split())
    vals = np.array([float(t) for t in tokens], np.float64)
    if vals.size < nrho + 2 * nr:
        raise ValueError(f"truncated funcfl file {filename}")
    frho_raw = vals[:nrho]
    zr_raw = vals[nrho : nrho + nr]
    rhor_raw = vals[nrho + nr : nrho + 2 * nr]

    # shift to 1-indexed (eam_utils.c:85-90)
    def one_indexed(a, n):
        out = np.zeros(n + 1, np.float64)
        out[1 : n + 1] = a
        return out

    return Funcfl(
        mass=mass, nrho=nrho, drho=drho, nr=nr, dr=dr, cut=cut,
        frho=one_indexed(frho_raw, nrho),
        zr=one_indexed(zr_raw, nr),
        rhor=one_indexed(rhor_raw, nr),
    )


def _cubic_interp(file_vals, file_d, n_file, m, d_new):
    """The reference's 4-point cubic re-interpolation of one grid point
    (eam_utils.c:127-143)."""
    sixth = 1.0 / 6.0
    r = (m - 1) * d_new
    p = r / file_d + 1.0
    k = int(p)
    k = min(k, n_file - 2)
    k = max(k, 2)
    p -= k
    p = min(p, 2.0)
    cof1 = -sixth * p * (p - 1.0) * (p - 2.0)
    cof2 = 0.5 * (p * p - 1.0) * (p - 2.0)
    cof3 = -0.5 * p * (p + 1.0) * (p - 2.0)
    cof4 = sixth * p * (p * p - 1.0)
    return (
        cof1 * file_vals[k - 1]
        + cof2 * file_vals[k]
        + cof3 * file_vals[k + 1]
        + cof4 * file_vals[k + 2]
    )


def file2array(f: Funcfl):
    """Re-interpolate file grids onto the global grid
    (eam_utils.c:95-220). Single-file case: grids coincide numerically
    but we run the interpolation anyway for bit-parity."""
    dr, drho = f.dr, f.drho
    rmax = (f.nr - 1) * f.dr
    rhomax = (f.nrho - 1) * f.drho
    nr = int(rmax / dr + 0.5)
    nrho = int(rhomax / drho + 0.5)

    frho = np.zeros(nrho + 1, np.float64)
    for m in range(1, nrho + 1):
        frho[m] = _cubic_interp(f.frho, f.drho, f.nrho, m, drho)

    rhor = np.zeros(nr + 1, np.float64)
    z2r = np.zeros(nr + 1, np.float64)
    for m in range(1, nr + 1):
        rhor[m] = _cubic_interp(f.rhor, f.dr, f.nr, m, dr)
        zri = _cubic_interp(f.zr, f.dr, f.nr, m, dr)
        z2r[m] = 27.2 * 0.529 * zri * zri  # zri == zrj, single element

    return nr, dr, nrho, drho, frho, rhor, z2r


def interpolate(n: int, delta: float, fvals: np.ndarray) -> np.ndarray:
    """7-coefficient spline table (eam_utils.c:253-284), returned as
    (n+1, 7) with row 0 unused (1-indexed like the reference)."""
    sp = np.zeros((n + 1, 7), np.float64)
    sp[1 : n + 1, 6] = fvals[1 : n + 1]

    sp[1, 5] = sp[2, 6] - sp[1, 6]
    sp[2, 5] = 0.5 * (sp[3, 6] - sp[1, 6])
    sp[n - 1, 5] = 0.5 * (sp[n, 6] - sp[n - 2, 6])
    sp[n, 5] = sp[n, 6] - sp[n - 1, 6]
    for m in range(3, n - 1):
        sp[m, 5] = (
            (sp[m - 2, 6] - sp[m + 2, 6])
            + 8.0 * (sp[m + 1, 6] - sp[m - 1, 6])
        ) / 12.0

    for m in range(1, n):
        sp[m, 4] = (
            3.0 * (sp[m + 1, 6] - sp[m, 6]) - 2.0 * sp[m, 5] - sp[m + 1, 5]
        )
        sp[m, 3] = sp[m, 5] + sp[m + 1, 5] - 2.0 * (sp[m + 1, 6] - sp[m, 6])
    sp[n, 4] = 0.0
    sp[n, 3] = 0.0

    sp[1 : n + 1, 2] = sp[1 : n + 1, 5] / delta
    sp[1 : n + 1, 1] = 2.0 * sp[1 : n + 1, 4] / delta
    sp[1 : n + 1, 0] = 3.0 * sp[1 : n + 1, 3] / delta
    return sp


def load_eam(filename: str) -> EamTables:
    f = read_funcfl(filename)
    nr, dr, nrho, drho, frho, rhor, z2r = file2array(f)
    return EamTables(
        nr=nr, nrho=nrho, rdr=1.0 / dr, rdrho=1.0 / drho,
        cut=f.cut, mass=f.mass,
        frho_spline=interpolate(nrho, drho, frho),
        rhor_spline=interpolate(nr, dr, rhor),
        z2r_spline=interpolate(nr, dr, z2r),
    )


def spline_eval_np(sp: np.ndarray, x: np.ndarray, rd: float, n: int):
    """NumPy twin of the device spline lookup (ops/eam._grid_index +
    the value/derivative Horner forms, reference force_eam.c:74-110).
    Used by the polynomial fitter and by tests as the exact oracle."""
    p = x * rd + 1.0
    m = np.clip(np.floor(p).astype(np.int64), 1, n - 1)
    frac = np.minimum(p - m, 1.0)
    c = sp[m]
    val = ((c[..., 3] * frac + c[..., 4]) * frac + c[..., 5]) * frac + c[..., 6]
    der = (c[..., 0] * frac + c[..., 1]) * frac + c[..., 2]
    return val, der


class EamPoly(NamedTuple):
    """Gather-free per-pair EAM evaluation: global polynomial fits of
    the three per-pair functions the force path needs, over the
    physical pair-distance window [lo, cut]:

      dens(r)  = rhor spline value          (pass-1 density sum)
      g1(r)    = rhor'(r) / r               (pass-2: fpair embedding term)
      g2(r)    = (z2'(r)/r - z2(r)/r^2) / r (pass-2: fpair pair term)

    so that  fpair = -((fp_i + fp_j) * g1 + g2)  with NO per-pair table
    gather and NO reciprocal chain (the 1/r factors are folded into the
    fits). Coefficients are power-basis in the mapped variable
    t = (r - mid) * iscale in [-1, 1] (Chebyshev-fit then converted;
    f32 Horner at degree 16 reproduces the spline to ~1e-6 of each
    function's max — below the spline's own inter-knot wiggle).

    The fit window starts at `lo` (default 1.5 A — far below any
    physical pair distance in a condensed system; Cu FCC nearest
    neighbor is ~2.49 A); r below `lo` clamps to the window edge, which
    only matters for unphysical overlapping atoms. The per-ATOM frho
    embedding spline is NOT fitted: its gather is one row per atom
    (cheap), and exactness there preserves the energy scale."""

    lo: float
    cut: float
    mid: float  # (lo+cut)/2
    iscale: float  # 2/(cut-lo)
    dens: np.ndarray  # (deg+1,) power-basis, highest degree LAST
    g1: np.ndarray
    g2: np.ndarray
    max_rel_err: float  # fit diagnostic (max over the 3 fns, vs fn max)


def fit_eam_poly(
    tables: EamTables, lo: float = 1.5, degree: int = 16,
    samples: int = 200001,
) -> EamPoly:
    """Chebyshev-fit the per-pair spline functions on [lo, cut]. The
    fit target is the SPLINE's own evaluation (not the raw funcfl
    data): the DP spline path is the parity oracle, so the fast path
    approximates it, wiggles and all."""
    from numpy.polynomial import chebyshev as _C

    cut = tables.cut
    r = np.linspace(lo, cut, samples)
    t = 2.0 * (r - lo) / (cut - lo) - 1.0
    rho_v, rho_d = spline_eval_np(tables.rhor_spline, r, tables.rdr, tables.nr)
    z2_v, z2_d = spline_eval_np(tables.z2r_spline, r, tables.rdr, tables.nr)
    fns = {
        "dens": rho_v,
        "g1": rho_d / r,
        "g2": (z2_d / r - z2_v / (r * r)) / r,
    }
    coefs = {}
    err = 0.0
    for name, y in fns.items():
        cf = _C.chebfit(t, y, degree)
        pw = _C.cheb2poly(cf)  # power basis in t, ascending
        coefs[name] = pw.astype(np.float64)
        yy = np.polyval(pw[::-1], t)
        err = max(err, float(np.max(np.abs(yy - y)) / np.max(np.abs(y))))
    return EamPoly(
        lo=lo, cut=cut, mid=0.5 * (lo + cut), iscale=2.0 / (cut - lo),
        dens=coefs["dens"], g1=coefs["g1"], g2=coefs["g2"],
        max_rel_err=err,
    )


def apply_eam_overrides(params: Params, tables: EamTables) -> Params:
    """initEam's parameter overrides (eam_utils.c:29-37). NOTE: dtforce
    becomes 0.5*dt/mass here (and thermo later divides it by mvv2e,
    thermo.c:51)."""
    params.mass = tables.mass
    params.cutforce = tables.cut
    params.temp = 600.0
    params.dt = 0.001
    params.rho = 0.07041125
    params.finalize()
    # finalize() recomputed cutneigh/dtforce with LJ rules; fix them up:
    params.cutneigh = params.cutforce + 1.0  # eam_utils.c:31
    params.dtforce = 0.5 * params.dt / params.mass  # eam_utils.c:36
    return params
