"""EAM force on the cluster scheme's exact unit lists: two passes with a
ghost-fp refresh between them (the port of ``mdbench_tpu.ops.eam_cluster``
and of the TPU kernels in ``mdbench_tpu/ops/pallas/eam_cluster.py``).

Pass 1: rho_i = sum_j dens(r_ij); fp_i = F'(rho_i) from the exact
        per-atom frho spline, into a (C_total, 8) fp plane whose ghost
        rows are left at 0 (`eam_cluster_density`).
Ghost:  the fp rows of ghost j16 are copied from their owners through
        the halo's border map (`_fp_ghost_refresh`; no shift: fp is
        translation invariant). A domain engine fills them by its own
        exchange instead, after pass 1 has run on every domain.
Pass 2: fpair = -((fp_i + fp_j) g1(r) + g2(r)); f_i += d_ij fpair
        (`eam_cluster_pair_forces`).

dens, g1 and g2 are the degree-16 polynomials of `models.eam_tables.
fit_eam_poly` in t = clip((r - mid) iscale, -1, 1), so no pass reads a
table per pair.

`eam_cluster_force` is the single-device composition the engine calls:
pass 1, the refresh, pass 2. On a CUDA tensor the passes launch the
hand-written kernels of ``csrc/eam_cluster.cu`` (`eam_rho_ilist`,
`eam_force_ilist`; with capacity buckets their bucketed forms
`eam_rho_buckets`, `eam_force_buckets`) and the frho spline and the ghost
refresh run as torch ops between them on the same stream; on a CPU
tensor every part runs its plain version (the `_ref` functions). Nothing
falls back from one to the other.
"""

from __future__ import annotations

import torch

from mdbench_tpu_torch import _build
# N_COEF and the scalar block (_coefs) are shared with the verlet EAM kernels
from mdbench_tpu_torch.ops.eam import N_COEF, EamDevice, _grid_index, _horner  # noqa: F401
from mdbench_tpu_torch.ops.eam import poly_coefs as _coefs
from mdbench_tpu_torch.ops.lj_cluster import (
    _check_bucket_args,
    _check_cuda_args,
    _group_chunks,
    ilist_rows,
    ilist_sweep_pairs,
    per_bucket,
    scatter_rows,
    sweep_sum,
)

# kernel launches made by the wrappers, by kernel (a run's proof that it
# went through the CUDA kernels); callers may reset them to 0
LAUNCHES = {"eam_rho_ilist": 0, "eam_force_ilist": 0,
            "eam_rho_buckets": 0, "eam_force_buckets": 0}


def _pair_geometry(xc, yc, zc, ijlist, n_clusters_pad, cutforcesq, poly,
                   share, xi=None):
    """(dx, dy, dz, mask, t) of every (i-atom, listed j-atom) pair:
    dx, dy, dz and mask (0 < rsq < cutforcesq) are (n_units, share*8,
    icap*16), as mdbench_tpu's XLA twin forms them; t holds the mapped
    distance of the pairs in `mask` only, in mask order (the polynomials
    are evaluated there alone: the twin's where(mask, p(t), 0) has the same
    values). `xi` (three (n_clusters_pad, 8) planes) replaces the i-side
    rows, the first n_clusters_pad rows of xc, yc, zc by default."""
    nu, icap = ijlist.shape
    if nu * share != n_clusters_pad:
        raise ValueError("ijlist rows * share must equal n_clusters_pad")
    cjn = xc.shape[0] // 2
    jl = ijlist.long()
    if xi is None:
        xi = tuple(p[:n_clusters_pad] for p in (xc, yc, zc))

    def diff(p, p_i):
        pj = p.reshape(cjn, 16)[jl].reshape(nu, 1, icap * 16)
        return p_i.reshape(nu, share * 8, 1) - pj

    dx, dy, dz = (diff(p, p_i) for p, p_i in zip((xc, yc, zc), xi))
    rsq = dx * dx + dy * dy + dz * dz
    mask = (rsq < cutforcesq) & (rsq > 0.0)
    r = torch.sqrt(rsq[mask])
    t = torch.clamp((r - float(poly.mid)) * float(poly.iscale), -1.0, 1.0)
    return dx, dy, dz, mask, t


def eam_rho_ilist_ref(xc, yc, zc, ijlist, n_clusters_pad: int,
                      cutforcesq: float, poly, share: int = 2, xi=None):
    """Plain torch pass 1: rho (n_clusters_pad, 8), the sum of dens(r)
    over every listed j atom with 0 < rsq < cutforcesq (i-side rows `xi`
    as in _pair_geometry)."""
    dx, _, _, mask, t = _pair_geometry(
        xc, yc, zc, ijlist, n_clusters_pad, cutforcesq, poly, share, xi)
    dens = torch.zeros_like(dx)
    dens[mask] = _horner(poly.dens, t)
    return dens.sum(2).reshape(n_clusters_pad, 8)


def eam_force_ilist_ref(xc, yc, zc, fp_plane, ijlist, n_clusters_pad: int,
                        cutforcesq: float, poly, share: int = 2, xi=None,
                        fpi=None):
    """Plain torch pass 2: (fx, fy, fz), each (n_clusters_pad, 8). fp_i is
    `fpi`, by default fp_plane[:n_clusters_pad]; fp_j is read from
    fp_plane's rows of the listed j16, ghost rows included (i-side rows
    `xi` as in _pair_geometry)."""
    nu, icap = ijlist.shape
    dx, dy, dz, mask, t = _pair_geometry(
        xc, yc, zc, ijlist, n_clusters_pad, cutforcesq, poly, share, xi)
    cjn = fp_plane.shape[0] // 2
    fpj = fp_plane.reshape(cjn, 16)[ijlist.long()].reshape(nu, 1, icap * 16)
    if fpi is None:
        fpi = fp_plane[:n_clusters_pad]
    fpi = fpi.reshape(nu, share * 8, 1)
    fpair = torch.zeros_like(dx)
    fpair[mask] = -((fpi + fpj)[mask] * _horner(poly.g1, t)
                    + _horner(poly.g2, t))
    return tuple(
        (d * fpair).sum(2).reshape(n_clusters_pad, 8) for d in (dx, dy, dz)
    )


def _fp_ghost_refresh(fp_plane, border_map, n_clusters_pad: int):
    """Fill the ghost rows of the (C_total, 8) fp plane from their owner
    rows (rows 2*border_map + {0, 1}), IN PLACE; owners are local or
    sentinel rows, never ghost rows. Returns fp_plane."""
    g0 = n_clusters_pad
    row_map = (
        2 * border_map[:, None]
        + torch.arange(2, device=border_map.device)[None, :]
    ).reshape(-1)
    fp_plane[g0 : g0 + row_map.shape[0]] = fp_plane[row_map]
    return fp_plane


def fp_plane_from_rho(rho, eam: EamDevice, border_map, c_total: int):
    """fp = F'(rho) per local atom from the frho spline, into a zeroed
    (c_total, 8) plane; its ghost rows are then filled from their owners
    through `border_map`, or left at 0 when `border_map` is None (for the
    caller to fill)."""
    mf, pf = _grid_index(rho, eam.rdrho, eam.nrho)
    fs = eam.frho[mf]  # (npad, 8, 7)
    fp_local = (fs[..., 0] * pf + fs[..., 1]) * pf + fs[..., 2]
    npad = rho.shape[0]
    fp_plane = torch.zeros((c_total, 8), dtype=rho.dtype, device=rho.device)
    fp_plane[:npad] = fp_local
    if border_map is None:
        return fp_plane
    return _fp_ghost_refresh(fp_plane, border_map, npad)


def eam_rho_buckets_ref(xc, yc, zc, bijlist, bcrows, binv, n_clusters_pad: int,
                        cutforcesq: float, poly, buckets, share: int = 2):
    """Plain torch bucketed pass 1 (mdbench_tpu's run_pass of
    eam_cluster_force_pallas with buckets): rho (n_clusters_pad, 8)."""
    xi = [p[bcrows.long()] for p in (xc, yc, zc)]
    (rho,) = per_bucket(
        1, bijlist, binv, buckets, share, xc,
        lambda jl, n, r0, r1: (eam_rho_ilist_ref(
            xc, yc, zc, jl, n, cutforcesq, poly, share,
            xi=tuple(p[r0:r1] for p in xi)),))
    return rho


def eam_force_buckets_ref(xc, yc, zc, fp_plane, bijlist, bcrows, binv,
                          n_clusters_pad: int, cutforcesq: float, poly, buckets,
                          share: int = 2):
    """Plain torch bucketed pass 2, fp_i = fp_plane[bcrows] as in
    mdbench_tpu: (fx, fy, fz), each (n_clusters_pad, 8)."""
    rows = bcrows.long()
    xi = [p[rows] for p in (xc, yc, zc)]
    fpi = fp_plane[rows]
    return per_bucket(
        3, bijlist, binv, buckets, share, xc,
        lambda jl, n, r0, r1: eam_force_ilist_ref(
            xc, yc, zc, fp_plane, jl, n, cutforcesq, poly, share,
            xi=tuple(p[r0:r1] for p in xi), fpi=fpi[r0:r1]))


def eam_cluster_density_ref(xc, yc, zc, ijlist, n_clusters_pad: int,
                            cutforcesq: float, eam: EamDevice, poly,
                            share: int = 2, buckets=None, bpairs=None):
    """Plain torch pass 1 and the frho spline: the (C_total, 8) fp plane,
    ghost rows 0. With `buckets` (sizes, caps) and `bpairs` (bijlist,
    bcrows, binv) the density runs bucketed, as mdbench_tpu's
    `eam_cluster_force_pallas` does with them."""
    if buckets is not None:
        rho = eam_rho_buckets_ref(xc, yc, zc, *bpairs, n_clusters_pad,
                                  cutforcesq, poly, buckets, share)
    else:
        rho = eam_rho_ilist_ref(xc, yc, zc, ijlist, n_clusters_pad,
                                cutforcesq, poly, share)
    return fp_plane_from_rho(rho, eam, None, xc.shape[0])


def eam_cluster_pair_forces_ref(xc, yc, zc, fp_plane, ijlist,
                                n_clusters_pad: int, cutforcesq: float, poly,
                                share: int = 2, buckets=None, bpairs=None):
    """Plain torch pass 2 from an fp plane whose ghost rows are filled:
    (fx, fy, fz), each (n_clusters_pad, 8); bucketed as
    `eam_cluster_density_ref`."""
    if buckets is not None:
        return eam_force_buckets_ref(xc, yc, zc, fp_plane, *bpairs,
                                     n_clusters_pad, cutforcesq, poly, buckets,
                                     share)
    return eam_force_ilist_ref(xc, yc, zc, fp_plane, ijlist, n_clusters_pad,
                               cutforcesq, poly, share)


def eam_cluster_force_ref(xc, yc, zc, ijlist, border_map,
                          n_clusters_pad: int, cutforcesq: float,
                          eam: EamDevice, poly, share: int = 2,
                          buckets=None, bpairs=None):
    """Plain torch cluster EAM force, the literal twin of mdbench_tpu's
    `eam_cluster_force_xla`: `eam_cluster_density_ref`, the ghost refresh
    through `border_map`, `eam_cluster_pair_forces_ref`. Returns (fx, fy,
    fz, fp_plane)."""
    fp_plane = eam_cluster_density_ref(xc, yc, zc, ijlist, n_clusters_pad,
                                       cutforcesq, eam, poly, share, buckets,
                                       bpairs)
    _fp_ghost_refresh(fp_plane, border_map, n_clusters_pad)
    fx, fy, fz = eam_cluster_pair_forces_ref(
        xc, yc, zc, fp_plane, ijlist, n_clusters_pad, cutforcesq, poly, share,
        buckets, bpairs)
    return fx, fy, fz, fp_plane


def eam_sweep_ref(xc, yc, zc, ijlist, nji, n_clusters_pad: int,
                  cutforcesq: float, poly, share: int = 2, fp_plane=None,
                  buckets=None, max_elems: int = 1 << 24):
    """Plain mirror of the EAM kernels' two sweeps (tests only; the
    wrappers never call it): the pass-1 density (fp_plane None) or the
    pass-2 force, per i-atom over the pairs sweep A marks
    (`ops/lj_cluster.ilist_sweep_pairs`), each pair's value as the plain
    version forms it, summed one pair at a time in list order
    (`sweep_sum`), reading min(nji, cap) entries of each list;
    `buckets` (plan, bcrows) as in `ops/lj_cluster.ilist_rows`. Returns (rho,) or (fx, fy, fz),
    each (n_clusters_pad, 8)."""
    units, n = ilist_rows(ijlist, nji, share, buckets)
    force = fp_plane is not None
    sums = [[] for _ in range(3 if force else 1)]
    for sl in _group_chunks(ijlist.shape[0], share * 8, ijlist.shape[1] * 16,
                            max_elems):
        sp = ilist_sweep_pairs(xc, yc, zc, ijlist, units, n, share, cutforcesq,
                               sl, extra=fp_plane)
        r = torch.sqrt(torch.where(sp.inside, sp.rsq, 1.0))
        t = torch.clamp((r - float(poly.mid)) * float(poly.iscale), -1.0, 1.0)
        if force:
            fpair = -((sp.vi + sp.vj) * _horner(poly.g1, t) + _horner(poly.g2, t))
            vals = (sp.dx * fpair, sp.dy * fpair, sp.dz * fpair)
        else:
            vals = (_horner(poly.dens, t),)
        for acc, g in zip(sums, vals):
            acc.append(sweep_sum(g, sp.inside))
    return tuple(scatter_rows(torch.cat(a), units, n_clusters_pad, share)
                 for a in sums)


def _check_fp_plane(fp_plane, xc):
    if (fp_plane.device != xc.device or fp_plane.dtype != xc.dtype
            or fp_plane.shape != xc.shape or not fp_plane.is_contiguous()):
        raise ValueError(
            "fp_plane must be a contiguous plane of the coordinates' "
            "device, dtype and shape")


def _launch(name, xc, args, n_outputs, n_out, scalars):
    """Launch kernel `name` (f32 or f64 entry point by xc's dtype) on the
    current stream with `args` (tensors), its outputs (each (n_out, 8)),
    then `scalars` (ints and host pointers); returns the outputs. Raises
    on a launch error."""
    lib = _build.load()
    fn = getattr(lib, f"{name}_{'f32' if xc.dtype == torch.float32 else 'f64'}")
    out = [torch.empty((n_out, 8), dtype=xc.dtype, device=xc.device)
           for _ in range(n_outputs)]
    with torch.cuda.device(xc.device):
        err = fn(
            *(t.data_ptr() for t in args), *(o.data_ptr() for o in out),
            *scalars, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _flat_scalars(ijlist, share, coefs):
    return (ijlist.shape[0], ijlist.shape[1], share, coefs.ctypes.data)


def eam_rho_ilist(xc, yc, zc, ijlist, nji, n_clusters_pad: int,
                  cutforcesq: float, poly, share: int = 2):
    """Pass 1, rho (n_clusters_pad, 8). CPU tensors take the plain
    version; CUDA tensors launch the kernel (built from csrc/ at first
    use) after the operands are checked. Entries of a unit's list past
    nji[u] are not read on the card and must hold the sentinel j16 id."""
    if xc.device.type == "cpu":
        return eam_rho_ilist_ref(xc, yc, zc, ijlist, n_clusters_pad,
                                 cutforcesq, poly, share)
    if xc.device.type != "cuda":
        raise ValueError(f"no EAM kernel for device {xc.device}")
    _check_cuda_args(xc, yc, zc, ijlist, nji, n_clusters_pad, share)
    coefs = _coefs(poly, cutforcesq)
    (rho,) = _launch("eam_rho_ilist", xc, (xc, yc, zc, ijlist, nji), 1,
                     n_clusters_pad, _flat_scalars(ijlist, share, coefs))
    return rho


def eam_force_ilist(xc, yc, zc, fp_plane, ijlist, nji, n_clusters_pad: int,
                    cutforcesq: float, poly, share: int = 2):
    """Pass 2, (fx, fy, fz) each (n_clusters_pad, 8); the same device
    rule and list contract as `eam_rho_ilist`."""
    if xc.device.type == "cpu":
        return eam_force_ilist_ref(xc, yc, zc, fp_plane, ijlist,
                                   n_clusters_pad, cutforcesq, poly, share)
    if xc.device.type != "cuda":
        raise ValueError(f"no EAM kernel for device {xc.device}")
    _check_cuda_args(xc, yc, zc, ijlist, nji, n_clusters_pad, share)
    _check_fp_plane(fp_plane, xc)
    coefs = _coefs(poly, cutforcesq)
    return tuple(_launch("eam_force_ilist", xc,
                         (xc, yc, zc, fp_plane, ijlist, nji), 3,
                         n_clusters_pad, _flat_scalars(ijlist, share, coefs)))


def _bucket_scalars(bijlist, nji, share, table, coefs):
    ends, caps = table
    return (bijlist.shape[0], bijlist.shape[1], nji.shape[0], share, len(ends),
            ends.ctypes.data, caps.ctypes.data, coefs.ctypes.data)


def eam_rho_buckets(xc, yc, zc, bijlist, bcrows, binv, nji,
                    n_clusters_pad: int, cutforcesq: float, poly, buckets,
                    share: int = 2):
    """Bucketed pass 1 (K2b), rho (n_clusters_pad, 8), from the bucket
    maps of ops/cluster.py. CPU tensors take `eam_rho_buckets_ref`; CUDA
    tensors launch the bucketed density kernel once, after the operands
    are checked (the list contract of `lj_cluster_force_buckets`: binv is
    not read on the card, bcrows holds every unit once)."""
    if xc.device.type == "cpu":
        return eam_rho_buckets_ref(xc, yc, zc, bijlist, bcrows, binv,
                                   n_clusters_pad, cutforcesq, poly, buckets,
                                   share)
    if xc.device.type != "cuda":
        raise ValueError(f"no EAM kernel for device {xc.device}")
    table = _check_bucket_args(xc, yc, zc, bijlist, bcrows, binv, nji,
                               n_clusters_pad, buckets, share)
    coefs = _coefs(poly, cutforcesq)
    (rho,) = _launch("eam_rho_buckets", xc, (xc, yc, zc, bijlist, bcrows, nji),
                     1, n_clusters_pad,
                     _bucket_scalars(bijlist, nji, share, table, coefs))
    return rho


def eam_force_buckets(xc, yc, zc, fp_plane, bijlist, bcrows, binv, nji,
                      n_clusters_pad: int, cutforcesq: float, poly, buckets,
                      share: int = 2):
    """Bucketed pass 2 (K3b), (fx, fy, fz) each (n_clusters_pad, 8); fp_i
    is each unit's own rows of fp_plane. The device rule and contract of
    `eam_rho_buckets`."""
    if xc.device.type == "cpu":
        return eam_force_buckets_ref(xc, yc, zc, fp_plane, bijlist, bcrows,
                                     binv, n_clusters_pad, cutforcesq, poly,
                                     buckets, share)
    if xc.device.type != "cuda":
        raise ValueError(f"no EAM kernel for device {xc.device}")
    table = _check_bucket_args(xc, yc, zc, bijlist, bcrows, binv, nji,
                               n_clusters_pad, buckets, share)
    _check_fp_plane(fp_plane, xc)
    coefs = _coefs(poly, cutforcesq)
    return tuple(_launch(
        "eam_force_buckets", xc, (xc, yc, zc, fp_plane, bijlist, bcrows, nji), 3,
        n_clusters_pad, _bucket_scalars(bijlist, nji, share, table, coefs)))


def eam_cluster_density(xc, yc, zc, ijlist, nji, n_clusters_pad: int,
                        cutforcesq: float, eam: EamDevice, poly,
                        share: int = 2, buckets=None, bpairs=None):
    """Pass 1 and the frho spline, the contract of
    `eam_cluster_density_ref` (ghost rows 0). On a CPU tensor it is the
    plain version; on a CUDA tensor the density kernel (K2, or K2b with
    `buckets` and `bpairs`), then the spline as torch ops on the current
    stream. Other devices raise ValueError."""
    if xc.device.type == "cpu":
        return eam_cluster_density_ref(xc, yc, zc, ijlist, n_clusters_pad,
                                       cutforcesq, eam, poly, share, buckets,
                                       bpairs)
    if buckets is not None:
        rho = eam_rho_buckets(xc, yc, zc, *bpairs, nji, n_clusters_pad,
                              cutforcesq, poly, buckets, share)
    else:
        rho = eam_rho_ilist(xc, yc, zc, ijlist, nji, n_clusters_pad,
                            cutforcesq, poly, share)
    return fp_plane_from_rho(rho, eam, None, xc.shape[0])


def eam_cluster_pair_forces(xc, yc, zc, fp_plane, ijlist, nji,
                            n_clusters_pad: int, cutforcesq: float, poly,
                            share: int = 2, buckets=None, bpairs=None):
    """Pass 2, the contract of `eam_cluster_pair_forces_ref`: on a CUDA
    tensor the force kernel (K3, or K3b with `buckets` and `bpairs`)."""
    if xc.device.type == "cpu":
        return eam_cluster_pair_forces_ref(xc, yc, zc, fp_plane, ijlist,
                                           n_clusters_pad, cutforcesq, poly,
                                           share, buckets, bpairs)
    if buckets is not None:
        return eam_force_buckets(xc, yc, zc, fp_plane, *bpairs, nji,
                                 n_clusters_pad, cutforcesq, poly, buckets,
                                 share)
    return eam_force_ilist(xc, yc, zc, fp_plane, ijlist, nji, n_clusters_pad,
                           cutforcesq, poly, share)


def eam_cluster_force(xc, yc, zc, ijlist, nji, border_map,
                      n_clusters_pad: int, cutforcesq: float,
                      eam: EamDevice, poly, share: int = 2,
                      buckets=None, bpairs=None):
    """Cluster EAM force on one device, (fx, fy, fz, fp_plane):
    `eam_cluster_density`, the ghost refresh through `border_map` (torch
    ops on the current stream, so it precedes pass 2 there),
    `eam_cluster_pair_forces`; the contract of `eam_cluster_force_ref`."""
    fp_plane = eam_cluster_density(xc, yc, zc, ijlist, nji, n_clusters_pad,
                                   cutforcesq, eam, poly, share, buckets, bpairs)
    _fp_ghost_refresh(fp_plane, border_map, n_clusters_pad)
    fx, fy, fz = eam_cluster_pair_forces(xc, yc, zc, fp_plane, ijlist, nji,
                                         n_clusters_pad, cutforcesq, poly, share,
                                         buckets, bpairs)
    return fx, fy, fz, fp_plane
