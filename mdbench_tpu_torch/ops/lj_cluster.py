"""Lennard-Jones forces of the cluster scheme.

Two kernel wrappers, each beside its plain torch version:

- `lj_cluster_force_ilist`, the exact-list force: on a CUDA tensor it
  launches ``csrc/lj_cluster_ilist.cu`` (the port of the TPU kernel
  ``mdbench_tpu/ops/pallas/lj_cluster.py::_kernel_ilist``), on a CPU
  tensor it runs `lj_cluster_force_ilist_ref`;
- `lj_cluster_force_stream`, the group-window force over group-shared
  j16 lists and per-member tile windows: on a CUDA tensor it launches
  ``csrc/lj_cluster_stream.cu`` (the port of ``_kernel_stream``), on a
  CPU tensor it runs `lj_cluster_force_group_ref` with the windows.

Any other device raises; nothing falls back from a kernel to its plain
version. `lj_cluster_force_group_ref` without windows and the Newton
half-list force `lj_cluster_force_half_ref` are torch ops on any device,
as their counterparts are XLA ops on every backend in mdbench_tpu.
"""

from __future__ import annotations

import torch

from mdbench_tpu_torch import _build

# kernel launches made by lj_cluster_force_ilist (a run's proof that it
# went through the CUDA kernel); callers may reset it to 0
LAUNCHES = 0
# the same for lj_cluster_force_stream
STREAM_LAUNCHES = 0

GROUP = 16  # i-clusters per group list (the stream kernel's block)
TILE_ATOMS = 128  # j atoms per window tile (8 j16)


def lj_cluster_force_ilist_ref(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    ijlist,  # (n_units, icap) int — exact per-i-unit j16 ids
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
):
    """Plain torch version: the literal twin of mdbench_tpu's
    `lj_cluster_force_xla_ilist` (untyped). Every listed j16 of unit u
    (share consecutive i-clusters) interacts with all of the unit's
    i-atoms; sentinel ids contribute exactly 0. Returns (fx, fy, fz),
    each (n_clusters_pad, 8)."""
    nu, icap = ijlist.shape
    if nu * share != n_clusters_pad:
        raise ValueError("ijlist rows * share must equal n_clusters_pad")
    cjn = xc.shape[0] // 2
    jl = ijlist.long()

    def planes(p):
        pj = p.reshape(cjn, 16)[jl].reshape(nu, 1, icap * 16)
        pi = p[:n_clusters_pad].reshape(nu, share * 8, 1)
        return pi - pj

    dx, dy, dz = planes(xc), planes(yc), planes(zc)
    rsq = dx * dx + dy * dy + dz * dz
    mask = (rsq < cutforcesq) & (rsq > 0.0)
    rs = torch.where(mask, rsq, 1.0)
    sr2 = 1.0 / rs
    sr6 = sr2 * sr2 * sr2 * sigma6
    gf = torch.where(mask, 48.0 * epsilon * sr6 * (sr6 - 0.5) * sr2, 0.0)
    return tuple(
        (d * gf).sum(2).reshape(n_clusters_pad, 8) for d in (dx, dy, dz)
    )


def _check_planes(xc, yc, zc, *others):
    """The coordinate planes every kernel takes, and that `others` lie on
    their device."""
    planes = (xc, yc, zc)
    dev = xc.device
    if any(t.device != dev for t in (*planes, *others)):
        raise ValueError("all operands must be on one CUDA device")
    if xc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"coordinate planes must be float32/float64, got {xc.dtype}")
    for t in planes:
        if t.dtype != xc.dtype or t.shape != xc.shape or not t.is_contiguous():
            raise ValueError("xc, yc, zc must be contiguous planes of one dtype and shape")
    if xc.dim() != 2 or xc.shape[1] != 8 or xc.shape[0] % 2:
        raise ValueError(f"planes must be (C_total, 8) with C_total even, got {tuple(xc.shape)}")


def _check_cuda_args(xc, yc, zc, ijlist, nji, n_clusters_pad, share):
    _check_planes(xc, yc, zc, ijlist, nji)
    if ijlist.dtype != torch.int32 or nji.dtype != torch.int32:
        raise TypeError("ijlist and nji must be int32")
    if not (ijlist.is_contiguous() and nji.is_contiguous()):
        raise ValueError("ijlist and nji must be contiguous")
    if share not in (1, 2, 4):
        raise ValueError(f"share must be 1, 2 or 4, got {share}")
    if ijlist.dim() != 2 or nji.shape != (ijlist.shape[0],):
        raise ValueError("ijlist must be (n_units, icap) and nji (n_units,)")
    if ijlist.shape[0] * share != n_clusters_pad or n_clusters_pad > xc.shape[0]:
        raise ValueError("n_units * share must equal n_clusters_pad <= C_total")


def lj_cluster_force_ilist(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    ijlist,  # (n_units, icap) int32 exact per-i-unit j16 ids
    nji,  # (n_units,) int32 list lengths
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
):
    """Exact-list LJ force, (fx, fy, fz) each (n_clusters_pad, 8).

    CPU tensors take the plain version. CUDA tensors launch the CUDA
    kernel on the current stream (built from csrc/ at first use): the
    operands are checked first and a launch error raises. Entries of a
    unit's list past nji[u] are not read on the card; the list must
    hold the sentinel j16 id there, as derive_ilists writes it."""
    global LAUNCHES
    if xc.device.type == "cpu":
        return lj_cluster_force_ilist_ref(
            xc, yc, zc, ijlist, n_clusters_pad, cutforcesq, sigma6, epsilon,
            share,
        )
    if xc.device.type != "cuda":
        raise ValueError(f"no force kernel for device {xc.device}")
    _check_cuda_args(xc, yc, zc, ijlist, nji, n_clusters_pad, share)
    lib = _build.load()
    fn = lib.lj_cluster_ilist_f32 if xc.dtype == torch.float32 else lib.lj_cluster_ilist_f64
    out = [torch.empty((n_clusters_pad, 8), dtype=xc.dtype, device=xc.device)
           for _ in range(3)]
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), ijlist.data_ptr(),
            nji.data_ptr(), *(o.data_ptr() for o in out),
            ijlist.shape[0], ijlist.shape[1], share,
            float(cutforcesq), float(sigma6), float(epsilon), stream,
        )
    if err != 0:
        raise RuntimeError(f"lj_cluster_ilist launch failed: CUDA error {err}")
    LAUNCHES += 1
    return tuple(out)


def _group_chunks(ng: int, gm: int, width: int, max_elems: int):
    """Group slices whose (groups, gm i-atoms, width) pair block stays
    under max_elems elements."""
    step = max(1, max_elems // (gm * width))
    return [slice(g0, min(g0 + step, ng)) for g0 in range(0, ng, step)]


def _lj_pairs(xc, yc, zc, jl, rows, cutforcesq, sigma6, epsilon, extra=None):
    """(dx, dy, dz, gf) of every (i-atom, listed j-atom) pair of the
    groups whose i-atoms are the flat rows `rows` (c, gm) and whose j16
    lists are `jl` (c, L): each (c, gm, L*16); gf is 0 outside
    0 < rsq < cutforcesq and outside `extra` (a bool mask), selected,
    never multiplied by a mask."""
    c, L = jl.shape
    cjn = xc.shape[0] // 2

    def diff(p):
        return (p.reshape(-1)[rows][:, :, None]
                - p.reshape(cjn, 16)[jl].reshape(c, 1, L * 16))

    dx, dy, dz = diff(xc), diff(yc), diff(zc)
    rsq = dx * dx + dy * dy + dz * dz
    mask = (rsq < cutforcesq) & (rsq > 0.0)
    if extra is not None:
        mask = mask & extra
    rs = torch.where(mask, rsq, 1.0)
    sr2 = 1.0 / rs
    sr6 = sr2 * sr2 * sr2 * sigma6
    gf = torch.where(mask, 48.0 * epsilon * sr6 * (sr6 - 0.5) * sr2, 0.0)
    return dx, dy, dz, gf


def lj_cluster_force_group_ref(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    jlist,  # (NG, L) int j16 ids, group-shared
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    ranges=None,  # (NG, 2*group+1) int tile windows, or None
    max_elems: int = 1 << 25,
):
    """Plain torch group-list force. Without `ranges` it is the twin of
    mdbench_tpu's `lj_cluster_force_xla`: every i-atom of group g meets
    every atom of every j16 in row g of `jlist`. With `ranges` it is the
    twin of the stream kernel: the atoms of tile s (list entries
    8s..8s+7) count for member m only if start[m] <= s < end[m] and
    s < njg. Sentinel j16 and entries past nj contribute exactly 0
    through the cutoff. Groups run in chunks of at most `max_elems`
    pair elements. Returns (fx, fy, fz), each (n_clusters_pad, 8)."""
    ng, L = jlist.shape
    group = n_clusters_pad // ng
    if ng * group != n_clusters_pad:
        raise ValueError("jlist rows must divide n_clusters_pad")
    if ranges is not None and tuple(ranges.shape) != (ng, 2 * group + 1):
        raise ValueError(f"ranges must be ({ng}, {2 * group + 1})")
    dev = xc.device
    gm = group * 8
    jl_all = jlist.long()
    out = [torch.empty((ng, gm), dtype=xc.dtype, device=dev)
           for _ in range(3)]
    if ranges is not None:
        tile = (torch.arange(L * 16, device=dev) // TILE_ATOMS)[None, None, :]
        member = torch.arange(gm, device=dev) // 8
    for sl in _group_chunks(ng, gm, L * 16, max_elems):
        rows = (torch.arange(sl.start, sl.stop, device=dev)[:, None] * gm
                + torch.arange(gm, device=dev)[None, :])
        extra = None
        if ranges is not None:
            rg = ranges[sl].long()
            start = rg[:, member][:, :, None]
            end = rg[:, group + member][:, :, None]
            extra = ((tile >= start) & (tile < end)
                     & (tile < rg[:, 2 * group, None, None]))
        dx, dy, dz, gf = _lj_pairs(xc, yc, zc, jl_all[sl], rows, cutforcesq,
                                   sigma6, epsilon, extra)
        for o, d in zip(out, (dx, dy, dz)):
            o[sl] = (d * gf).sum(2)
    return tuple(o.reshape(n_clusters_pad, 8) for o in out)


def lj_cluster_force_half_ref(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    jlist,  # (NG, L) int j16 ids, group-shared
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    max_elems: int = 1 << 25,
):
    """Newton half-list force, the twin of mdbench_tpu's
    `lj_cluster_force_xla_half` (reference half_neigh, clusterpair/
    force_lj.c:167-431). In the flat slot ids i -> g*128 + k and
    j -> c*16 + l, a pair with a local j (gid_j < n_clusters_pad*8) is
    computed once, from the side with the smaller id (gid_j > gid_i); a
    pair with a ghost j is computed from the local side only. The
    reaction forces fold back onto the local j16 rows with index_add_,
    which on a CUDA tensor sums with atomics in an order that changes
    from run to run. Returns (fx, fy, fz), each (n_clusters_pad, 8)."""
    ng, L = jlist.shape
    group = n_clusters_pad // ng
    if ng * group != n_clusters_pad:
        raise ValueError("jlist rows must divide n_clusters_pad")
    dev = xc.device
    gm = group * 8
    cjn = xc.shape[0] // 2
    jl_all = jlist.long()
    fi = [torch.empty((ng, gm), dtype=xc.dtype, device=dev)
          for _ in range(3)]
    fj16 = [torch.zeros((cjn, 16), dtype=xc.dtype, device=dev)
            for _ in range(3)]
    slot = torch.arange(16, device=dev)
    for sl in _group_chunks(ng, gm, L * 16, max_elems):
        jl = jl_all[sl]
        c = jl.shape[0]
        rows = (torch.arange(sl.start, sl.stop, device=dev)[:, None] * gm
                + torch.arange(gm, device=dev)[None, :])
        gid_j = (jl[:, :, None] * 16 + slot).reshape(c, 1, L * 16)
        local_j = gid_j < n_clusters_pad * 8
        half = ~local_j | (gid_j > rows[:, :, None])
        dx, dy, dz, gf = _lj_pairs(xc, yc, zc, jl, rows, cutforcesq, sigma6,
                                   epsilon, half)
        for o, f16, d in zip(fi, fj16, (dx, dy, dz)):
            fd = d * gf
            o[sl] = fd.sum(2)
            fj = torch.where(local_j, fd.sum(1, keepdim=True), 0.0)
            f16.index_add_(0, jl.reshape(-1), -fj.reshape(c * L, 16))
    return tuple(
        o.reshape(n_clusters_pad, 8) + f16.reshape(2 * cjn, 8)[:n_clusters_pad]
        for o, f16 in zip(fi, fj16)
    )


def _check_stream_args(xc, yc, zc, jlist, ranges, n_clusters_pad):
    _check_planes(xc, yc, zc, jlist, ranges)
    if jlist.dtype != torch.int32 or ranges.dtype != torch.int32:
        raise TypeError("jlist and ranges must be int32")
    if not (jlist.is_contiguous() and ranges.is_contiguous()):
        raise ValueError("jlist and ranges must be contiguous")
    if jlist.dim() != 2 or jlist.shape[1] % 8 or jlist.shape[1] == 0:
        raise ValueError("jlist must be (NG, L) with L a positive multiple of 8")
    if ranges.shape != (jlist.shape[0], 2 * GROUP + 1):
        raise ValueError(f"ranges must be (NG, {2 * GROUP + 1})")
    if jlist.shape[0] * GROUP != n_clusters_pad or n_clusters_pad > xc.shape[0]:
        raise ValueError(f"NG * {GROUP} must equal n_clusters_pad <= C_total")


def lj_cluster_force_stream(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    jlist,  # (NG, L) int32 group-shared j16 ids, L a multiple of 8
    ranges,  # (NG, 33) int32 tile windows [start x16, end x16, njg]
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
):
    """Group-window LJ force, (fx, fy, fz) each (n_clusters_pad, 8).

    CPU tensors take the plain version (`lj_cluster_force_group_ref` with
    the windows). CUDA tensors launch the CUDA kernel on the current
    stream (built from csrc/ at first use) after the operands are
    checked; a launch error raises. Every j16 id of a tile below njg is
    read, entries past nj included: they must be valid rows (a real j16,
    more than cutneigh from the whole group, or the sentinel j16)."""
    global STREAM_LAUNCHES
    if xc.device.type == "cpu":
        return lj_cluster_force_group_ref(
            xc, yc, zc, jlist, n_clusters_pad, cutforcesq, sigma6, epsilon,
            ranges=ranges,
        )
    if xc.device.type != "cuda":
        raise ValueError(f"no force kernel for device {xc.device}")
    _check_stream_args(xc, yc, zc, jlist, ranges, n_clusters_pad)
    lib = _build.load()
    fn = (lib.lj_cluster_stream_f32 if xc.dtype == torch.float32
          else lib.lj_cluster_stream_f64)
    out = [torch.empty((n_clusters_pad, 8), dtype=xc.dtype, device=xc.device)
           for _ in range(3)]
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), jlist.data_ptr(),
            ranges.data_ptr(), *(o.data_ptr() for o in out),
            jlist.shape[0], jlist.shape[1],
            float(cutforcesq), float(sigma6), float(epsilon), stream,
        )
    if err != 0:
        raise RuntimeError(f"lj_cluster_stream launch failed: CUDA error {err}")
    STREAM_LAUNCHES += 1
    return tuple(out)
