"""Lennard-Jones forces of the cluster scheme.

Three kernel wrappers, each beside its plain torch version:

- `lj_cluster_force_ilist`, the exact-list force: on a CUDA tensor it
  launches ``csrc/lj_cluster_ilist.cu`` (the port of the TPU kernel
  ``mdbench_tpu/ops/pallas/lj_cluster.py::_kernel_ilist``), on a CPU
  tensor it runs `lj_cluster_force_ilist_ref`;
- `lj_cluster_force_buckets`, the same force over capacity buckets (units
  in nji-sorted order, the maps of ``ops/cluster.bucket_maps_core``): on a
  CUDA tensor it launches the bucketed form of the same kernel (the port
  of mdbench_tpu's per-bucket calls in `_force_buckets`), on a CPU tensor
  it runs `lj_cluster_force_buckets_ref`;
- `lj_cluster_force_stream`, the group-window force over group-shared
  j16 lists and per-member tile windows: on a CUDA tensor it launches
  ``csrc/lj_cluster_stream.cu`` (the port of ``_kernel_stream``), on a
  CPU tensor it runs `lj_cluster_force_group_ref` with the windows.
  `stream_cull` and `stream_work_counts` mirror that kernel's box cull
  and count its work; only tests and chip_smoke.py call them.

The exact-list wrappers take `approx_rcp`, as mdbench_tpu's exact-list
kernel does: in float32 on the card the kernel then takes the approximate
reciprocal with one Newton step instead of a divide. Float64 and the plain
versions ignore it, as the TPU kernel does in float64 and in interpret
mode.

`lj_cluster_force_ilist_bf16` is the probe of tools/r3_bf16.py: the flat
untyped exact-list force with its pair math in bfloat16
(the bf16 form of ``csrc/lj_cluster_ilist.cu`` on a CUDA tensor,
`lj_cluster_force_ilist_bf16_ref` on a CPU tensor). No engine path runs
it; ``mdbench_tpu_torch/probes/bf16.py`` measures it.

Each force also takes a typed form (reference EXPLICIT_TYPES,
clusterpair/atom.c:78-92): `tc`, the int32 (C_total, 8) type plane of
the clusters, and `tables`, three (T, T) tensors (epsilon, sigma^6,
cutoff^2) indexed [type_i][type_j]. Every pair then takes its epsilon,
sigma^6 and cutoff^2 from the tables, with the untyped arithmetic
otherwise, so uniform tables give the untyped force. On a CUDA tensor the
typed form launches the typed instantiation of the same kernel (counted
apart from the untyped one).

Any other device raises; nothing falls back from a kernel to its plain
version. `lj_cluster_force_group_ref` without windows and the Newton
half-list force `lj_cluster_force_half_ref` are torch ops on any device,
as their counterparts are XLA ops on every backend in mdbench_tpu.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mdbench_tpu_torch import _build

# kernel launches made by lj_cluster_force_ilist (a run's proof that it
# went through the CUDA kernel); callers may reset it to 0
LAUNCHES = 0
# the same for lj_cluster_force_stream
STREAM_LAUNCHES = 0
# the same for the typed forms of the two wrappers
TYPED_LAUNCHES = 0
STREAM_TYPED_LAUNCHES = 0
# the same for lj_cluster_force_buckets (the bucketed exact-list form)
BUCKET_LAUNCHES = 0
# the same for lj_cluster_force_ilist_bf16 (the bf16 probe)
BF16_LAUNCHES = 0

GROUP = 16  # i-clusters per group list (the stream kernel's block)
TILE_ATOMS = 128  # j atoms per window tile (8 j16)
# the most atom types the typed kernels take: their blocks hold the three
# (T, T) tables in shared memory (24 KB at T = 32 in float64)
MAX_TYPES = 32
# the most capacity buckets the bucketed kernels take (csrc/unit_map.cuh)
MAX_BUCKETS = 32


def _pair_params(tables, ti, tj, like):
    """Per-pair (epsilon, sigma6, cutforcesq) = tables[k][ti][tj], with ti
    and tj broadcast against each other, in `like`'s dtype and device."""
    nt = tables[0].shape[0]
    idx = ti.long() * nt + tj.long()
    return tuple(t.to(device=like.device, dtype=like.dtype).reshape(-1)[idx]
                 for t in tables)


def _check_typed_pair(tc, tables):
    if (tc is None) != (tables is None):
        raise ValueError("tc and tables go together: both or neither")


def lj_cluster_force_ilist_ref(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    ijlist,  # (n_units, icap) int — exact per-i-unit j16 ids
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
    tc=None,  # (C_total, 8) int types, typed runs only
    tables=None,  # (eps, sig6, cutsq), each (T, T), typed runs only
    xi=None,  # (xi_x, xi_y, xi_z), each (n_clusters_pad, 8): i-side planes
):
    """Plain torch version: the literal twin of mdbench_tpu's
    `lj_cluster_force_xla_ilist`, untyped or typed. Every listed j16 of
    unit u (share consecutive i-clusters) interacts with all of the unit's
    i-atoms; sentinel ids contribute exactly 0. Typed, the scalars
    cutforcesq, sigma6 and epsilon are not read. `xi` replaces the i-side
    rows (default the first n_clusters_pad rows of xc, yc, zc) while the
    j16 rows still come from the full planes, as the `xi=` of
    `lj_cluster_force_ilist_pallas` does (untyped only). Returns (fx, fy,
    fz), each (n_clusters_pad, 8)."""
    _check_typed_pair(tc, tables)
    nu, icap = ijlist.shape
    if nu * share != n_clusters_pad:
        raise ValueError("ijlist rows * share must equal n_clusters_pad")
    if xi is not None and tables is not None:
        raise ValueError("xi is untyped only")
    cjn = xc.shape[0] // 2
    jl = ijlist.long()
    if xi is None:
        xi = tuple(p[:n_clusters_pad] for p in (xc, yc, zc))

    def planes(p, p_i):
        pj = p.reshape(cjn, 16)[jl].reshape(nu, 1, icap * 16)
        return p_i.reshape(nu, share * 8, 1) - pj

    dx, dy, dz = (planes(p, p_i) for p, p_i in zip((xc, yc, zc), xi))
    if tables is not None:
        epsilon, sigma6, cutforcesq = _pair_params(
            tables, tc[:n_clusters_pad].reshape(nu, share * 8, 1),
            tc.reshape(cjn, 16)[jl].reshape(nu, 1, icap * 16), xc)
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


def _typed_operands(xc, tc, tables):
    """Check a typed call's type plane and tables against the planes xc
    and return (T, eps, sig6, cutsq) as contiguous tensors on xc's device
    in its dtype. Tables may come as float64 CPU tensors (copied over) or
    already on the device in the planes' dtype; T is 1..MAX_TYPES."""
    if not torch.is_tensor(tc) or tc.dtype != torch.int32:
        raise TypeError("tc must be an int32 tensor")
    if tc.device != xc.device or tc.shape != xc.shape or not tc.is_contiguous():
        raise ValueError("tc must be a contiguous (C_total, 8) plane on the planes' device")
    if len(tables) != 3:
        raise ValueError("tables must be three (T, T) tensors: eps, sig6, cutsq")
    nt = tables[0].shape[0] if tables[0].dim() == 2 else 0
    out = []
    for t in tables:
        if t.dim() != 2 or tuple(t.shape) != (nt, nt):
            raise ValueError("tables must be three (T, T) tensors of one T")
        if t.device == xc.device and t.dtype == xc.dtype:
            out.append(t.contiguous())
        elif t.device.type == "cpu" and t.dtype == torch.float64:
            out.append(t.to(device=xc.device, dtype=xc.dtype).contiguous())
        else:
            raise TypeError("tables must be float64 on the host or in the planes' "
                            "dtype on their device")
    if not 1 <= nt <= MAX_TYPES:
        raise ValueError(f"the typed kernels take 1 to {MAX_TYPES} types, got {nt}")
    return (nt, *out)


def lj_cluster_force_ilist(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    ijlist,  # (n_units, icap) int32 exact per-i-unit j16 ids
    nji,  # (n_units,) int32 list lengths
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
    tc=None,  # (C_total, 8) int32 types, typed runs only
    tables=None,  # (eps, sig6, cutsq), each (T, T), typed runs only
    approx_rcp: bool = False,
):
    """Exact-list LJ force, (fx, fy, fz) each (n_clusters_pad, 8).

    CPU tensors take the plain version. CUDA tensors launch the CUDA
    kernel on the current stream (built from csrc/ at first use), its
    typed instantiation when `tc` and `tables` are given: the operands
    are checked first and a launch error raises. Entries of a unit's list
    past nji[u] are not read on the card; the list must hold the sentinel
    j16 id there, as derive_ilists writes it. `approx_rcp` takes the
    approximate reciprocal in float32 on the card (module docstring)."""
    global LAUNCHES, TYPED_LAUNCHES
    _check_typed_pair(tc, tables)
    if xc.device.type == "cpu":
        return lj_cluster_force_ilist_ref(
            xc, yc, zc, ijlist, n_clusters_pad, cutforcesq, sigma6, epsilon,
            share, tc=tc, tables=tables,
        )
    if xc.device.type != "cuda":
        raise ValueError(f"no force kernel for device {xc.device}")
    _check_cuda_args(xc, yc, zc, ijlist, nji, n_clusters_pad, share)
    lib = _build.load()
    f32 = xc.dtype == torch.float32
    out = [torch.empty((n_clusters_pad, 8), dtype=xc.dtype, device=xc.device)
           for _ in range(3)]
    if tables is not None:
        nt, *tabs = _typed_operands(xc, tc, tables)
        fn = lib.lj_cluster_ilist_typed_f32 if f32 else lib.lj_cluster_ilist_typed_f64
        with torch.cuda.device(xc.device):
            err = fn(
                xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), tc.data_ptr(),
                ijlist.data_ptr(), nji.data_ptr(), *(t.data_ptr() for t in tabs),
                *(o.data_ptr() for o in out), ijlist.shape[0], ijlist.shape[1],
                share, nt, int(bool(approx_rcp)),
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"lj_cluster_ilist_typed launch failed: CUDA error {err}")
        TYPED_LAUNCHES += 1
        return tuple(out)
    fn = lib.lj_cluster_ilist_f32 if f32 else lib.lj_cluster_ilist_f64
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), ijlist.data_ptr(),
            nji.data_ptr(), *(o.data_ptr() for o in out),
            ijlist.shape[0], ijlist.shape[1], share,
            float(cutforcesq), float(sigma6), float(epsilon),
            int(bool(approx_rcp)), stream,
        )
    if err != 0:
        raise RuntimeError(f"lj_cluster_ilist launch failed: CUDA error {err}")
    LAUNCHES += 1
    return tuple(out)


def _bf16_scalar(v: float) -> torch.Tensor:
    """v rounded to bfloat16, as a 0-dim bfloat16 tensor (the TPU probe's
    b(v))."""
    return torch.tensor(float(v), dtype=torch.float32).to(torch.bfloat16)


def lj_cluster_force_ilist_bf16_ref(
    xc, yc, zc,  # (C_total, 8) float32 coordinate planes
    ijlist,  # (n_units, icap) int exact per-i-unit j16 ids
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
):
    """Plain torch version of the bf16 probe (tools/r3_bf16.py `_kernel`),
    one rounding per operation, in its order: the distances subtracted in
    float32 and rounded to bfloat16; rsq, sr6 and gf in bfloat16; the
    cutoff mask on rsq's float32 value; sr2 the float32 reciprocal of rsq
    (1 outside the mask) rounded to bfloat16, exact, as the TPU kernel's
    approximate reciprocal is in interpret mode; the products d*gf in
    bfloat16, summed in float32. Returns (fx, fy, fz), each
    (n_clusters_pad, 8) float32."""
    if xc.dtype != torch.float32:
        raise TypeError(f"the bf16 force takes float32 planes, got {xc.dtype}")
    nu, icap = ijlist.shape
    if nu * share != n_clusters_pad:
        raise ValueError("ijlist rows * share must equal n_clusters_pad")
    bf = torch.bfloat16
    cjn = xc.shape[0] // 2
    jl = ijlist.long()

    def delta(p):
        pj = p.reshape(cjn, 16)[jl].reshape(nu, 1, icap * 16)
        return (p[:n_clusters_pad].reshape(nu, share * 8, 1) - pj).to(bf)

    dx, dy, dz = (delta(p) for p in (xc, yc, zc))
    sig_b, e48 = _bf16_scalar(sigma6), _bf16_scalar(48.0 * epsilon)
    half, zero = _bf16_scalar(0.5), _bf16_scalar(0.0)
    rsq = dx * dx + dy * dy + dz * dz
    rs32 = rsq.float()
    mask = (rs32 < cutforcesq) & (rs32 > 0.0)
    sr2 = (1.0 / torch.where(mask, rs32, 1.0)).to(bf)
    sr6 = sr2 * sr2 * sr2 * sig_b
    gf = torch.where(mask, e48 * sr6 * (sr6 - half) * sr2, zero)
    return tuple(
        (d * gf).float().sum(2).reshape(n_clusters_pad, 8) for d in (dx, dy, dz)
    )


def lj_cluster_force_ilist_bf16(
    xc, yc, zc,  # (C_total, 8) float32 coordinate planes
    ijlist,  # (n_units, icap) int32 exact per-i-unit j16 ids
    nji,  # (n_units,) int32 list lengths
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
):
    """The exact-list LJ force with bfloat16 pair math (the T2 probe),
    (fx, fy, fz) each (n_clusters_pad, 8) float32; untyped, flat lists.

    CPU tensors take `lj_cluster_force_ilist_bf16_ref`. CUDA tensors
    launch the bf16 form of ``csrc/lj_cluster_ilist.cu`` on the current
    stream after the operands are checked (float32 planes only); a launch
    error raises.
    The kernel stops at nji, as K1 does, and takes the approximate float32
    reciprocal, so it may round sr2 to another bfloat16 value than the
    plain version's exact one."""
    global BF16_LAUNCHES
    if xc.device.type == "cpu":
        return lj_cluster_force_ilist_bf16_ref(
            xc, yc, zc, ijlist, n_clusters_pad, cutforcesq, sigma6, epsilon, share)
    if xc.device.type != "cuda":
        raise ValueError(f"no force kernel for device {xc.device}")
    if xc.dtype != torch.float32:
        raise TypeError(f"the bf16 force takes float32 planes, got {xc.dtype}")
    _check_cuda_args(xc, yc, zc, ijlist, nji, n_clusters_pad, share)
    lib = _build.load()
    out = [torch.empty((n_clusters_pad, 8), dtype=xc.dtype, device=xc.device)
           for _ in range(3)]
    with torch.cuda.device(xc.device):
        err = lib.lj_cluster_ilist_bf16(
            xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), ijlist.data_ptr(),
            nji.data_ptr(), *(o.data_ptr() for o in out),
            ijlist.shape[0], ijlist.shape[1], share, float(cutforcesq),
            float(_bf16_scalar(sigma6)), float(_bf16_scalar(48.0 * epsilon)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lj_cluster_ilist_bf16 launch failed: CUDA error {err}")
    BF16_LAUNCHES += 1
    return tuple(out)


def per_bucket(n_outputs: int, bijlist, binv, buckets, share: int, like,
               pass_fn):
    """The bucketed structure of mdbench_tpu's exact-list forces: per
    bucket of `buckets` (sizes, caps), pass_fn(lists, n_rows, r0, r1) on
    its lists bijlist[off:off+n_k, :c_k] and its rows [r0, r1) of the
    permuted order, n_rows = r1 - r0 (zeros, in `like`'s dtype, for a
    cap-0 bucket); the buckets' rows concatenated, then gathered back
    through binv. Returns n_outputs (n_clusters_pad, 8) tensors."""
    sizes, caps = buckets
    parts = []
    off = 0
    for n_k, c_k in zip(sizes, caps):
        r0, r1 = off * share, (off + n_k) * share
        if c_k == 0:
            z = torch.zeros((r1 - r0, 8), dtype=like.dtype, device=like.device)
            parts.append((z,) * n_outputs)
        else:
            parts.append(tuple(pass_fn(bijlist[off : off + n_k, :c_k], r1 - r0,
                                       r0, r1)))
        off += n_k
    inv = binv.long()
    return tuple(torch.cat(fs)[inv] for fs in zip(*parts))


def lj_cluster_force_buckets_ref(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    bijlist,  # (total_units, icap) int j16 ids in nji order (bucket maps)
    bcrows,  # (total_units*share,) int cluster rows of each position
    binv,  # (n_clusters_pad,) int position row of each cluster row
    n_clusters_pad: int,
    buckets,  # (sizes, caps): units per bucket, in order, and their caps
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
):
    """Plain torch bucketed force, the literal twin of mdbench_tpu's
    `_force_buckets`: the i-side rows permuted through bcrows; per bucket,
    the plain exact-list force of its units on bijlist[off:off+n_k, :c_k]
    (a cap-0 bucket gives zeros); the buckets' rows concatenated, then
    gathered back through binv. Returns (fx, fy, fz), each
    (n_clusters_pad, 8)."""
    if binv.shape != (n_clusters_pad,):
        raise ValueError("binv must be (n_clusters_pad,)")
    xi = [p[bcrows.long()] for p in (xc, yc, zc)]
    return per_bucket(
        3, bijlist, binv, buckets, share, xc,
        lambda jl, n, r0, r1: lj_cluster_force_ilist_ref(
            xc, yc, zc, jl, n, cutforcesq, sigma6, epsilon, share,
            xi=tuple(p[r0:r1] for p in xi)))


@functools.lru_cache(maxsize=64)
def bucket_table(buckets) -> tuple:
    """(ends, caps) of a plan (sizes, caps) as the kernels take them:
    read-only int32 host arrays of each bucket's end position and cap,
    kept alive by the cache while a launch reads them. Raises ValueError
    for a plan the kernels do not take."""
    sizes, caps = (tuple(int(v) for v in t) for t in buckets)
    if not 1 <= len(sizes) == len(caps) <= MAX_BUCKETS:
        raise ValueError(f"a bucket plan has 1 to {MAX_BUCKETS} buckets, sizes "
                         "and caps alike")
    if min(sizes) < 0 or min(caps) < 0:
        raise ValueError("bucket sizes and caps must be non-negative")
    ends = np.cumsum(np.asarray(sizes, np.int64)).astype(np.int32)
    caps = np.asarray(caps, np.int32)
    for a in (ends, caps):  # cached and shared: read-only
        a.setflags(write=False)
    return ends, caps


def _check_bucket_args(xc, yc, zc, bijlist, bcrows, binv, nji, n_clusters_pad,
                       buckets, share) -> tuple:
    """The checks of the bucketed kernels' wrappers before a launch;
    returns bucket_table(buckets)."""
    _check_planes(xc, yc, zc, bijlist, bcrows, binv, nji)
    if share not in (1, 2, 4):
        raise ValueError(f"share must be 1, 2 or 4, got {share}")
    if any(t.dtype != torch.int32 for t in (bijlist, bcrows, binv, nji)):
        raise TypeError("bijlist, bcrows, binv and nji must be int32")
    if not all(t.is_contiguous() for t in (bijlist, bcrows, nji)):
        raise ValueError("bijlist, bcrows and nji must be contiguous")
    ends, caps = bucket_table(tuple(map(tuple, buckets)))
    n_rows = bijlist.shape[0] if bijlist.dim() == 2 else -1
    if n_rows != int(ends[-1]) or bcrows.shape != (n_rows * share,):
        raise ValueError("bijlist must be (sum(sizes), icap) and bcrows "
                         "(sum(sizes) * share,)")
    if nji.dim() != 1 or nji.shape[0] * share != n_clusters_pad:
        raise ValueError("nji must be (n_units,) with n_units * share == n_clusters_pad")
    if binv.shape != (n_clusters_pad,) or n_clusters_pad > xc.shape[0]:
        raise ValueError("binv must be (n_clusters_pad,), n_clusters_pad <= C_total")
    return ends, caps


def lj_cluster_force_buckets(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    bijlist,  # (total_units, icap) int32 j16 ids in nji order
    bcrows,  # (total_units*share,) int32 cluster rows of each position
    binv,  # (n_clusters_pad,) int32 position row of each cluster row
    nji,  # (n_units,) int32 list lengths, in unit order
    n_clusters_pad: int,
    buckets,  # (sizes, caps)
    cutforcesq: float, sigma6: float, epsilon: float,
    share: int = 2,
    approx_rcp: bool = False,
):
    """Capacity-bucketed exact-list LJ force (K1b), (fx, fy, fz) each
    (n_clusters_pad, 8), from the bucket maps of ops/cluster.py.

    CPU tensors take the plain twin `lj_cluster_force_buckets_ref`. CUDA
    tensors launch the bucketed form of the exact-list kernel once on the
    current stream, after the operands are checked; a launch error
    raises. The kernel writes each unit's rows straight from its position
    (binv is not read there): bcrows must hold every unit's rows once, as
    bucket_maps_core builds it. A unit reads min(nji, its bucket's cap)
    entries of its list. `approx_rcp` as in `lj_cluster_force_ilist`."""
    global BUCKET_LAUNCHES
    if xc.device.type == "cpu":
        return lj_cluster_force_buckets_ref(
            xc, yc, zc, bijlist, bcrows, binv, n_clusters_pad, buckets,
            cutforcesq, sigma6, epsilon, share)
    if xc.device.type != "cuda":
        raise ValueError(f"no force kernel for device {xc.device}")
    ends, caps = _check_bucket_args(xc, yc, zc, bijlist, bcrows, binv, nji,
                                    n_clusters_pad, buckets, share)
    lib = _build.load()
    f32 = xc.dtype == torch.float32
    fn = lib.lj_cluster_ilist_buckets_f32 if f32 else lib.lj_cluster_ilist_buckets_f64
    out = [torch.empty((n_clusters_pad, 8), dtype=xc.dtype, device=xc.device)
           for _ in range(3)]
    with torch.cuda.device(xc.device):
        err = fn(
            xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), bijlist.data_ptr(),
            bcrows.data_ptr(), nji.data_ptr(), *(o.data_ptr() for o in out),
            bijlist.shape[0], bijlist.shape[1], nji.shape[0], share, len(ends),
            ends.ctypes.data, caps.ctypes.data, float(cutforcesq), float(sigma6),
            float(epsilon), int(bool(approx_rcp)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lj_cluster_ilist_buckets launch failed: CUDA error {err}")
    BUCKET_LAUNCHES += 1
    return tuple(out)


def _group_chunks(ng: int, gm: int, width: int, max_elems: int):
    """Group slices whose (groups, gm i-atoms, width) pair block stays
    under max_elems elements."""
    step = max(1, max_elems // (gm * width))
    return [slice(g0, min(g0 + step, ng)) for g0 in range(0, ng, step)]


def _lj_pairs(xc, yc, zc, jl, rows, cutforcesq, sigma6, epsilon, extra=None,
              tc=None, tables=None):
    """(dx, dy, dz, gf) of every (i-atom, listed j-atom) pair of the
    groups whose i-atoms are the flat rows `rows` (c, gm) and whose j16
    lists are `jl` (c, L): each (c, gm, L*16); gf is 0 outside
    0 < rsq < cutforcesq and outside `extra` (a bool mask), selected,
    never multiplied by a mask. With `tables`, each pair's epsilon,
    sigma6 and cutforcesq come from them at the pair's types in `tc`."""
    c, L = jl.shape
    cjn = xc.shape[0] // 2

    def gather(p):
        return p.reshape(-1)[rows][:, :, None], p.reshape(cjn, 16)[jl].reshape(c, 1, L * 16)

    dx, dy, dz = (pi - pj for pi, pj in map(gather, (xc, yc, zc)))
    if tables is not None:
        epsilon, sigma6, cutforcesq = _pair_params(tables, *gather(tc), xc)
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
    tc=None,  # (C_total, 8) int types, typed runs only
    tables=None,  # (eps, sig6, cutsq), each (T, T), typed runs only
):
    """Plain torch group-list force, untyped or typed. Without `ranges`
    it is the twin of mdbench_tpu's `lj_cluster_force_xla`: every i-atom
    of group g meets every atom of every j16 in row g of `jlist`. With
    `ranges` it is the twin of the stream kernel: the atoms of tile s
    (list entries 8s..8s+7) count for member m only if start[m] <= s <
    end[m] and s < njg. Sentinel j16 and entries past nj contribute
    exactly 0 through the cutoff. Groups run in chunks of at most
    `max_elems` pair elements. Returns (fx, fy, fz), each
    (n_clusters_pad, 8)."""
    _check_typed_pair(tc, tables)
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
                                   sigma6, epsilon, extra, tc, tables)
        for o, d in zip(out, (dx, dy, dz)):
            o[sl] = (d * gf).sum(2)
    return tuple(o.reshape(n_clusters_pad, 8) for o in out)


def lj_cluster_force_half_ref(
    xc, yc, zc,  # (C_total, 8) coordinate planes
    jlist,  # (NG, L) int j16 ids, group-shared
    n_clusters_pad: int,
    cutforcesq: float, sigma6: float, epsilon: float,
    max_elems: int = 1 << 25,
    tc=None,  # (C_total, 8) int types, typed runs only
    tables=None,  # (eps, sig6, cutsq), each (T, T), typed runs only
):
    """Newton half-list force, untyped or typed, the twin of mdbench_tpu's
    `lj_cluster_force_xla_half` (reference half_neigh, clusterpair/
    force_lj.c:167-431). In the flat slot ids i -> g*128 + k and
    j -> c*16 + l, a pair with a local j (gid_j < n_clusters_pad*8) is
    computed once, from the side with the smaller id (gid_j > gid_i); a
    pair with a ghost j is computed from the local side only. The
    reaction forces fold back onto the local j16 rows with index_add_,
    which on a CUDA tensor sums with atomics in an order that changes
    from run to run. Returns (fx, fy, fz), each (n_clusters_pad, 8)."""
    _check_typed_pair(tc, tables)
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
                                   epsilon, half, tc, tables)
        for o, f16, d in zip(fi, fj16, (dx, dy, dz)):
            fd = d * gf
            o[sl] = fd.sum(2)
            fj = torch.where(local_j, fd.sum(1, keepdim=True), 0.0)
            f16.index_add_(0, jl.reshape(-1), -fj.reshape(c * L, 16))
    return tuple(
        o.reshape(n_clusters_pad, 8) + f16.reshape(2 * cjn, 8)[:n_clusters_pad]
        for o, f16 in zip(fi, fj16)
    )


# the stream kernel's warp step: 8 i-atoms x 8 j-atoms of one kept
# 8-atom j-cluster (32 lanes, 2 j-atoms each)
WARP_STEP_PAIRS = 64


def cluster_boxes(xc, yc, zc):
    """(lo, hi), each (C_total, 3): the bounds of each 8-atom row of the
    planes as the stream kernel forms them, NaN-ignoring (fminf/fmaxf: a
    bound is NaN only where the row's 8 values all are)."""
    lo, hi = [], []
    for p in (xc, yc, zc):
        a = b = p[:, 0]
        for c in range(1, 8):
            a, b = torch.fmin(a, p[:, c]), torch.fmax(b, p[:, c])
        lo.append(a)
        hi.append(b)
    return torch.stack(lo, 1), torch.stack(hi, 1)


def box_gap_sq(lo_a, hi_a, lo_b, hi_b):
    """The stream kernel's box distance between boxes (..., 3): per axis
    the gap max(lo_a - hi_b, lo_b - hi_a, 0) (NaN-ignoring max), then
    (gx*gx + gy*gy) + gz*gz, each operation rounded in the planes' dtype:
    the order of a pair's rsq, so it never exceeds the rsq of a pair of
    atoms inside the two boxes."""
    zero = torch.zeros((), dtype=lo_a.dtype, device=lo_a.device)
    g = torch.fmax(torch.fmax(lo_a - hi_b, lo_b - hi_a), zero)
    sq = g * g
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def stream_window(jlist, ranges):
    """The stream kernel's window j-clusters: (inwin, jrows), inwin
    (NG*16, 2L) bool, whether slot k (entry k // 2 of the group's list
    row, 8-atom row half k % 2) lies in member m's window, i.e. its tile
    k // 16 satisfies max(start, 0) <= tile < min(end, njg); jrows (NG,
    2L) int64, each slot's 8-atom row of the planes."""
    ng, L = jlist.shape
    dev = jlist.device
    rg = ranges.long()
    njg = rg[:, 2 * GROUP].clamp(0, L // 8)
    start = rg[:, :GROUP].clamp(min=0)
    end = torch.minimum(rg[:, GROUP:2 * GROUP], njg[:, None])
    tile = torch.arange(2 * L, device=dev) // 16
    inwin = (tile >= start[:, :, None]) & (tile < end[:, :, None])
    half = torch.arange(2 * L, device=dev) % 2
    jrows = 2 * jlist.long().repeat_interleave(2, dim=1) + half
    return inwin.reshape(ng * GROUP, 2 * L), jrows


def stream_cull(xc, yc, zc, jlist, ranges, cutsq: float,
                max_elems: int = 1 << 24):
    """Plain mirror of the stream kernel's cull (tests and chip_smoke.py
    only; the force never calls it): (inwin, kept), each (NG*16, 2L) bool
    as `stream_window`'s; kept holds the window j-clusters whose box
    distance to the member's box (`cluster_boxes`, `box_gap_sq`, current
    coordinates) is not >= cutsq, so a NaN distance keeps. cutsq is the
    force cutoff squared (typed: the tables' largest), in the planes'
    dtype as the kernel takes it."""
    lo, hi = cluster_boxes(xc, yc, zc)
    inwin, jrows = stream_window(jlist, ranges)
    ng, width = jrows.shape
    cut = torch.tensor(cutsq, dtype=xc.dtype, device=xc.device)
    kept = torch.zeros_like(inwin)
    for sl in _group_chunks(ng, GROUP, width, max_elems):
        ir = torch.arange(sl.start * GROUP, sl.stop * GROUP, device=xc.device)
        jr = jrows[sl].repeat_interleave(GROUP, dim=0)
        d2 = box_gap_sq(lo[ir][:, None], hi[ir][:, None], lo[jr], hi[jr])
        kept[ir] = ~(d2 >= cut)
    return inwin, inwin & kept


def stream_work_counts(xc, yc, zc, jlist, ranges, cutsq: float) -> dict:
    """Per member, (NG*16,) int64 counts of the stream kernel's work on
    these lists: window tiles, window j-clusters (16 a tile), kept
    j-clusters (`stream_cull`) and the lane-pairs its warp runs
    (WARP_STEP_PAIRS per kept j-cluster: every one a real pair that takes
    the distance test)."""
    inwin, kept = stream_cull(xc, yc, zc, jlist, ranges, cutsq)
    nwin, nkept = inwin.sum(1), kept.sum(1)
    return dict(tiles=nwin // 16, window_clusters=nwin, kept_clusters=nkept,
                lane_pairs=nkept * WARP_STEP_PAIRS)


def _check_stream_args(xc, yc, zc, jlist, ranges, n_clusters_pad):
    _check_planes(xc, yc, zc, jlist, ranges)
    if any(p.data_ptr() % 16 for p in (xc, yc, zc)):
        raise ValueError("the stream kernel reads the planes as 16-byte vectors: "
                         "they must start on a 16-byte boundary")
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
    tc=None,  # (C_total, 8) int32 types, typed runs only
    tables=None,  # (eps, sig6, cutsq), each (T, T), typed runs only
):
    """Group-window LJ force, (fx, fy, fz) each (n_clusters_pad, 8).

    CPU tensors take the plain version (`lj_cluster_force_group_ref` with
    the windows). CUDA tensors launch the CUDA kernel on the current
    stream (built from csrc/ at first use), its typed instantiation when
    `tc` and `tables` are given, after the operands are checked; a launch
    error raises. Every j16 id of a tile below njg may be read, entries
    past nj included: they must be valid rows (a real j16, more than
    cutneigh from the whole group, or the sentinel j16). The kernel
    culls the j-clusters whose box lies beyond the cutoff
    (`stream_cull` mirrors the test; it drops no pair the plain version
    keeps) and sums the rest in another order than the plain version."""
    global STREAM_LAUNCHES, STREAM_TYPED_LAUNCHES
    _check_typed_pair(tc, tables)
    if xc.device.type == "cpu":
        return lj_cluster_force_group_ref(
            xc, yc, zc, jlist, n_clusters_pad, cutforcesq, sigma6, epsilon,
            ranges=ranges, tc=tc, tables=tables,
        )
    if xc.device.type != "cuda":
        raise ValueError(f"no force kernel for device {xc.device}")
    _check_stream_args(xc, yc, zc, jlist, ranges, n_clusters_pad)
    lib = _build.load()
    f32 = xc.dtype == torch.float32
    out = [torch.empty((n_clusters_pad, 8), dtype=xc.dtype, device=xc.device)
           for _ in range(3)]
    if tables is not None:
        nt, *tabs = _typed_operands(xc, tc, tables)
        if tc.data_ptr() % 8:
            raise ValueError("the stream kernel reads tc as 8-byte vectors: it "
                             "must start on an 8-byte boundary")
        fn = lib.lj_cluster_stream_typed_f32 if f32 else lib.lj_cluster_stream_typed_f64
        with torch.cuda.device(xc.device):
            err = fn(
                xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), tc.data_ptr(),
                jlist.data_ptr(), ranges.data_ptr(), *(t.data_ptr() for t in tabs),
                *(o.data_ptr() for o in out), jlist.shape[0], jlist.shape[1], nt,
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"lj_cluster_stream_typed launch failed: CUDA error {err}")
        STREAM_TYPED_LAUNCHES += 1
        return tuple(out)
    fn = lib.lj_cluster_stream_f32 if f32 else lib.lj_cluster_stream_f64
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
