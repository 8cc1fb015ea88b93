"""Exact-list Lennard-Jones force of the cluster scheme.

`lj_cluster_force_ilist` is the wrapper the engine calls. On a CUDA
tensor it launches the hand-written kernel ``csrc/lj_cluster_ilist.cu``
(the port of the TPU kernel ``mdbench_tpu/ops/pallas/lj_cluster.py::
_kernel_ilist``) or raises; on a CPU tensor it runs the plain version
`lj_cluster_force_ilist_ref`. Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from mdbench_tpu_torch import _build

# kernel launches made by lj_cluster_force_ilist (a run's proof that it
# went through the CUDA kernel); callers may reset it to 0
LAUNCHES = 0


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


def _check_cuda_args(xc, yc, zc, ijlist, nji, n_clusters_pad, share):
    planes = (xc, yc, zc)
    dev = xc.device
    if any(t.device != dev for t in (*planes, ijlist, nji)):
        raise ValueError("all operands must be on one CUDA device")
    if xc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"coordinate planes must be float32/float64, got {xc.dtype}")
    for t in planes:
        if t.dtype != xc.dtype or t.shape != xc.shape or not t.is_contiguous():
            raise ValueError("xc, yc, zc must be contiguous planes of one dtype and shape")
    if xc.dim() != 2 or xc.shape[1] != 8 or xc.shape[0] % 2:
        raise ValueError(f"planes must be (C_total, 8) with C_total even, got {tuple(xc.shape)}")
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
