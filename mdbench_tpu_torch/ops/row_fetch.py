"""List-driven row fetch: the probe of tools/r4_dma.py on the card.

`row_fetch(table, ids, rows_per_id, mode)` copies the rows of a (R, 128)
float32 table that an int32 id list names into a new (n_ids * rows_per_id,
128) tensor, in order: one row per id (rows_per_id 1, the TPU probe's
`dma1`) or a block of 8 consecutive rows per id (rows_per_id 8, `dma8`; id
b names rows 8b .. 8b+7). On a CUDA tensor it launches
``csrc/row_fetch.cu``, which stages the rows through shared memory with
`cp.async` copies and stores them from registers (mode "cp_async"), or
moves them with TMA bulk copies alone, into a ring of shared-memory slots
and out of it, in persistent blocks (mode "tma"); on a CPU tensor it runs
`row_fetch_ref` (index_select).
Both give the same tensor bit for bit. Any other device raises; nothing
falls back from the kernel to its plain version. No engine path runs it;
``mdbench_tpu_torch/probes/dma.py`` measures it.
"""

from __future__ import annotations

import torch

from mdbench_tpu_torch import _build

MODES = ("cp_async", "tma")
ROWS_PER_ID = (1, 8)
COLS = 128  # floats per table row (the TPU probe's lane width)


def variant(mode: str, rows_per_id: int) -> str:
    """The launch count's key (and the JSON row's name) of one variant."""
    return f"row_fetch_{mode}_{'row' if rows_per_id == 1 else 'block'}"


# kernel launches of each variant (a run's proof that it went through the
# CUDA kernel); callers may reset them to 0
LAUNCHES = {variant(m, r): 0 for m in MODES for r in ROWS_PER_ID}


def row_fetch_ref(table, ids, rows_per_id: int = 1):
    """Plain torch version: index_select of the rows (rows_per_id 1) or of
    the 8-row blocks (rows_per_id 8) that `ids` names, as (n_ids *
    rows_per_id, 128) rows."""
    blocks = table.reshape(-1, rows_per_id * table.shape[1])
    return blocks.index_select(0, ids).reshape(-1, table.shape[1])


def _check_args(table, ids, rows_per_id, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if rows_per_id not in ROWS_PER_ID:
        raise ValueError(f"rows_per_id must be 1 or 8, got {rows_per_id}")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != COLS:
        raise TypeError(f"table must be (R, {COLS}) float32")
    if table.shape[0] % rows_per_id or table.shape[0] < rows_per_id:
        raise ValueError("the table's rows must be a positive multiple of rows_per_id")
    if ids.dtype != torch.int32 or ids.dim() != 1 or ids.numel() == 0:
        raise TypeError("ids must be a non-empty (n_ids,) int32 tensor")
    if ids.device != table.device:
        raise ValueError("table and ids must be on one device")
    if not (table.is_contiguous() and ids.is_contiguous()) or table.data_ptr() % 16:
        raise ValueError("table and ids must be contiguous, the table 16-byte aligned")


def row_fetch(table, ids, rows_per_id: int = 1, mode: str = "cp_async"):
    """The rows of `table` (R, 128) float32 named by `ids` (n_ids,) int32,
    as (n_ids * rows_per_id, 128). CPU tensors take `row_fetch_ref`; CUDA
    tensors launch the `mode` variant on the current stream after the
    operands are checked, and a launch error raises. Ids must lie in [0,
    R / rows_per_id); the kernel clamps them only to keep its reads in
    bounds, where index_select raises."""
    _check_args(table, ids, rows_per_id, mode)
    if table.device.type == "cpu":
        return row_fetch_ref(table, ids, rows_per_id)
    if table.device.type != "cuda":
        raise ValueError(f"no row-fetch kernel for device {table.device}")
    lib = _build.load()
    out = torch.empty((ids.numel() * rows_per_id, COLS), dtype=table.dtype,
                      device=table.device)
    with torch.cuda.device(table.device):
        err = lib.row_fetch_f32(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.numel(),
            table.shape[0], rows_per_id, MODES.index(mode),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"row_fetch launch failed: CUDA error {err}")
    LAUNCHES[variant(mode, rows_per_id)] += 1
    return out
