"""The list-driven row-fetch probe on the card, the port's counterpart of
tools/r4_dma.py.

    python -m mdbench_tpu_torch.probes.dma [CSRC_DIR ...]

The tool's inputs, from default_rng(0) in its order: an (8192, 128)
float32 table, 65,536 random row ids and 8,192 random ids of 8-row
blocks. For index_select (the plain version, and the library call) and
for each of the four hand-written variants (cp.async or TMA bulk copies,
per row or per 8-row block; ops/row_fetch.py) it prints whether the
output equals index_select's bit for bit, ns per fetched row and ms per
call, and the bound. Each call is timed two ways, index_select and the
two modes in turns, three rounds, the median of each: on the device alone
(`graph_ms`: 20 calls captured in one CUDA graph and replayed), which
gives ns/row and ms, and back to back from the host (`event_ms`: CUDA
events around 50 calls), which includes the host's launch path where that
is slower than the kernel. The bound: the table and the ids read
once plus the rows written once, over 3.35 TB/s (the 4 MiB table fits in
the card's 50 MB L2, so the fetches mostly hit it; the write of the rows
is the part that must reach device memory). Exits 1 if a variant
disagrees with index_select.

Each CSRC_DIR is another copy of mdbench_tpu_torch/csrc/ with the same C
entry points (an earlier checkout's, or an edited variant): its library
is built beside the package's, and the whole measurement runs with each
library in turns (this one first, then the others, then back in reverse
order), in one process on one card, each line led by the library's
name. The row-fetch kernels' -Xptxas -v lines come first.
"""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np
import torch

from mdbench_tpu_torch import _build
from mdbench_tpu_torch.ops.row_fetch import (
    COLS,
    MODES,
    row_fetch,
    row_fetch_ref,
    variant,
)
from mdbench_tpu_torch.probes import card_line, event_ms, graph_ms

R = 8192  # table rows (~ the j16 count at 131k with ghosts)
N = 65536  # row fetches per call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)


def make_inputs(device):
    """(table, row ids, block ids) as tools/r4_dma.py draws them."""
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.standard_normal((R, COLS)), dtype=torch.float32,
                         device=device)
    idx = torch.tensor(rng.integers(0, R, size=(N,)), dtype=torch.int32, device=device)
    idx8 = torch.tensor(rng.integers(0, R // 8, size=(N // 8,)), dtype=torch.int32,
                        device=device)
    return table, idx, idx8


def equal_to_index_select(table, idx, idx8) -> dict:
    """{variant: whether its output equals index_select's bit for bit}."""
    return {variant(mode, rows_per_id): bool(torch.equal(
                row_fetch(table, ids, rows_per_id, mode),
                row_fetch_ref(table, ids, rows_per_id)))
            for rows_per_id, ids in ((1, idx), (8, idx8)) for mode in MODES}


def measure(table, idx, idx8, reps: int = 50, graph_reps: int = 20,
            rounds: int = 3) -> list:
    """One dict per variant: name, mode, rows_per_id, rows, ms and
    ns_per_row (device time, graph_ms), host_ms (back to back from the
    host, event_ms), library_ms and library_host_ms (index_select's, the
    same two ways), bound_ms. index_select and the two modes are timed in
    turns, `rounds` times each way; each time is the median of its
    rounds."""
    rows = []
    for rows_per_id, ids in ((1, idx), (8, idx8)):
        want = row_fetch_ref(table, ids, rows_per_id)
        moved = sum(t.numel() * t.element_size() for t in (table, ids, want))
        calls = {"index_select": lambda: row_fetch_ref(table, ids, rows_per_id)}
        calls.update({mode: functools.partial(row_fetch, table, ids, rows_per_id, mode)
                      for mode in MODES})
        dev = {name: [] for name in calls}
        host = {name: [] for name in calls}
        for _ in range(rounds):
            for name, fn in calls.items():
                dev[name].append(graph_ms(fn, graph_reps))
                host[name].append(event_ms(fn, reps))
        ms = {name: float(np.median(t)) for name, t in dev.items()}
        host_ms = {name: float(np.median(t)) for name, t in host.items()}
        for mode in MODES:
            rows.append({
                "name": variant(mode, rows_per_id), "mode": mode,
                "rows_per_id": rows_per_id, "rows": want.shape[0], "ms": ms[mode],
                "ns_per_row": ms[mode] * 1e6 / want.shape[0],
                "host_ms": host_ms[mode], "library_ms": ms["index_select"],
                "library_host_ms": host_ms["index_select"],
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            })
    return rows


def report(rows, equal: dict, card: str) -> list:
    """The probe's lines for `measure`'s rows and `equal_to_index_select`'s
    verdicts."""
    out = []
    for r in rows:
        out.append(
            f"{r['name']:<24}: {r['ns_per_row']:7.4f} ns/row ({r['ms']:.4f} ms / "
            f"{r['rows']} rows, {r['rows'] // r['rows_per_id']} ids); index_select "
            f"{r['library_ms'] * 1e6 / r['rows']:7.4f} ns/row ({r['library_ms']:.4f} "
            f"ms); back to back from the host {r['host_ms']:.4f} ms, index_select "
            f"{r['library_host_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms (bytes; "
            f"the 4 MiB table fits in the 50 MB L2); equal to index_select: "
            f"{equal[r['name']]}; {card}")
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("mdbench_tpu_torch.probes.dma needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    card = card_line()
    variants = [("this", _build.SRC_DIR), *((d, Path(d)) for d in argv)]
    for name, src in variants:  # build every library before the runs
        _build.load(src)
        for kernel in ("row_fetch_kernel", "row_fetch_tma_kernel"):
            for line in chip_smoke.kernel_ptxas_lines(kernel, src):
                print(f"{name}: {line}")
    inputs = make_inputs("cuda")
    ok = True
    order = variants + variants[::-1] if len(variants) > 1 else variants
    for name, src in order:
        _build.load(src)
        equal = equal_to_index_select(*inputs)
        ok = ok and all(equal.values())
        for line in report(measure(*inputs), equal, card):
            print(f"{name}: {line}" if len(variants) > 1 else line, flush=True)
    _build.load(_build.SRC_DIR)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
