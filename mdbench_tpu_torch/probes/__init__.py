"""Probes of the port on the card: the counterparts of mdbench_tpu's TPU
probes under tools/ that hold Pallas kernels.

- ``python -m mdbench_tpu_torch.probes.bf16 [golden] [ab] [CSRC_DIR ...]``:
  K1 with bfloat16 pair math (tools/r3_bf16.py), against earlier csrc/
  copies in turns;
- ``python -m mdbench_tpu_torch.probes.dma [CSRC_DIR ...]``: list-driven
  row fetch through shared memory (tools/r4_dma.py), against earlier
  csrc/ copies in turns;
- ``python -m mdbench_tpu_torch.probes.eam_verlet [CSRC_DIR ...]``: the
  verlet EAM kernels K5 and K6 at 131k, against earlier csrc/ copies in
  turns;
- ``python -m mdbench_tpu_torch.probes.derive [PAIRS]``: the bf16 derive
  against the exact one at 131k (tools/r3_derive16.py): the derive's
  times and profile, NEIGH, and the run's TOTAL in turns.

Each needs a CUDA card and says so when it finds none. The timers here:
`event_ms` (back-to-back launches, host path included where it is the
slower part) and `graph_ms` (the device alone, from CUDA-graph replays).
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def event_ms(fn, reps: int, batches: int = 5, warm: int = 3) -> float:
    """Device time per call of `fn`: CUDA events around `reps` back-to-back
    calls (so the host's launch gaps hide behind queued work), median over
    `batches`."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def graph_ms(fn, reps: int, batches: int = 5) -> float:
    """Device time per call of `fn` without the host's launch path: `reps`
    calls captured in one CUDA graph (after one call outside it), each
    replay timed with CUDA events, median over `batches` replays. For
    calls whose host path (argument checks, allocation, the launch) takes
    longer than the kernel, where event_ms times the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
