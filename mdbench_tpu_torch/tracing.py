"""Tracing and profiling hooks (the port of ``mdbench_tpu.tracing``;
reference src/verletlist/tracing.{c,h} and its LIKWID markers):

- LIKWID marker regions -> `region(name)`: while a torch profiler records
  (`profile`), a `torch.profiler.record_function` span; otherwise one
  shared null context, so the engines' step loops build nothing for their
  regions outside a profile.
- Whole-run traces -> `profile(logdir)`: `torch.profiler.profile` over the
  CPU and, where there is one, the CUDA device, exported as a Chrome trace
  into `logdir`.
- MEM_TRACER / INDEX_TRACER -> `dump_mem_trace` / `dump_index_trace`:
  host dumps of one step's neighbor lists, the same files as
  mdbench_tpu's (native writers where they load, else Python).

The spans of the single engines (engine.Simulation and
engine_cluster.ClusterSimulation); a dotted name lies inside the span
named before its last dot:

- reneighbor: a whole rebuild, the initial state's included
- reneighbor.sort: the wrap and re-sort (the cluster engine: the re-cluster)
- reneighbor.halo: the rebuild's wrap, ghosts and ghost refresh
- reneighbor.rows: the lists up to and with their exact prune
- reneighbor.prune: the exact prune (the cluster engine: derive_ilists)
- reneighbor.buckets: the capacity-bucket maps
- force: the force of a step, with what it launches around its kernel
- integrate: one velocity-Verlet half (or the cluster kick and drift)
- halo_update: a plain step's ghost refresh
- thermo: a step's T and P on the device, and their gather at a run's end

Left outside every span: run()'s host reads (the overflow flag, the
temperatures and pressures), the verlet initial state's velocity copy,
and the cluster engine's per-run capacity checks. The domain engines
(`parallel/`) open `reneighbor` and `force` alone; the staged ones
(parallel/staged.py: slabs, pencils, bricks) also show
`reneighbor.prune`, which ops/verlet._exact_prune opens for every caller,
inside their `reneighbor` with no `reneighbor.rows` around it. (The
cluster engine opens its prune span itself, around derive_ilists.)
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from mdbench_tpu_torch.io import native

TRACE_FILE = "trace.json"


_OFF = contextlib.nullcontext()


def region(name: str):
    """Named span (LIKWID_MARKER_START/STOP analogue), recorded only while
    a torch profiler is on; otherwise the shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile(logdir: str):
    """Profile the block on the CPU and the CUDA device (if any); the Chrome
    trace goes to `logdir`/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def dump_mem_trace(path_prefix: str, neighbors, numneigh, step: int,
                   nlocal: int | None = None, float_size: int = 4) -> str:
    """MEM_TRACER address stream (reference tracing.h:24-45): per atom its
    position read, per neighbor the list entry and the neighbor's position
    read, then its force write, as byte addresses in a planar layout (x
    plane at 0, f plane after it, the int32 list last), one record a line,
    to `<prefix>mem_tracer_<step>.out`. Returns the path."""
    nb = np.asarray(neighbors)
    nn = np.asarray(numneigh)
    n = nb.shape[0] if nlocal is None else nlocal
    nrows = nb.shape[0]
    row = 3 * float_size
    f_base = nrows * row
    nl_base = 2 * nrows * row
    path = f"{path_prefix}mem_tracer_{step}.out"
    if native.write_mem_trace(path, nb, nn, n, nrows, float_size):
        return path
    with open(path, "w") as fp:
        for i in range(n):
            fp.write(f"R: {i * row} {row}\n")
            for c in range(int(nn[i])):
                fp.write("R: %d 4\n" % (nl_base + (i * nb.shape[1] + c) * 4))
                fp.write("R: %d %d\n" % (int(nb[i, c]) * row, row))
            fp.write(f"W: {f_base + i * row} {row}\n")
    return path


def dump_index_trace(path_prefix: str, neighbors, numneigh, step: int,
                     vector_width: int = 8) -> str:
    """INDEX_TRACER dump (reference tracing.h:47-123): per atom its neighbor
    indices in chunks of the vector width, each chunk with its min and max
    index, to `<prefix>index_tracer_<step>.out`. Returns the path."""
    path = f"{path_prefix}index_tracer_{step}.out"
    nb = np.asarray(neighbors)
    nn = np.asarray(numneigh)
    if native.write_index_trace(path, nb, nn, vector_width):
        return path
    with open(path, "w") as fp:
        for i in range(nb.shape[0]):
            k = int(nn[i])
            fp.write(f"A: {i} {k}\n")
            for c0 in range(0, k, vector_width):
                chunk = nb[i, c0 : min(c0 + vector_width, k)]
                fp.write("C: %d %d\n" % (int(chunk.min()), int(chunk.max())))
                fp.write("I: " + " ".join(str(int(j)) for j in chunk) + "\n")
    return path
