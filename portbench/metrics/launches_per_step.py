"""Host calls that queued device work, a step: the kernel, graph, copy and
set launches of the CUDA API (`cuda*` and `cu*` calls) in the traced
window, on the launching thread (torch.profiler; portbench/spans.py names them)."""

from portbench import spans


def read(m):
    if m.trace is None:
        return None
    n = len(spans.launches(m.trace))
    if n == 0:
        return None
    return n / (m.steps * m.traced_runs)
