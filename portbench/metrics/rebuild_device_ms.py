"""Device milliseconds a step of the operations launched inside the
program's `reneighbor` spans: the whole neighbour rebuild, with its
re-sort, halo, lists, prune and bucket maps (torch.profiler; launches
tied to their operations by portbench/spans.py)."""

from portbench import spans


def read(m):
    if m.trace is None:
        return None
    us = spans.device_us(m.trace, spans.REBUILD)
    if not us:
        return None
    return us * 1e-3 / (m.steps * m.traced_runs)
