"""Device milliseconds a step of the operations launched inside the
program's `reneighbor.prune` spans: the row lists' exact prune (the
distance block, its two minima, the compaction), or the cluster scheme's
derive (torch.profiler; launches tied to their operations by
portbench/spans.py)."""

from portbench import spans


def read(m):
    if m.trace is None:
        return None
    us = spans.device_us(m.trace, spans.PRUNE)
    if not us:
        return None
    return us * 1e-3 / (m.steps * m.traced_runs)
