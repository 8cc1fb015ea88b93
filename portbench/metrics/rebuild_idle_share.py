"""Share of the traced window in which no operation ran on the device
while the host was inside one of the program's `reneighbor` spans, %
(torch.profiler: the device's idle stretches overlapped with the spans'
host intervals)."""

from portbench import spans


def read(m):
    if m.trace is None:
        return None
    return spans.idle_share(m.trace, spans.REBUILD)
