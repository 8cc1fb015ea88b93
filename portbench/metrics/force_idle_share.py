"""Share of the traced window in which no operation ran on the device
while the host was inside one of the program's `force` spans, % (torch.
profiler, as rebuild_idle_share)."""

from portbench import spans
from portbench.devtrace import FORCE_SPAN


def read(m):
    if m.trace is None:
        return None
    return spans.idle_share(m.trace, (FORCE_SPAN,))
