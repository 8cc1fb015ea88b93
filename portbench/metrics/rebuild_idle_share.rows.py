"""Share of the traced window in which no operation ran on the device while
the host was inside the program's `reneighbor.rows` spans (a rebuild's row
lists, their exact prune included), % (torch.profiler, as
rebuild_idle_share)."""

from portbench import spans


def read(m):
    if m.trace is None:
        return None
    return spans.idle_share(m.trace, ("reneighbor.rows",))
