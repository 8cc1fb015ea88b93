"""Share of the traced window in which no operation ran on the device
while the host was inside one of the program's `integrate`, `halo_update`
or `thermo` spans, the spans of step_device_ms, % (torch.profiler, as
rebuild_idle_share)."""

from portbench import spans


def read(m):
    if m.trace is None:
        return None
    return spans.idle_share(m.trace, spans.STEP)
