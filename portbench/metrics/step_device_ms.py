"""Device milliseconds a step of the operations launched inside the
program's `integrate`, `halo_update` and `thermo` spans: the velocity-Verlet
halves, the plain steps' ghost refresh, and T and P with their gather
(torch.profiler; launches tied to their operations by portbench/spans.py)."""

from portbench import spans


def read(m):
    if m.trace is None:
        return None
    us = spans.device_us(m.trace, spans.STEP)
    if not us:
        return None
    return us * 1e-3 / (m.steps * m.traced_runs)
