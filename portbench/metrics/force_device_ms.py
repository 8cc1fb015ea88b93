"""Device milliseconds a step of the operations launched inside the
program's `force` spans (torch.profiler; the force kernels and the torch
operations around them)."""


def read(m):
    if m.trace is None:
        return None
    us = sum(op.dur for op in m.trace.ops if op.in_force)
    if us <= 0:
        return None
    return us * 1e-3 / (m.steps * m.traced_runs)
