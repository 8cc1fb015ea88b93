"""Device milliseconds a step of every operation outside the program's
`force` spans: the neighbour rebuilds, the integration, the thermo and the
copies (torch.profiler)."""


def read(m):
    if m.trace is None:
        return None
    us = sum(op.dur for op in m.trace.ops if not op.in_force)
    if us <= 0:
        return None
    return us * 1e-3 / (m.steps * m.traced_runs)
