"""The force's share of its roofline, %: the least time the card needs for
the work the physics asks of a step (reference/work.py, pairs counted at
the t=0 atoms and at the traced run's last positions, averaged), over the
device time of the operations in the program's `force` spans a step.
None on a card that reference/peaks.py lacks."""

from portbench.reference.work import step_bound_s


def read(m):
    if m.trace is None or m.pairs is None or m.peaks is None:
        return None
    us = sum(op.dur for op in m.trace.ops if op.in_force)
    if us <= 0:
        return None
    per_step_s = us * 1e-6 / (m.steps * m.traced_runs)
    return 100.0 * step_bound_s(m.pairs, m.natoms, m.cfg["precision"], m.peaks) / per_step_s
