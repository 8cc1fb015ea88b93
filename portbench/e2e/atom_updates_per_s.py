"""Atoms x steps of every run the window completed, over the window's host
seconds (MD-Bench's "atom updates per second", verletlist/main.c:337-338,
taken over a whole window of back-to-back runs)."""


def read(m):
    return m.natoms * m.steps * len(m.run_times) / m.window_s
