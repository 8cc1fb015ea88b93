"""Seconds from the process's start to the window's start: imports, the
t=0 atoms, the engine, the warm-up run (and in a fresh checkout the kernel
library's build)."""


def read(m):
    return m.setup_s
