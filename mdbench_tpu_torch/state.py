"""Sentinel constants shared by the port's cluster layout (the port's copy
of ``mdbench_tpu.state``'s constants; its pytrees become the NamedTuples of
``ops/cluster.py`` and ``engine_cluster.py``).

Padding atoms sit at ~SENTINEL_COORD, so every distance from them fails
any cutoff test. In float32, SENTINEL_COORD**2 overflows to inf: every
comparison against it must select, never multiply by a 0/1 mask.
"""

SENTINEL_COORD = 1.0e30
