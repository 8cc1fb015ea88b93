"""mdbench_tpu_torch — the PyTorch/CUDA port of mdbench_tpu.

The port runs the cluster-pair scheme (GROMACS-style M x N cluster lists,
reference src/clusterpair/; ``engine_cluster.py``) with Lennard-Jones or
EAM forces, and the verlet scheme (per-atom or 16-atom row lists,
reference src/verletlist/; ``engine.py``) with Lennard-Jones forces, on
one NVIDIA Hopper card. Module paths mirror ``mdbench_tpu`` so each function's counterpart is
easy to find; ``mdbench_tpu`` stays the reference the tests hold the port
against.

- host set-up (lattice, Park-Miller velocities, thermo scales) is numpy,
  carried across unchanged;
- the list build and the time-step loop are eager torch ops on an explicit
  ``device``;
- the force kernels are hand-written CUDA kernels, built with ``nvcc``
  at first use (``_build.py``): the exact-list LJ force
  (``csrc/lj_cluster_ilist.cu``), the two EAM passes
  (``csrc/eam_cluster.cu``) and the group-window LJ force
  (``csrc/lj_cluster_stream.cu``), picked by ``Params.kernel`` as in
  mdbench_tpu; the verlet scheme's row lists run the exact-list LJ
  kernel with 16-atom rows as its j-clusters. On a CPU tensor the plain
  torch twins run instead;
- ``stats.py`` and ``stub.py`` port the exact counters and the cluster
  kernel microbenchmark.

The package imports torch and numpy only, never jax or mdbench_tpu.
"""

__version__ = "0.1.0"

from mdbench_tpu_torch.config import Params, read_parameter_file  # noqa: F401
