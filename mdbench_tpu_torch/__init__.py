"""mdbench_tpu_torch — the PyTorch/CUDA port of mdbench_tpu.

The port runs the cluster-pair scheme (GROMACS-style M x N cluster lists,
reference src/clusterpair/) with Lennard-Jones or EAM forces on one NVIDIA
Hopper card. Module paths mirror ``mdbench_tpu`` so each function's counterpart is
easy to find; ``mdbench_tpu`` stays the reference the tests hold the port
against.

- host set-up (lattice, Park-Miller velocities, thermo scales) is numpy,
  carried across unchanged;
- the list build and the time-step loop are eager torch ops on an explicit
  ``device``;
- the exact-list forces are hand-written CUDA kernels
  (``csrc/lj_cluster_ilist.cu``; the two EAM passes in
  ``csrc/eam_cluster.cu``), built with ``nvcc`` at first use
  (``_build.py``). On a CPU tensor the plain torch twins run instead.

The package imports torch and numpy only, never jax or mdbench_tpu.
"""

__version__ = "0.1.0"

from mdbench_tpu_torch.config import Params, read_parameter_file  # noqa: F401
