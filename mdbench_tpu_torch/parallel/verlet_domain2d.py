"""The verlet scheme's domain decomposition over PENCILS (the port of
``mdbench_tpu.parallel.verlet_domain2d``): a (px, py) mesh cuts x and y,
each domain owns [0, wx) x [0, wy) x the whole z in its own frame. The
decomposition for a large box on many devices where one slab per device
would fall under the cutoff width.

Every phase is staged over the two mesh axes (parallel/staged.py):
migration is an x hop, then a y hop (an atom that crossed a corner
reaches the diagonal domain in two hops; drift must stay under one
pencil per rebuild, flagged); the halo is the local z-ghosts (setup_pbc
with pbc = (0, 0, z)), then the x-face exports over the locals and the
z-ghosts, shifted along the x axis, then the y-face exports over the
locals, the z-ghosts and the x-ghosts just received, shifted along the y
axis: the y exports that carry x-ghosts are what cover the corners. Each
step re-gathers both exports and shifts them again; the EAM ghost fp is
staged the same way (local z, x, then y).

A domain's row layout (verlet_domain2d.py:26-31):

  [0, acap)          locals (sentinel padded)
  [acap, +gcap)      local z-ghosts
  [+bxcap) [+bxcap)  x-ghosts from the left / right neighbour
  [+bycap) [+bycap)  y-ghosts from the neighbour below / above
  [tail]             sentinel rows (16 on the row-list path, else 1)

Domain ids run row-major over (px, py), as mdbench_tpu's mesh does
(verlet_domain2d.py:155).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.parallel.staged import StagedDomainEngine


class Domain2DSimulation(StagedDomainEngine):
    """The verlet-scheme LJ or EAM simulation over a (px, py) pencil mesh
    (module docstring; parallel/staged.StagedDomainEngine for the
    arguments: `exchange` must have shape (px, py))."""

    KIND = "pencil"
    GHOST_FLOOR, BORDER_FLOOR = 128, 64  # verlet_domain2d.py:637-639

    def __init__(self, params: Params, px: int, py: int, x: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None, device="cuda", exchange=None):
        super().__init__(params, (px, py), x=x, v=v, device=device, exchange=exchange)

    def _init_caps(self):
        """mdbench_tpu's initial capacities (verlet_domain2d.py:110-124)."""
        p, c = self.params, self.params.cutneigh
        wx, wy = self.w[0], self.w[1]
        self.acap = int(math.ceil(self.natoms / self.ndev * 1.3 / 8)) * 8 + 8
        zfrac = 2 * c / p.zprd
        self.gcap = int(math.ceil(self.acap * zfrac * 1.8)) + 64
        # the x export: the x-face strip of the z-extended pencil
        xfrac = (c / wx) * (1 + zfrac)
        # the y export scans the locals, z-ghosts and x-ghosts (the
        # x-extended pencil)
        yfrac = (c / wy) * ((wx + 2 * c) / wx) * (1 + zfrac)
        self.bcaps = [int(math.ceil(self.acap * f * 1.8)) + 64 for f in (xfrac, yfrac)]
        self.migcap = int(math.ceil(self.acap * 0.2)) + 32
        vol = 4.0 / 3.0 * np.pi * c**3
        self.maxneighs = max(p.maxneighs, int(math.ceil(vol * p.rho * 1.3 / 8)) * 8)
