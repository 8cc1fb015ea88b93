"""The verlet scheme's domain decomposition over BRICKS (the port of
``mdbench_tpu.parallel.verlet_domain3d``): a (px, py, pz) mesh cuts every
box axis, so there is no local halo at all: the periodic seams ride the
exchange's rings, and along a mesh axis of size 1 a brick sends its own
border rows to itself (so one engine covers (2, 2, 1) and (1, 1, 2)).

Every phase is staged over the three mesh axes (parallel/staged.py):
migration is three hops (x, y, z: an atom that crossed a corner reaches
the diagonal domain in at most three), and the ghost exchange three
stages where stage d scans the locals and every earlier stage's ghosts,
which covers the 12 edge and 8 corner regions without a diagonal channel
(the reference's explicit face, edge and corner walk, pbc.c:90-227). The
EAM ghost fp takes three staged hops with the same maps.

A domain's row layout (verlet_domain3d.py:13-18):

  [0, acap)    locals (sentinel padded)
  [+bx) [+bx)  x-ghosts from the left / right neighbour
  [+by) [+by)  y-ghosts from below / above (with the x-ghosts' images)
  [+bz) [+bz)  z-ghosts from below / above (with the x and y images)
  [tail]       sentinel rows (16 on the row-list path, else 1)

Domain ids run row-major over (px, py, pz), as mdbench_tpu's mesh does
(verlet_domain3d.py:144).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.parallel.staged import StagedDomainEngine


class Domain3DSimulation(StagedDomainEngine):
    """The verlet-scheme LJ or EAM simulation over a (px, py, pz) brick
    mesh (module docstring; parallel/staged.StagedDomainEngine for the
    arguments: `exchange` must have shape (px, py, pz))."""

    KIND = "brick"
    BORDER_FLOOR = 64  # verlet_domain3d.py:540-543

    def __init__(self, params: Params, px: int, py: int, pz: int,
                 x: Optional[np.ndarray] = None, v: Optional[np.ndarray] = None,
                 device="cuda", exchange=None):
        super().__init__(params, (px, py, pz), x=x, v=v, device=device,
                         exchange=exchange)

    def _init_caps(self):
        """mdbench_tpu's initial capacities (verlet_domain3d.py:96-113):
        stage d's face strip is (c / w_d) of the brick extended by the
        earlier stages."""
        p, c = self.params, self.params.cutneigh
        self.acap = int(math.ceil(self.natoms / self.ndev * 1.3 / 8)) * 8 + 8
        self.gcap = 0
        scan, self.bcaps = self.acap, []
        for d in range(3):
            cap = int(math.ceil(scan * (c / self.w[d]) * 2.0)) + 64
            self.bcaps.append(cap)
            scan += 2 * cap
        self.migcap = int(math.ceil(self.acap * 0.25)) + 32
        vol = 4.0 / 3.0 * np.pi * c**3
        self.maxneighs = max(p.maxneighs, int(math.ceil(vol * p.rho * 1.3 / 8)) * 8)
