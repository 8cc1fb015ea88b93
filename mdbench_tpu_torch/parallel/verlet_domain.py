"""The verlet scheme's spatial domain decomposition over 1-D slabs (the
port of ``mdbench_tpu.parallel.verlet_domain``).

The reference is single-node; its ghost-atom PBC machinery (border_map +
shift vectors, src/verletlist/pbc.c) is the pattern that generalises to
several devices. The box is cut into `ndev` slabs along x; each domain
runs the single-device machinery (cells, padded verlet lists or 16-atom
row lists, the LJ or EAM force) on its slab, and the only traffic
between domains is fixed-capacity buffers moved by the exchange layer
(`parallel/exchange.py`: `shift` for mdbench_tpu's `lax.ppermute`,
`psum` for its `lax.psum`):

  reneighbour (every reneigh_every steps):
    wrap y/z -> MIGRATE atoms that crossed a slab face (pack leavers into
    fixed buffers, shift left/right, merge) -> on the row-list path a
    resort by cell -> local y/z ghosts (setup_pbc with pbc = (0, 1, 1))
    -> export both x-face boundary regions (locals and their y/z images,
    so edge and corner images ride along) -> shift -> the received
    buffers become x-ghost rows -> cells and lists per domain
  every step:
    integrate -> refresh the local y/z ghosts -> re-gather the exported
    border rows, shift both ways, refresh the x-ghost rows -> force (EAM:
    pass 1, the ghost fp with its own border shift, pass 2) -> integrate
    -> psum of the kinetic energy (every step with dense_thermo)

The slab engine is the one-axis case of the staged engine that the
pencil and brick engines share (`parallel/staged.py`, which holds the
phases, the run protocol and the force paths); this module adds the
slab's capacity plan, its state type and run_chunked. With one slab the
exchange still runs: the slab sends its own border rows to itself,
shifted by +-slab_w, and that is how the x seam wraps.

Correctness needs slab width >= cutneigh and atoms that drift at most
one slab per reneighbour interval (flagged). A domain's row layout:

  [0, acap)               local atoms (sentinel padded)
  [acap, acap+gcap)       local y/z ghosts
  [+bcap)                 x-ghosts received from the left neighbour
  [+bcap)                 x-ghosts received from the right neighbour
  [tail]                  sentinel rows (16 on the row-list path, else 1)
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np

from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.parallel.staged import DomainResult, StagedDomainEngine

AXIS = "x"  # the mesh axis (the slabs' normal)


class DomainState(NamedTuple):
    """The domains' tensors after a run, each field a tuple over the
    domains this process holds (the exchange's `domains`, ascending);
    mdbench_tpu stacks them over its mesh axis. On the row-list path
    neighbors / numneigh hold the row lists, as in mdbench_tpu."""

    x: tuple  # (nrows, 3): locals, ghosts, sentinel rows, slab frame
    v: tuple  # (acap, 3)
    f: tuple  # (acap, 3)
    nlocal: tuple  # () int64: live atoms per domain
    halo_map: tuple  # (gcap,) local y/z ghost owner rows
    halo_shift: tuple  # (gcap, 3)
    bmap_l: tuple  # (bcap,) rows exported to the LEFT neighbour
    bmap_r: tuple  # (bcap,)
    neighbors: tuple  # (acap, maxneighs), or (acap / 16, rcap) row lists
    numneigh: tuple  # (acap,), or (acap / 16,)
    overflow: tuple  # (4,) bool [migration, ghosts, border, lists]


def plan_capacities(params: Params, ndev: int, natoms: int) -> dict:
    """Capacity and memory plan of a domain run: the per-domain row
    capacities DomainSimulation starts from (before the row-list layout
    rules and the calibration) and an estimate of the bytes each domain's
    state holds, in the port's types (float32 or float64 coordinates,
    int64 list, halo and border indices), so that a configuration can be
    judged against the card's memory (an H100: 80 GB) before it is
    launched. List-build intermediates are not counted."""
    slab_w = params.xprd / ndev
    per_dev = natoms / ndev
    # 1.10 margin: the row-list kernel and lists pad to acap, so slack
    # taxes every step; the overflow grow-retry backstops the melt
    acap = int(math.ceil(per_dev * 1.10 / 8)) * 8 + 8
    c = params.cutneigh
    gfrac = (1 + 2 * c / params.yprd) * (1 + 2 * c / params.zprd) - 1.0
    gcap = int(math.ceil(acap * gfrac * 1.6)) + 64  # a slab's y/z ghosts
    # one x-face region with its y/z images
    bfrac = (c / slab_w) * (1 + 2 * c / params.yprd) * (1 + 2 * c / params.zprd)
    bcap = int(math.ceil(acap * bfrac * 1.8)) + 64
    migcap = int(math.ceil(acap * 0.2)) + 32
    vol = 4.0 / 3.0 * np.pi * c**3
    maxneighs = max(params.maxneighs, int(math.ceil(vol * params.rho * 1.3 / 8)) * 8)
    nrows = acap + gcap + 2 * bcap + 1
    fsize = 8 if params.precision == "dp" else 4
    isize = 8  # int64 indices
    bytes_per_dev = (
        nrows * 3 * fsize  # x
        + 2 * acap * 3 * fsize  # v, f
        + acap * maxneighs * isize  # neighbour list
        + acap * isize  # numneigh
        + gcap * (isize + 3 * fsize)  # halo map + shifts
        + 2 * bcap * isize  # border maps
    )
    return dict(
        slab_w=slab_w, acap=acap, gcap=gcap, bcap=bcap, migcap=migcap,
        maxneighs=maxneighs, nrows=nrows, bytes_per_device=bytes_per_dev,
        slab_ok=slab_w >= params.cutneigh,
    )


class DomainSimulation(StagedDomainEngine):
    """The verlet-scheme LJ or EAM simulation over `ndev` x-slabs (module
    docstring; parallel/staged.StagedDomainEngine for the arguments)."""

    KIND = "slab"
    GHOST_FLOOR, BORDER_FLOOR = 256, 128

    def __init__(self, params: Params, ndev: int, x: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None, device="cuda", exchange=None):
        super().__init__(params, (ndev,), x=x, v=v, device=device, exchange=exchange)

    def _init_caps(self):
        plan = plan_capacities(self.params, self.ndev, self.natoms)
        self.acap, self.gcap, self.bcaps = plan["acap"], plan["gcap"], [plan["bcap"]]
        self.migcap, self.maxneighs = plan["migcap"], plan["maxneighs"]

    @property
    def slab_w(self) -> float:
        return self.w[0]

    @property
    def bcap(self) -> int:
        """The x-ghost block's capacity (one a side)."""
        return self.bcaps[0]

    @staticmethod
    def _state(doms) -> DomainState:
        rl = doms[0].nlist.rows is not None
        return DomainState(
            x=tuple(d.x for d in doms), v=tuple(d.v for d in doms),
            f=tuple(d.f for d in doms), nlocal=tuple(d.nloc for d in doms),
            halo_map=tuple(d.halo.border_map for d in doms),
            halo_shift=tuple(d.halo.shift for d in doms),
            bmap_l=tuple(d.maps[0][0] for d in doms),
            bmap_r=tuple(d.maps[0][1] for d in doms),
            neighbors=tuple(d.nlist.rows if rl else d.nlist.neighbors for d in doms),
            numneigh=tuple(d.nlist.numrows if rl else d.nlist.numneigh for d in doms),
            overflow=tuple(d.ovf for d in doms),
        )

    def _global_from_dev(self, xs, vs, ns):
        """Global (x, v) float64 from the domains' layout (a chunk-boundary
        restart point): each domain's live rows [0, nloc) shifted back by
        the slab origin, concatenated in domain order. Row order within a
        domain is kept, so a replay's re-split reproduces each domain's
        atom order."""
        acap = self.acap
        xg = self._gather([x[:acap] for x in xs])
        vg = self._gather(list(vs))
        ng = self._gather(list(ns))
        xo, vo = [], []
        for d in range(self.ndev):
            n = int(ng[d])
            xd = xg[d, :n].astype(np.float64)
            xd[:, 0] += d * self.slab_w
            xo.append(xd)
            vo.append(vg[d, :n].astype(np.float64))
        return np.concatenate(xo), np.concatenate(vo)

    def run_chunked(self, chunk: int, nchunks: int, max_retries: int = 5) -> DomainResult:
        """Run in chunks with chunk-boundary overflow REPLAY: a chunk that
        overflows is discarded, the capacities grow to at least the
        observed maxima, the boundary snapshot is re-split under the new
        caps and the chunk replays (never a restart from t = 0; reference
        semantics: the in-loop resize never aborts,
        verletlist/neighbor.c:247-262). `chunk` must be a multiple of
        reneigh_every (each chunk starts with a rebuild, a physics no-op at
        a rebuild boundary). total_time is the host time of the chunks."""
        p = self.params
        if chunk % p.reneigh_every:
            raise ValueError("chunk must be a multiple of reneigh_every")
        self._calibrate(chunk)
        temps_all = []
        retries = c = 0
        xin, vin, nin = self.x0, self.v0, self.n0
        t0 = time.perf_counter()
        while c < nchunks:
            doms, temps = self._run_steps(self.initial_state(xin, vin, nin), chunk)
            flags = self._overflowed(doms)
            if flags.any():
                retries += 1
                if retries > max_retries:
                    raise RuntimeError("domain capacity overflow persisted in run_chunked")
                xg, vg = self._global_from_dev(xin, vin, nin)
                self._grow_and_reinit(self._state(doms), xv=(xg, vg), flags=flags)
                xin, vin, nin = self.x0, self.v0, self.n0
                continue  # replay chunk c from the boundary snapshot
            temps_all.append(temps.cpu().numpy())
            xin, vin, nin = [d.x for d in doms], [d.v for d in doms], [d.nloc for d in doms]
            c += 1
        self._sync()
        total = time.perf_counter() - t0
        return DomainResult(temps=np.concatenate(temps_all), state=self._state(doms),
                            total_time=total)
