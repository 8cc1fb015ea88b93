"""The staged-axis domain engine that the verlet scheme's domain engines
share: the slabs of `verlet_domain.py`, the pencils of
`verlet_domain2d.py` and the bricks of `verlet_domain3d.py` (the port of
what mdbench_tpu's three engines each carry: verlet_domain.py,
verlet_domain2d.py, verlet_domain3d.py).

A mesh of k = len(pdims) axes (1, 2 or 3) cuts the box: axis a cuts box
dimension a into pdims[a] domains of width w[a]; a dimension past k stays
whole on every domain and wraps through a local halo (setup_pbc with pbc
0 on the cut dimensions). Every phase that crosses domains runs one hop a
mesh axis, so an edge or corner neighbour needs no channel of its own
(the reference's face, edge and corner ghost walk, pbc.c:90-227, in k
hops). The traffic is fixed-capacity buffers moved by the exchange layer
(`parallel/exchange.py`: `shift` along an axis for mdbench_tpu's
`lax.ppermute`, `psum` for its `lax.psum`):

  reneighbour (every reneigh_every steps):
    wrap the uncut dimensions -> MIGRATE, one hop per axis (pack the
    leavers into fixed buffers, shift left and right, merge; an atom that
    crossed a corner reaches the diagonal domain in k hops) -> on the
    row-list path a resort by cell -> the local halo over the uncut
    dimensions -> per axis a in order: the face exports over the locals,
    the halo ghosts and every earlier stage's ghosts (so a later stage
    carries the earlier ones' images: edges and corners), shift, the
    received rows become stage a's ghosts -> cells and lists per domain
  every step:
    integrate -> refresh the halo ghosts -> per axis: re-gather the
    exported rows, shift both ways, refresh that stage's ghosts -> force
    (EAM: pass 1, the ghost fp staged the same way, pass 2) -> integrate
    -> psum of the kinetic energy (every step with dense_thermo)

mdbench_tpu runs each device's whole run as one jitted scan inside
`shard_map`, with the collectives in the middle. Here every phase runs
for each domain this process holds, then the exchange, then the next
phase: with `InProcessMesh` all domains live in one process on one
device; with `DistExchange` one domain per rank. Along a mesh axis of
size 1 the exchange still runs: the domain sends its own border rows to
itself, shifted by the box length, and that is how that seam wraps.

Correctness needs every cut width >= cutneigh and atoms that drift at
most one domain per reneighbour interval (flagged). A domain's row
layout:

  [0, acap)               local atoms (sentinel padded)
  [+gcap)                 halo ghosts over the uncut dimensions (no
                          block when all three are cut)
  [+bcaps[0]) [+bcaps[0]) stage 0's ghosts from the left / right neighbour
  ...                     one pair of blocks a stage
  [tail]                  sentinel rows (16 on the row-list path, else 1)

Each domain's atom count is a 0-d int64 tensor on the device, never read
on the host inside a run; overflow flags are a (4,) bool tensor per
domain [migration, ghosts (the halo and the face exports), cells, lists],
read once after a run, which then grows every capacity and retries
(mdbench_tpu's grow-and-reinit). mdbench_tpu's dropped scatters
(`mode="drop"`) write into buffers one row longer than their capacity
whose last row is cut off. The steps update the domains' x and v in
place.

Force paths, by the single-device engine's rule (engine.Simulation):
kernel "auto" or "rowlist" with LJ takes the 16-atom row lists on every
device (mdbench_tpu: only on a TPU) and their exact-list force, on a CUDA
tensor the K1 kernel or, once the melt calibration has planned capacity
buckets, K1b; "xla" takes the planar per-atom lists and
ops/lj.compute_force_lj_full; EAM the planar lists and ops/eam's two
passes (splines, or the fitted polynomials with eam_eval "poly", or
"auto" in SP on the card). On the card the row-list local region aligns
to 1024 atoms, elsewhere to 16 (parallel/common.align_acap).
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.models.eam_tables import apply_eam_overrides, fit_eam_poly, load_eam
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops.cells import build_cells, make_cell_grid
from mdbench_tpu_torch.ops.cluster import bucket_maps_core
from mdbench_tpu_torch.ops.eam import (
    EamDevice,
    eam_density,
    eam_pair_forces,
    ghost_fp_refresh,
    use_poly_eval,
)
from mdbench_tpu_torch.ops.lj import compute_force_lj_full
from mdbench_tpu_torch.ops.pbc import setup_pbc, update_pbc
from mdbench_tpu_torch.ops.verlet import (
    build_neighbors,
    compute_force_lj_rowlist,
    derive_rowlists_from_cells,
)
from mdbench_tpu_torch.parallel.common import (
    align_acap,
    apply_rowlist_caps,
    calibrated_block_cap,
    live_rows,
    migrate,
    resort_by_cell,
    round16,
    wrap_dims,
)
from mdbench_tpu_torch.parallel.exchange import InProcessMesh
from mdbench_tpu_torch.state import SENTINEL_COORD, Halo, NeighborList
from mdbench_tpu_torch.thermo import adjust_thermo, adjusted_dtforce, setup_thermo
from mdbench_tpu_torch.tracing import region

KERNELS = ("auto", "rowlist", "xla")
FLAGS = ("migration", "ghosts", "border", "lists")  # a domain's overflow flags


class DomainResult(NamedTuple):
    temps: np.ndarray
    state: NamedTuple  # the engine's state type, fields tuples over the held domains
    total_time: float


class MeshDomainState(NamedTuple):
    """The domains' tensors after a run of a pencil or brick engine, each
    field a tuple over the domains this process holds (the exchange's
    `domains`, ascending); mdbench_tpu stacks them over its mesh axes. On
    the row-list path neighbors / numneigh hold the row lists."""

    x: tuple  # (nrows, 3): locals, ghosts, sentinel rows, domain frame
    v: tuple  # (acap, 3)
    f: tuple  # (acap, 3)
    nlocal: tuple  # () int64: live atoms per domain
    halo_map: tuple  # (gcap,) halo ghost owner rows (None: bricks have no halo)
    maps: tuple  # per stage (rows exported to the left, to the right), (bcap,) each
    neighbors: tuple  # (acap, maxneighs), or (acap / 16, rcap) row lists
    numneigh: tuple  # (acap,), or (acap / 16,)
    overflow: tuple  # (4,) bool [migration, ghosts, cells, lists]


class _Dom(NamedTuple):
    """One domain's step state inside a run."""

    x: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor
    nloc: torch.Tensor
    halo: Optional[Halo]
    maps: tuple  # per stage (ml, mr)
    nlist: NeighborList
    ovf: torch.Tensor


class StagedDomainEngine:
    """The verlet-scheme LJ or EAM simulation over a mesh of `pdims`
    domains (module docstring); a subclass names its domains (KIND), sets
    the initial capacities (`_init_caps`) and the calibration floors.

    `device` is explicit; asking for a CUDA device without one raises, and
    nothing drops to the CPU. `exchange` is the exchange layer (None: an
    InProcessMesh of shape pdims on `device`); its shape must be pdims.
    Without `x`, the atoms come from the FCC lattice, and the velocities
    are always rescaled, as in mdbench_tpu. EAM loads `params.eam_file`
    and applies initEam's overrides to `params` first: pass a fresh
    `Params` to each engine."""

    KIND = "domain"
    GHOST_FLOOR = 128  # the calibrated halo block's floor
    BORDER_FLOOR = 64  # the calibrated face-export blocks' floor

    def __init__(self, params: Params, pdims: tuple, x: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None, device="cuda", exchange=None):
        if params.kernel not in KERNELS:
            raise ValueError(f"the verlet kernel must be one of {', '.join(KERNELS)}, "
                             f"got {params.kernel!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch finds no CUDA device; "
                "pass device='cpu' to run the plain path"
            )
        self.params = params
        self.eam_dev = self.eam_poly = None
        if params.force_field == FF_EAM:
            # the overrides set rho, so they come before the lattice
            # (reference setup() calls initEam first, main.c:38)
            if not params.eam_file:
                raise ValueError("force_field=eam requires eam_file")
            t = load_eam(params.eam_file)
            apply_eam_overrides(params, t)
            self.eam_dev = EamDevice.from_tables(t, self.device, params.dtype)
            if use_poly_eval(params, self.device):
                self.eam_poly = fit_eam_poly(t)
        self.pdims = tuple(int(n) for n in pdims)
        self.k = len(self.pdims)
        self.ndev = math.prod(self.pdims)
        prd = (params.xprd, params.yprd, params.zprd)
        self.prd = prd
        # the domain's box: the cut widths, then the whole uncut lengths
        self.w = tuple(prd[d] / self.pdims[d] if d < self.k else prd[d] for d in range(3))
        for d in range(self.k):
            if self.w[d] < params.cutneigh:
                raise ValueError(f"{self.KIND} width {self.w[d]:.2f} along {'xyz'[d]} < "
                                 f"cutneigh {params.cutneigh}: use fewer domains or a "
                                 "larger box")
        if exchange is None:
            exchange = InProcessMesh(self.pdims, self.device)
        if exchange.shape != self.pdims:
            raise ValueError(f"the exchange holds a mesh of {exchange.ndev} domains in "
                             f"shape {exchange.shape}, not {self.pdims}")
        self.exchange = exchange
        if x is None:
            x, v, _ = create_fcc_lattice(params)
        self.natoms = x.shape[0]
        self.scales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        v = adjust_thermo(params, self.scales, v, self.natoms)

        # acap, gcap (0 without a halo), bcaps (one a stage), migcap, maxneighs
        self._init_caps()
        self._rowlist = self.eam_dev is None and params.kernel in ("auto", "rowlist")
        # the melt calibration's bucket plan: mdbench_tpu's Pallas backend,
        # here the card's bucketed kernel K1b
        self._on_card = self.device.type == "cuda"
        # generous initial row-build caps; the melt calibration re-sets them
        # from observed maxima before the timed run
        self.rcap, self.ccap, self.ucl, self.ubr = 64, 128, 6, 8
        self.zw = 5  # z-run width (unit-column z span + 2, + drift)
        self.rbuckets = None  # (sizes, caps), planned at calibration
        self._calibrated = False
        # the flags (FLAGS, any domain) behind each capacity growth
        self.grows: list = []
        self.setup_time = None  # run()'s set-up seconds (run docstring)
        self._fix_row_layout()

        # the domain's cell grid (the same geometry on every domain); bin
        # capacity 2.5x the mean: FCC planes alias against the bin
        # boundaries, so some bins run well above it
        box = np.array(self.w)
        nb = [max(1, int(box[d] // params.cutneigh)) for d in range(3)]
        mean = params.rho * (box[0] / nb[0]) * (box[1] / nb[1]) * (box[2] / nb[2])
        self.grid = make_cell_grid(box, params.cutneigh, params.rho,
                                   capacity=int(math.ceil(mean * 2.5 / 8.0)) * 8)
        self._xv_init = (x, v)
        self._init_host_state(x, v)

    def _init_caps(self):
        raise NotImplementedError

    # ---- layout and set-up ------------------------------------------------

    def _fix_row_layout(self):
        """The row-list path aligns acap (parallel/common.align_acap), keeps
        the ghost blocks in whole 16-atom rows and ends with 16 sentinel
        rows (the row lists' padding row); the planar path keeps one
        sentinel row."""
        if self._rowlist:
            self.acap = align_acap(True, self._on_card, self.acap)
            self.gcap = round16(self.gcap)
            self.bcaps = [round16(b) for b in self.bcaps]
        tail = 16 if self._rowlist else 1
        self.nrows = self.acap + self.gcap + 2 * sum(self.bcaps) + tail

    def _stage_base(self, s: int) -> int:
        """The first row of stage s's ghost blocks (stage s's exports scan
        every row before it)."""
        return self.acap + self.gcap + 2 * sum(self.bcaps[:s])

    def _origin(self, dom: int) -> np.ndarray:
        """Domain `dom`'s corner in the box (row-major mesh coordinates)."""
        coords = np.unravel_index(dom, self.pdims)
        return np.array([coords[d] * self.w[d] if d < self.k else 0.0 for d in range(3)])

    def _init_host_state(self, x, v):
        """Each held domain's atoms in its own frame (x shifted so that the
        domain owns [0, w)): x0, v0, n0, lists over the held domains."""
        p, dev = self.params, self.device
        cell = [np.minimum((x[:, d] / self.w[d]).astype(np.int64), self.pdims[d] - 1)
                for d in range(self.k)]
        owner = np.ravel_multi_index(cell, self.pdims)
        self.x0, self.v0, self.n0 = [], [], []
        for d in self.exchange.domains:
            idx = np.nonzero(owner == d)[0]
            n = len(idx)
            if n > self.acap:
                raise RuntimeError(f"{self.KIND} {d} holds {n} atoms, more than acap "
                                   f"{self.acap}")
            xs = np.full((self.nrows, 3), SENTINEL_COORD, np.float64)
            vs = np.zeros((self.acap, 3), np.float64)
            xs[:n] = x[idx] - self._origin(d)
            vs[:n] = v[idx]
            self.x0.append(torch.as_tensor(xs, dtype=p.dtype, device=dev))
            self.v0.append(torch.as_tensor(vs, dtype=p.dtype, device=dev))
            self.n0.append(torch.tensor(n, dtype=torch.int64, device=dev))

    # ---- per-domain phases --------------------------------------------------

    def _live(self, nloc, n: int):
        return live_rows(nloc, n)

    def _build_halo(self, x, nloc):
        """The halo ghosts over the uncut dimensions (setup_pbc with pbc 0
        on the cut ones). Returns (x, halo), x's ghost rows refreshed in
        place; halo None when every dimension is cut."""
        p = self.params
        if self.k == 3:
            return x, None
        acap = self.acap
        # sentinel padding rows (~1e30) would pass the high-side face tests
        # of setup_pbc and spawn garbage ghosts: it gets a copy with the
        # padding rows at NaN, which fails every face test (mdbench_tpu
        # parks them mid-box, which fails them only where the box is wider
        # than 2 cutneigh: in a thinner box every padding row spawns ghosts)
        x_safe = x.clone()
        x_safe[:acap] = torch.where(self._live(nloc, acap)[:, None], x[:acap],
                                    float("nan"))
        pbc = tuple(0 if d < self.k else (p.pbc_x, p.pbc_y, p.pbc_z)[d] for d in range(3))
        halo = setup_pbc(
            x_safe, acap, acap, self.gcap, np.array(self.w), pbc, p.cutneigh,
            # the row-list path: cell-sorted ghosts keep ghost 16-rows compact
            sort_grid=self.grid if self._rowlist else None,
        )
        return update_pbc(x, halo, acap), halo

    def _export_maps(self, x, s: int):
        """Stage s's two face-export maps over every row before its ghost
        blocks (the locals, the halo and the earlier stages' ghosts; the
        real sentinel in x keeps padding rows out). Returns (ml, mr,
        overflow)."""
        c, bcap = self.params.cutneigh, self.bcaps[s]
        nscan = self._stage_base(s)
        xr = x[:nscan, s]
        row_ids = torch.arange(nscan, device=x.device)
        row_live = x[:nscan, 0].abs() < SENTINEL_COORD * 0.5
        exp_l = row_live & (xr < c)
        exp_r = row_live & (xr >= self.w[s] - c)

        def pack_map(mask):
            pos = torch.cumsum(mask, 0) - 1
            cnt = mask.sum()
            pos = torch.where(mask & (pos < bcap), pos, bcap)
            bm = torch.full((bcap + 1,), x.shape[0] - 1, dtype=torch.int64,
                            device=x.device)
            bm[pos] = row_ids
            return bm[:bcap], cnt

        ml, cl = pack_map(exp_l)
        mr, cr = pack_map(exp_r)
        return ml, mr, (cl > bcap) | (cr > bcap)

    def _lists(self, x, nloc):
        """Cells and the lists of one domain: (nlist, cell overflow)."""
        p = self.params
        cl = build_cells(self.grid, x)
        if not self._rowlist:
            nlist = build_neighbors(self.grid, cl, x, None, p.cutneigh**2, nloc,
                                    self.acap, self.maxneighs, half=False)
            return nlist, cl.overflow
        rows, numrows, stats, rovf = derive_rowlists_from_cells(
            self.grid, cl, x, nloc, self.acap, self.rcap, p.cutneigh,
            brcap=self.ubr, ucol=self.ucl, zw=self.zw, ccap=self.ccap)
        brows = bcrows = binv = None
        if self.rbuckets is not None:
            brows, bcrows, binv, bovf = bucket_maps_core(
                rows, numrows, self.acap // 8, 2, x.shape[0] // 8, *self.rbuckets)
            rovf = rovf | bovf
        dummy = torch.zeros((1, 8), dtype=torch.int64, device=x.device)
        nlist = NeighborList(neighbors=dummy, numneigh=dummy[0],
                             overflow=cl.overflow | rovf, rows=rows, numrows=numrows,
                             brows=brows, bcrows=bcrows, binv=binv, ncmax=stats)
        return nlist, cl.overflow

    def _integrate(self, d: _Dom, first: bool):
        """initialIntegrate (first) or finalIntegrate on the live rows, in
        place (reference integrate.c:21-40)."""
        live = self._live(d.nloc, self.acap)[:, None]
        d.v.copy_(torch.where(live, d.v + self.dtforce * d.f, d.v))
        if first:
            xl = d.x[: self.acap]
            xl.copy_(torch.where(live, xl + self.params.dt * d.v, xl))

    # ---- mesh phases: every held domain, then the exchange ----------------

    def _migrate(self, xs, vs, ns):
        """Move the atoms that crossed a domain face to the neighbouring
        domain, one hop per mesh axis (parallel/common.migrate). Returns new
        (xs, vs, ns, overflow flags), each x of the full row layout."""
        ovfs = None
        for s in range(self.k):
            xs, vs, ns, o = migrate(self.exchange, xs, vs, ns, self.acap, self.migcap,
                                    self.w[s], s)
            ovfs = o if ovfs is None else [a | b for a, b in zip(ovfs, o)]
        out_x = []
        for x in xs:
            x_full = torch.full((self.nrows, 3), SENTINEL_COORD, dtype=x.dtype,
                                device=x.device)
            x_full[: self.acap] = x
            out_x.append(x_full)
        return out_x, vs, ns, ovfs

    def _exchange_stage(self, xs, maps, s: int):
        """Stage s's ghost refresh: gather the exported rows, move them
        across the face along box dimension s, shift both ways along mesh
        axis s, write stage s's ghost rows in place. Domain-local frames
        make a +-w shift right for every neighbour pair, the periodic wrap
        included."""
        w = self.w[s]
        send_l, send_r = [], []
        for x, (ml, mr) in zip(xs, maps):
            t = x[ml]
            t[:, s] += w  # to the LEFT neighbour: its right side
            send_l.append(t)
            t = x[mr]
            t[:, s] -= w  # to the RIGHT neighbour: its left side
            send_r.append(t)
        from_right = self.exchange.shift(send_l, -1, s)
        from_left = self.exchange.shift(send_r, +1, s)
        g0, bcap = self._stage_base(s), self.bcaps[s]
        for x, fl, fr in zip(xs, from_left, from_right):
            x[g0 : g0 + bcap] = fl
            x[g0 + bcap : g0 + 2 * bcap] = fr
        return xs

    def _refresh_ghosts(self, doms):
        """The per-step ghost refresh of every held domain after the first
        integration: the halo, then the stages in order."""
        for d in doms:
            if d.halo is not None:
                update_pbc(d.x, d.halo, self.acap)
        xs = [d.x for d in doms]
        for s in range(self.k):
            self._exchange_stage(xs, [d.maps[s] for d in doms], s)

    def _fp_exchange(self, fps, doms):
        """The ghost fp between the EAM passes, staged as the coordinates
        are (the multi-device force_eam.c:117-120): the halo ghosts from
        their owners, then each stage's ghosts over the exchange, in place
        (no shift: fp is translation invariant)."""
        acap = self.acap
        for fp, d in zip(fps, doms):
            if d.halo is not None:
                ghost_fp_refresh(fp, d.halo.border_map, acap)
        for s in range(self.k):
            g0, bcap = self._stage_base(s), self.bcaps[s]
            from_right = self.exchange.shift([fp[d.maps[s][0]] for fp, d in zip(fps, doms)],
                                             -1, s)
            from_left = self.exchange.shift([fp[d.maps[s][1]] for fp, d in zip(fps, doms)],
                                            +1, s)
            for fp, fl, fr in zip(fps, from_left, from_right):
                fp[g0 : g0 + bcap] = fl
                fp[g0 + bcap : g0 + 2 * bcap] = fr
        return fps

    def _reneighbor(self, xs, vs, ns, with_stats: bool = False):
        """The rebuild of every held domain. Returns a list of _Dom with f
        None and the rebuild's flags as ovf; with_stats also the per-domain
        (numrows, build stats, halo ghosts, then per stage the larger
        export count) of the calibration."""
        p = self.params
        with region("reneighbor"):
            if self.k < 3:
                wrap = [(d, self.prd[d]) for d in range(self.k, 3)]
                xs = [wrap_dims(x, n, wrap) for x, n in zip(xs, ns)]
            xs, vs, ns, ovf_m = self._migrate(xs, vs, ns)
            if self._rowlist:
                xv = [resort_by_cell(self.grid, x, v, n, self.acap)
                      for x, v, n in zip(xs, vs, ns)]
                xs, vs = [a for a, _ in xv], [b for _, b in xv]
            halos = [self._build_halo(x, n) for x, n in zip(xs, ns)]
            xs = [h[0] for h in halos]
            ovf_g = [torch.zeros((), dtype=torch.bool, device=x.device) if h is None
                     else h.overflow for x, (_, h) in zip(xs, halos)]
            maps = [[] for _ in xs]
            for s in range(self.k):
                stage = [self._export_maps(x, s) for x in xs]
                for i, (ml, mr, o) in enumerate(stage):
                    maps[i].append((ml, mr))
                    ovf_g[i] = ovf_g[i] | o
                self._exchange_stage(xs, [m[s] for m in maps], s)
            doms, stats = [], []
            for x, v, n, (_, halo), mp, og, om in zip(xs, vs, ns, halos, maps, ovf_g, ovf_m):
                nlist, cell_ovf = self._lists(x, n)
                ovf = torch.stack([om, og, cell_ovf, nlist.overflow])
                doms.append(_Dom(x, v, None, n, halo, tuple(mp), nlist, ovf))
                if with_stats:
                    sent = x.shape[0] - 1
                    nghost = (torch.zeros((), dtype=torch.int64, device=x.device)
                              if halo is None else halo.nghost)
                    nbs = [torch.maximum((ml != sent).sum(), (mr != sent).sum())
                           for ml, mr in mp]
                    stats.append((nlist.numrows, nlist.ncmax, nghost, *nbs))
        return (doms, stats) if with_stats else doms

    def _forces(self, doms):
        """The forces (acap, 3) of every held domain."""
        p = self.params
        cutsq = p.cutforce**2
        with region("force"):
            if self.eam_dev is not None:
                passes = [eam_density(d.x, d.nlist.neighbors, d.nlist.numneigh, self.acap,
                                      cutsq, self.eam_dev, self.eam_poly) for d in doms]
                fps = self._fp_exchange([fp for _, fp in passes], doms)
                return [eam_pair_forces(st, fp, d.nlist.neighbors, self.eam_poly)
                        for (st, _), fp, d in zip(passes, fps, doms)]
            if self._rowlist:
                return [compute_force_lj_rowlist(
                    d.x, d.nlist.rows, d.nlist.numrows, self.acap, cutsq, p.sigma6,
                    p.epsilon, approx_rcp=p.approx_rcp, buckets=self.rbuckets,
                    brows=d.nlist.brows, bcrows=d.nlist.bcrows, binv=d.nlist.binv)
                    for d in doms]
            return [compute_force_lj_full(d.x, d.nlist.neighbors, d.nlist.numneigh,
                                          self.acap, cutsq, p.sigma6, p.epsilon)
                    for d in doms]

    def _temperature(self, doms):
        """The temperature, a 0-d tensor (the kinetic energy's psum)."""
        vsq = []
        for d in doms:
            live = self._live(d.nloc, self.acap)[:, None]
            vsq.append(torch.sum(torch.where(live, d.v * d.v, 0.0)) * self.params.mass)
        return self.exchange.psum(vsq)[0] * self.scales.t_scale

    # ---- the run --------------------------------------------------------------

    def initial_state(self, xs=None, vs=None, ns=None) -> list:
        """The first rebuild and forces of every held domain from (xs, vs,
        ns), by default the t = 0 atoms (x0, v0, n0); the inputs are not
        changed."""
        xs = [x.clone() for x in (self.x0 if xs is None else xs)]
        doms = self._reneighbor(xs, self.v0 if vs is None else vs,
                                self.n0 if ns is None else ns)
        return [d._replace(f=f) for d, f in zip(doms, self._forces(doms))]

    def _plain_step(self, doms, temps: list):
        for d in doms:
            self._integrate(d, True)
        self._refresh_ghosts(doms)
        doms = [d._replace(f=f) for d, f in zip(doms, self._forces(doms))]
        for d in doms:
            self._integrate(d, False)
        temps.append(self._temperature(doms) if self.params.dense_thermo else None)
        return doms

    def _reneigh_step(self, doms, temps: list):
        for d in doms:
            self._integrate(d, True)
        new = self._reneighbor([d.x for d in doms], [d.v for d in doms],
                               [d.nloc for d in doms])
        new = [n._replace(f=f, ovf=d.ovf | n.ovf)
               for d, n, f in zip(doms, new, self._forces(new))]
        for d in new:
            self._integrate(d, False)
        temps.append(self._temperature(new))
        return new

    def _run_steps(self, doms, ntimes: int):
        """max(ntimes // reneigh_every, 1) intervals of (reneigh_every - 1)
        plain steps and one rebuild step, as mdbench_tpu's run program
        (its _make_run_fn). Consumes `doms`. Returns (doms, temps), temps
        a device tensor with one entry a step (0 where not taken)."""
        every = self.params.reneigh_every
        temps: list = []
        for _ in range(max(ntimes // every, 1)):
            for _ in range(every - 1):
                doms = self._plain_step(doms, temps)
            doms = self._reneigh_step(doms, temps)
        zero = torch.zeros((), dtype=self.params.dtype, device=self.device)
        return doms, torch.stack([zero if t is None else t for t in temps])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gather(self, vals) -> np.ndarray:
        """The values of all domains on the host, stacked."""
        return torch.stack(self.exchange.all_gather(vals)).cpu().numpy()

    def _overflowed(self, doms) -> np.ndarray:
        """(ndev, 4) bool flags of every domain (read on the host)."""
        return self._gather([d.ovf.to(torch.int32) for d in doms]).astype(bool)

    @staticmethod
    def _state(doms):
        rl = doms[0].nlist.rows is not None
        return MeshDomainState(
            x=tuple(d.x for d in doms), v=tuple(d.v for d in doms),
            f=tuple(d.f for d in doms), nlocal=tuple(d.nloc for d in doms),
            halo_map=tuple(None if d.halo is None else d.halo.border_map for d in doms),
            maps=tuple(d.maps for d in doms),
            neighbors=tuple(d.nlist.rows if rl else d.nlist.neighbors for d in doms),
            numneigh=tuple(d.nlist.numrows if rl else d.nlist.numneigh for d in doms),
            overflow=tuple(d.ovf for d in doms),
        )

    def _grow_and_reinit(self, state=None, xv=None, flags=None):
        """Capacity-overflow retry (the single-device engines' grow and
        retry): every data-dependent capacity grows 1.4x, whichever
        overflowed (as in mdbench_tpu), the row layout is recomputed and the
        domains re-initialised; rcap grows to at least the failed run's
        OBSERVED maxima when its state is given. xv: global (x, v) to
        re-init from instead of t = 0 (a chunk boundary of run_chunked).
        `flags` (ndev, 4), the failed run's, are recorded in `grows`."""
        if flags is not None:
            self.grows.append(tuple(n for n, f in zip(FLAGS, flags.any(axis=0)) if f))
        self.acap = (int(self.acap * 1.4) + 39) // 8 * 8
        if self.k < 3:
            self.gcap = int(self.gcap * 1.4) + 32
        self.bcaps = [int(b * 1.4) + 32 for b in self.bcaps]
        self.migcap = int(self.migcap * 1.4) + 32
        self.maxneighs = (int(self.maxneighs * 1.4) + 7) // 8 * 8
        self.rcap = int(self.rcap * 1.6 + 7) // 8 * 8
        self.ccap = int(self.ccap * 1.5 + 7) // 8 * 8
        if state is not None and self._rowlist:
            nrmax = int(self._gather([n.max() for n in state.numneigh]).max())
            self.rcap = max(self.rcap, (int(nrmax * 1.5) + 7) // 8 * 8)
        self.ucl += 2
        self.zw += 1
        self.ubr += 8
        # acap grew, so the static bucket plan's sizes no longer sum to the
        # domain's units: drop it (the flat force)
        self.rbuckets = None
        self._fix_row_layout()
        self.grid = self.grid._replace(capacity=int(self.grid.capacity * 1.5 + 7) // 8 * 8)
        self._init_host_state(*(xv if xv is not None else self._xv_init))

    def _calibrate(self, ntimes: int, retries: int = 4) -> None:
        """Once, on the row-list path: a throwaway reneighbour interval
        from t = 0 at the generous initial caps, one more rebuild of its
        final atoms with the build stats, and from those melted maxima
        rcap / ccap / ucl / zw / ubr, the halo and face-export caps (floors
        GHOST_FLOOR and BORDER_FLOOR) and, on the card, the capacity-bucket
        plan (parallel/common.apply_rowlist_caps); then the domains are
        re-initialised. The planar path skips it."""
        if self._calibrated or not self._rowlist:
            return
        self._calibrated = True
        every = self.params.reneigh_every
        if ntimes < every:
            return
        state = self._run_raw(every, repeats=0, retries=retries).state
        _, obs = self._reneighbor(list(state.x), list(state.v), list(state.nlocal),
                                  with_stats=True)
        nr = self._gather([o[0] for o in obs])
        st = self._gather([o[1] for o in obs])
        self.rbuckets = apply_rowlist_caps(self, nr, st, want_buckets=self._on_card)
        if self.k < 3:
            ng = int(self._gather([o[2] for o in obs]).max())
            self.gcap = calibrated_block_cap(ng, self.GHOST_FLOOR)
        self.bcaps = [calibrated_block_cap(int(self._gather([o[3 + s] for o in obs]).max()),
                                           self.BORDER_FLOOR) for s in range(self.k)]
        self._fix_row_layout()
        self._init_host_state(*self._xv_init)

    def run(self, ntimes: Optional[int] = None, repeats: int = 1, chain: int = 1,
            retries: int = 6) -> DomainResult:
        """Run `ntimes` steps (a multiple of reneigh_every). Set-up
        calibrates once (the row-list path); an un-timed run then checks
        the whole trajectory for overflow (grow from its final state and
        retry) and gives the temperatures. The timed region is `repeats`
        regions of `chain` back-to-back runs, each from a fresh initial
        state built before the region, fenced with a device synchronise;
        total_time is the median region time / chain, NaN with repeats=0
        (no timed region). setup_time is the seconds from the call to the
        checked run's start (the calibration, grows, the initial state;
        synchronised)."""
        ntimes = self.params.ntimes if ntimes is None else ntimes
        t_setup = time.perf_counter()
        self._calibrate(ntimes)
        return self._run_raw(ntimes, repeats, chain, retries, t_setup)

    def _run_raw(self, ntimes: int, repeats: int = 0, chain: int = 1,
                 retries: int = 6, t_setup=None) -> DomainResult:
        for _ in range(retries + 1):
            s0 = self.initial_state()
            if t_setup is not None:
                self._sync()
                self.setup_time = time.perf_counter() - t_setup
            doms, temps = self._run_steps(s0, ntimes)
            state = self._state(doms)
            flags = self._overflowed(doms)
            if flags.any():
                self._grow_and_reinit(state, flags=flags)
                continue
            temps = temps.cpu().numpy()
            totals = []
            for _r in range(repeats):
                s0s = [self.initial_state() for _ in range(chain)]
                self._sync()
                t0 = time.perf_counter()
                for s0 in s0s:
                    self._run_steps(s0, ntimes)
                self._sync()
                totals.append((time.perf_counter() - t0) / chain)
                del s0s
            return DomainResult(temps=temps, state=state,
                                total_time=float(np.median(totals)) if totals
                                else float("nan"))
        raise RuntimeError(f"{self.KIND} capacity overflow persisted after retries: "
                           + str(self._overflowed(doms)))
