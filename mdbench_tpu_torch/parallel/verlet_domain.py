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

mdbench_tpu runs each device's whole run as one jitted scan inside
`shard_map`, with the collectives in the middle. Here every phase runs
for each domain this process holds, then the exchange, then the next
phase: with `InProcessMesh` all ndev domains live in one process on one
device; with `DistExchange` one domain per rank. With one slab the
exchange still runs: the slab sends its own border rows to itself,
shifted by +-slab_w, and that is how the x seam wraps.

Correctness needs slab width >= cutneigh and atoms that drift at most
one slab per reneighbour interval (flagged). A domain's row layout:

  [0, acap)               local atoms (sentinel padded)
  [acap, acap+gcap)       local y/z ghosts
  [+bcap)                 x-ghosts received from the left neighbour
  [+bcap)                 x-ghosts received from the right neighbour
  [tail]                  sentinel rows (16 on the row-list path, else 1)

Each domain's atom count is a 0-d int64 tensor on the device, never
read on the host inside a run; overflow flags are a (4,) bool tensor per
domain [migration, ghosts, border, lists], read once after a run, which
then grows every capacity and retries (mdbench_tpu's grow-and-reinit).
mdbench_tpu's dropped scatters (`mode="drop"`) write into buffers one row
longer than their capacity whose last row is cut off. The steps update
the domains' x and v in place.

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
    wrap_yz,
)
from mdbench_tpu_torch.parallel.exchange import InProcessMesh
from mdbench_tpu_torch.state import SENTINEL_COORD, Halo, NeighborList
from mdbench_tpu_torch.thermo import adjust_thermo, adjusted_dtforce, setup_thermo
from mdbench_tpu_torch.tracing import region

AXIS = "x"  # the mesh axis (the slabs' normal)
KERNELS = ("auto", "rowlist", "xla")
FLAGS = ("migration", "ghosts", "border", "lists")  # a domain's overflow flags


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


class DomainResult(NamedTuple):
    temps: np.ndarray
    state: DomainState
    total_time: float


class _Dom(NamedTuple):
    """One domain's step state inside a run."""

    x: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor
    nloc: torch.Tensor
    halo: Halo
    bl: torch.Tensor
    br: torch.Tensor
    nlist: NeighborList
    ovf: torch.Tensor


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


class DomainSimulation:
    """The verlet-scheme LJ or EAM simulation over `ndev` x-slabs (module
    docstring).

    `device` is explicit (default "cuda"); asking for a CUDA device
    without one raises, and nothing drops to the CPU. `exchange` is the
    exchange layer (None: an InProcessMesh of ndev domains on `device`);
    its `ndev` must equal `ndev`. Without `x`, the atoms come from the FCC
    lattice, and the velocities are always rescaled, as in mdbench_tpu.
    EAM loads `params.eam_file` and applies initEam's overrides to
    `params` first: pass a fresh `Params` to each engine."""

    def __init__(self, params: Params, ndev: int, x: Optional[np.ndarray] = None,
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
        self.ndev = ndev
        self.slab_w = params.xprd / ndev
        if self.slab_w < params.cutneigh:
            raise ValueError(f"slab width {self.slab_w:.2f} < cutneigh {params.cutneigh}: "
                             "use fewer domains or a larger box")
        if exchange is None:
            exchange = InProcessMesh(ndev, self.device)
        if exchange.ndev != ndev:
            raise ValueError(f"the exchange holds a mesh of {exchange.ndev} domains, "
                             f"not {ndev}")
        self.exchange = exchange
        if x is None:
            x, v, _ = create_fcc_lattice(params)
        self.natoms = x.shape[0]
        self.scales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        v = adjust_thermo(params, self.scales, v, self.natoms)

        plan = plan_capacities(params, ndev, self.natoms)
        self.acap, self.gcap, self.bcap = plan["acap"], plan["gcap"], plan["bcap"]
        self.migcap, self.maxneighs = plan["migcap"], plan["maxneighs"]
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
        self._fix_row_layout()

        # the slab's cell grid (the same geometry on every domain); bin
        # capacity 2.5x the mean: FCC planes alias against the bin
        # boundaries, so some bins run well above it
        box = np.array([self.slab_w, params.yprd, params.zprd])
        nb = [max(1, int(box[d] // params.cutneigh)) for d in range(3)]
        mean = params.rho * (box[0] / nb[0]) * (box[1] / nb[1]) * (box[2] / nb[2])
        self.grid = make_cell_grid(box, params.cutneigh, params.rho,
                                   capacity=int(math.ceil(mean * 2.5 / 8.0)) * 8)
        self._xv_init = (x, v)
        self._init_host_state(x, v)

    # ---- layout and set-up ------------------------------------------------

    def _fix_row_layout(self):
        """The row-list path aligns acap (parallel/common.align_acap), keeps
        the ghost and border blocks in whole 16-atom rows and ends with 16
        sentinel rows (the row lists' padding row); the planar path keeps
        one sentinel row."""
        if self._rowlist:
            self.acap = align_acap(True, self._on_card, self.acap)
            self.gcap = round16(self.gcap)
            self.bcap = round16(self.bcap)
        tail = 16 if self._rowlist else 1
        self.nrows = self.acap + self.gcap + 2 * self.bcap + tail

    def _init_host_state(self, x, v):
        """Each held domain's atoms in its slab frame (x shifted so that the
        slab owns [0, slab_w)): x0, v0, n0, lists over the held domains."""
        p, dev = self.params, self.device
        slab = np.minimum((x[:, 0] / self.slab_w).astype(np.int64), self.ndev - 1)
        self.x0, self.v0, self.n0 = [], [], []
        for d in self.exchange.domains:
            idx = np.nonzero(slab == d)[0]
            n = len(idx)
            if n > self.acap:
                raise RuntimeError(f"slab {d} holds {n} atoms, more than acap {self.acap}")
            xs = np.full((self.nrows, 3), SENTINEL_COORD, np.float64)
            vs = np.zeros((self.acap, 3), np.float64)
            xs[:n] = x[idx] - np.array([d * self.slab_w, 0.0, 0.0])
            vs[:n] = v[idx]
            self.x0.append(torch.as_tensor(xs, dtype=p.dtype, device=dev))
            self.v0.append(torch.as_tensor(vs, dtype=p.dtype, device=dev))
            self.n0.append(torch.tensor(n, dtype=torch.int64, device=dev))

    # ---- per-domain phases --------------------------------------------------

    def _live(self, nloc, n: int):
        return live_rows(nloc, n)

    def _build_halo(self, x, nloc):
        """Local y/z ghosts (setup_pbc with pbc = (0, y, z)) and the two
        x-face export maps over locals and y/z ghosts. Returns (x, halo,
        bmap_l, bmap_r, overflow), x's ghost rows refreshed in place."""
        p = self.params
        acap, gcap, bcap = self.acap, self.gcap, self.bcap
        c = p.cutneigh
        # sentinel padding rows (~1e30) would pass the high-side face tests
        # of setup_pbc and spawn garbage ghosts: it gets a copy with the
        # padding rows at NaN, which fails every face test (mdbench_tpu
        # parks them mid-box, which fails them only where the box is wider
        # than 2 cutneigh: in a thinner box every padding row spawns ghosts)
        x_safe = x.clone()
        x_safe[:acap] = torch.where(self._live(nloc, acap)[:, None], x[:acap],
                                    float("nan"))
        halo = setup_pbc(
            x_safe, acap, acap, gcap, np.array([self.slab_w, p.yprd, p.zprd]),
            (0, p.pbc_y, p.pbc_z), c,
            # the row-list path: cell-sorted ghosts keep ghost 16-rows compact
            sort_grid=self.grid if self._rowlist else None,
        )
        x = update_pbc(x, halo, acap)

        nscan = acap + gcap
        xr = x[:nscan, 0]
        row_ids = torch.arange(nscan, device=x.device)
        row_live = xr.abs() < SENTINEL_COORD * 0.5
        exp_l = row_live & (xr < c)
        exp_r = row_live & (xr >= self.slab_w - c)

        def pack_map(mask):
            pos = torch.cumsum(mask, 0) - 1
            cnt = mask.sum()
            pos = torch.where(mask & (pos < bcap), pos, bcap)
            bm = torch.full((bcap + 1,), x.shape[0] - 1, dtype=torch.int64,
                            device=x.device)
            bm[pos] = row_ids
            return bm[:bcap], cnt

        bmap_l, cl = pack_map(exp_l)
        bmap_r, cr = pack_map(exp_r)
        return x, halo, bmap_l, bmap_r, halo.overflow | (cl > bcap) | (cr > bcap)

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
        """Move the atoms that crossed a slab face to the neighbouring
        domain (parallel/common.migrate). Returns new (xs, vs, ns, overflow
        flags), each x of the full row layout."""
        xs, vs, ns, ovfs = migrate(self.exchange, xs, vs, ns, self.acap, self.migcap,
                                   self.slab_w)
        out_x = []
        for x in xs:
            x_full = torch.full((self.nrows, 3), SENTINEL_COORD, dtype=x.dtype,
                                device=x.device)
            x_full[: self.acap] = x
            out_x.append(x_full)
        return out_x, vs, ns, ovfs

    def _exchange_borders(self, xs, bls, brs):
        """The per-step x-ghost refresh: gather the exported rows, move them
        across the periodic seam, shift both ways, write the x-ghost rows
        in place. Slab-local frames make a +-slab_w shift right for every
        neighbour pair, the wrap between domain ndev-1 and 0 included."""
        send_l, send_r = [], []
        for x, bl, br in zip(xs, bls, brs):
            s = x[bl]
            s[:, 0] += self.slab_w  # to the LEFT neighbour: its right side
            send_l.append(s)
            s = x[br]
            s[:, 0] -= self.slab_w  # to the RIGHT neighbour: its left side
            send_r.append(s)
        from_right = self.exchange.shift(send_l, -1)
        from_left = self.exchange.shift(send_r, +1)
        g0, bcap = self.acap + self.gcap, self.bcap
        for x, fl, fr in zip(xs, from_left, from_right):
            x[g0 : g0 + bcap] = fl
            x[g0 + bcap : g0 + 2 * bcap] = fr
        return xs

    def _fp_exchange(self, fps, doms):
        """The ghost fp between the EAM passes: local y/z ghosts from their
        owners, then the x-border fp over the exchange (the multi-device
        force_eam.c:117-120), in place."""
        acap, g0, bcap = self.acap, self.acap + self.gcap, self.bcap
        for fp, d in zip(fps, doms):
            ghost_fp_refresh(fp, d.halo.border_map, acap)
        from_right = self.exchange.shift([fp[d.bl] for fp, d in zip(fps, doms)], -1)
        from_left = self.exchange.shift([fp[d.br] for fp, d in zip(fps, doms)], +1)
        for fp, fl, fr in zip(fps, from_left, from_right):
            fp[g0 : g0 + bcap] = fl
            fp[g0 + bcap : g0 + 2 * bcap] = fr
        return fps

    def _reneighbor(self, xs, vs, ns, with_stats: bool = False):
        """The rebuild of every held domain. Returns a list of _Dom with f
        None and the rebuild's flags as ovf; with_stats also the per-domain
        (numrows, build stats, nghost, border count) of the calibration."""
        p = self.params
        with region("reneighbor"):
            xs = [wrap_yz(x, n, p.yprd, p.zprd) for x, n in zip(xs, ns)]
            xs, vs, ns, ovf_m = self._migrate(xs, vs, ns)
            if self._rowlist:
                xv = [resort_by_cell(self.grid, x, v, n, self.acap)
                      for x, v, n in zip(xs, vs, ns)]
                xs, vs = [a for a, _ in xv], [b for _, b in xv]
            halos = [self._build_halo(x, n) for x, n in zip(xs, ns)]
            xs = self._exchange_borders([h[0] for h in halos], [h[2] for h in halos],
                                        [h[3] for h in halos])
            doms, stats = [], []
            for x, v, n, (_, halo, bl, br, ovf_g), om in zip(xs, vs, ns, halos, ovf_m):
                nlist, cell_ovf = self._lists(x, n)
                ovf = torch.stack([om, ovf_g, cell_ovf, nlist.overflow])
                doms.append(_Dom(x, v, None, n, halo, bl, br, nlist, ovf))
                if with_stats:
                    sent = x.shape[0] - 1
                    nb = torch.maximum((bl != sent).sum(), (br != sent).sum())
                    stats.append((nlist.numrows, nlist.ncmax, halo.nghost, nb))
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
            update_pbc(d.x, d.halo, self.acap)
        self._exchange_borders([d.x for d in doms], [d.bl for d in doms],
                               [d.br for d in doms])
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
        """The values of all ndev domains on the host, stacked."""
        return torch.stack(self.exchange.all_gather(vals)).cpu().numpy()

    def _overflowed(self, doms) -> np.ndarray:
        """(ndev, 4) bool flags of every domain (read on the host)."""
        return self._gather([d.ovf.to(torch.int32) for d in doms]).astype(bool)

    @staticmethod
    def _state(doms) -> DomainState:
        rl = doms[0].nlist.rows is not None
        return DomainState(
            x=tuple(d.x for d in doms), v=tuple(d.v for d in doms),
            f=tuple(d.f for d in doms), nlocal=tuple(d.nloc for d in doms),
            halo_map=tuple(d.halo.border_map for d in doms),
            halo_shift=tuple(d.halo.shift for d in doms),
            bmap_l=tuple(d.bl for d in doms), bmap_r=tuple(d.br for d in doms),
            neighbors=tuple(d.nlist.rows if rl else d.nlist.neighbors for d in doms),
            numneigh=tuple(d.nlist.numrows if rl else d.nlist.numneigh for d in doms),
            overflow=tuple(d.ovf for d in doms),
        )

    def _grow_and_reinit(self, state: Optional[DomainState] = None, xv=None,
                         flags=None):
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
        self.gcap = int(self.gcap * 1.4) + 32
        self.bcap = int(self.bcap * 1.4) + 32
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
        rcap / ccap / ucl / zw / ubr, the ghost and border caps and, on the
        card, the capacity-bucket plan (parallel/common.apply_rowlist_caps);
        then the domains are re-initialised. The planar path skips it."""
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
        ng = int(self._gather([o[2] for o in obs]).max())
        nb = int(self._gather([o[3] for o in obs]).max())
        self.rbuckets = apply_rowlist_caps(self, nr, st, want_buckets=self._on_card)
        self.gcap = calibrated_block_cap(ng, 256)
        self.bcap = calibrated_block_cap(nb, 128)
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
        (no timed region)."""
        ntimes = self.params.ntimes if ntimes is None else ntimes
        self._calibrate(ntimes)
        return self._run_raw(ntimes, repeats, chain, retries)

    def _run_raw(self, ntimes: int, repeats: int = 0, chain: int = 1,
                 retries: int = 6) -> DomainResult:
        for _ in range(retries + 1):
            doms, temps = self._run_steps(self.initial_state(), ntimes)
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
        raise RuntimeError("domain capacity overflow persisted after retries: "
                           + str(self._overflowed(doms)))

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
