"""The verlet-scheme simulation engine (the port of ``mdbench_tpu.engine``;
reference src/verletlist/main.c:129-344):

  setup -> force(step 0) ->
  loop n = 0 .. ntimes - 1:
      initialIntegrate
      (n + 1) % reneigh_every == 0 ? reneighbour : updatePbc
      computeForce
      finalIntegrate

A reneighbour wraps the atoms into the box, rebuilds the ghosts and the
lists, and on the rowlist path first re-sorts the local atoms by bin
(every reneighbour there, as mdbench_tpu does: the row lists assume
bin-sorted atoms). Two force paths, as in mdbench_tpu:

- the rowlist path (kernel "rowlist" or "auto"; full lists, one atom
  type, LJ): per 16-atom unit the 16-atom rows it interacts with
  (ops/verlet.derive_rowlists_from_ranges with sort_atoms, else
  derive_rowlists_from_cells), and the exact-list LJ force with share 2:
  on a CUDA tensor the K1 kernel, or K1b once the melt calibration has
  planned capacity buckets; on the CPU their plain twins. mdbench_tpu
  takes this path for "auto" only on a TPU, and its kernel only in SP;
  the port takes it for "auto" on every device and launches the kernels
  on a CUDA tensor in SP and DP;
- the planar path (kernel "xla", half lists, more than one atom type, or
  EAM): per-atom lists and the planar torch forces of ops/lj.py, or the
  two-pass EAM force of ops/eam.py (the reference's splines, or with
  eam_eval "poly", or "auto" in SP on the card, the fitted pair
  polynomials): on a CUDA tensor the kernels K5 (density and F'(rho))
  and K6 (pair force), on the CPU their plain versions, with the ghost-fp
  refresh between them reading the halo's border_map.

The time-step loop is a Python loop of eager torch ops on `device`
(mdbench_tpu compiled it into nested lax.scans). The integration and the
ghost refresh update the state's tensors IN PLACE: a state passed to
`_run_steps` is consumed. Capacity overflows raise a device flag that is
read on the host only after a run (and at the calibrations), as in
mdbench_tpu; the host then grows the capacities and retries. Each phase of
a step runs inside a tracing.region span ("reneighbor" and its children,
"force", "integrate", "halo_update", "thermo"; tracing.py lists them),
spans of a profile and nothing outside one.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mdbench_tpu_torch.config import FF_EAM, FF_LJ, Params
from mdbench_tpu_torch.engine_cluster import check_slice
from mdbench_tpu_torch.io.readers import read_atom
from mdbench_tpu_torch.models.eam_tables import (
    apply_eam_overrides,
    fit_eam_poly,
    load_eam,
)
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops import lj as lj_ops
from mdbench_tpu_torch.ops.cells import (
    CellGrid,
    build_cells,
    make_cell_grid,
    sort_atoms_device,
    sort_atoms_host,
)
from mdbench_tpu_torch.ops.cluster import bucket_maps_core, plan_capacity_buckets
from mdbench_tpu_torch.ops.eam import (
    EamDevice,
    compute_force_eam,
    compute_force_eam_poly,
    use_poly_eval,
)
from mdbench_tpu_torch.ops.integrate import (
    final_integrate,
    initial_integrate,
    wrap_into_box,
)
from mdbench_tpu_torch.ops.pbc import ghost_types, setup_pbc, update_pbc
from mdbench_tpu_torch.ops.verlet import (
    build_neighbors,
    compute_force_lj_rowlist,
    derive_rowlists_from_cells,
    derive_rowlists_from_ranges,
)
from mdbench_tpu_torch.state import SENTINEL_COORD, Halo, NeighborList, TypeTables
from mdbench_tpu_torch.thermo import (
    ThermoScales,
    adjust_thermo,
    adjusted_dtforce,
    setup_thermo,
)
from mdbench_tpu_torch.tracing import region

# the force-kernel names of mdbench_tpu's verlet engine
KERNELS = ("auto", "rowlist", "xla")


class Capacities(NamedTuple):
    """Padded sizes; each grows on overflow."""

    nlocal_pad: int
    ghost: int
    maxneighs: int
    cell: int


class StepState(NamedTuple):
    x: torch.Tensor  # (nrows, 3): locals, ghosts, sentinel rows
    v: torch.Tensor  # (nlocal_pad, 3)
    f: torch.Tensor  # (nlocal_pad, 3)
    types: torch.Tensor  # (nrows,) int32
    halo: Halo
    nlist: NeighborList
    overflow: torch.Tensor  # () bool, accumulated


class RunResult(NamedTuple):
    temps: np.ndarray  # (ntimes,) temperature after each step (0 if not taken)
    press: np.ndarray  # (ntimes,)
    state: StepState
    total_time: float


def _estimate_maxneighs(params: Params) -> int:
    """Atoms in the cutneigh sphere with headroom, at least the
    reference's 100 (neighbor.c:59)."""
    vol = 4.0 / 3.0 * np.pi * params.cutneigh**3
    est = int(np.ceil(vol * params.rho * 1.25))
    if params.half_neigh:
        est = int(np.ceil(est * 0.6))
    return max(params.maxneighs, ((est + 7) // 8) * 8)


def _estimate_ghost_capacity(params: Params, nlocal: int) -> int:
    c = params.cutneigh
    fx = 1.0 + 2.0 * c / params.xprd
    fy = 1.0 + 2.0 * c / params.yprd
    fz = 1.0 + 2.0 * c / params.zprd
    est = int(np.ceil(nlocal * (fx * fy * fz - 1.0) * 1.5)) + 64
    return ((est + 7) // 8) * 8


class Simulation:
    """The verlet-scheme LJ or EAM simulation on one torch device.

    `device` is explicit (default "cuda"); asking for a CUDA device
    without one raises, and nothing drops to the CPU. Without `x`, the
    atoms come from `params.input_file` (not rescaled unless `adjust`)
    or else from the FCC lattice (rescaled). `params.kernel` is one of
    KERNELS (module docstring). EAM loads `params.eam_file` and applies
    initEam's overrides to `params` before the lattice is made, as
    mdbench_tpu does: pass a fresh `Params` to each engine."""

    def __init__(
        self,
        params: Params,
        x: Optional[np.ndarray] = None,
        v: Optional[np.ndarray] = None,
        types: Optional[np.ndarray] = None,
        adjust: Optional[bool] = None,
        device="cuda",
    ):
        check_slice(params)
        if params.scheme != "verlet":
            raise ValueError("engine.Simulation runs scheme='verlet'; the cluster "
                             "scheme runs on engine_cluster.ClusterSimulation")
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
        self.eam_tables = self.eam_poly = None
        if params.force_field == FF_EAM:
            # the funcfl file's overrides set rho, so they come before the
            # lattice (reference setup() calls initEam first, main.c:38)
            if not params.eam_file:
                raise ValueError("force_field=eam requires eam_file")
            self.eam_tables = load_eam(params.eam_file)
            apply_eam_overrides(params, self.eam_tables)
            if use_poly_eval(params, self.device):
                self.eam_poly = fit_eam_poly(self.eam_tables)
        if x is None and params.input_file:
            r = read_atom(params)
            x, v, types = r.x, r.v, r.types
            if adjust is None:
                adjust = False
        if x is None:
            x, v, types = create_fcc_lattice(params)
            if adjust is None:
                adjust = True
        self.natoms = self.nlocal = x.shape[0]
        self.scales: ThermoScales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        if adjust:
            v = adjust_thermo(params, self.scales, v, self.natoms)
        if types is None:
            types = np.zeros(self.nlocal, np.int32)

        prd = np.array([params.xprd, params.yprd, params.zprd])
        self.prd = prd
        self.grid: CellGrid = make_cell_grid(prd, params.cutneigh, params.rho, 0)
        if params.sort_atoms:
            # sort by the wrapped position (the key only): the rebuild wraps
            # before it bins, and the range build needs bin-sorted atoms
            xw = np.where(x < 0.0, x + prd, x)
            xw = np.where(xw >= prd, xw - prd, xw)
            perm = sort_atoms_host(self.grid, xw)
            x, v, types = x[perm], v[perm], types[perm]
        self._x0, self._v0, self._types0 = x, v, np.asarray(types, np.int32)

        self._rowlist = (params.force_field == FF_LJ and not params.half_neigh
                         and params.ntypes == 1 and params.kernel in ("auto", "rowlist"))
        # the melt calibration and its bucket plan: mdbench_tpu's Pallas
        # backend, here the kernels on the card
        self._on_card = self.device.type == "cuda"
        self.rcap = 64  # row-list capacity
        self.ccap = 128  # candidate rows per unit before the exact prune
        self.ucl = 4  # distinct xy columns per unit
        self.zw = 4  # z-run width (cells build)
        self.ubr = 8  # distinct 16-rows per cell (cells build)
        self.ukr = 40  # candidate row ranges per unit (ranges build)
        self._rowbuild_ranges = self._rowlist and params.sort_atoms
        self.rbuckets = None  # (sizes, caps) capacity buckets, planned once
        self._force_reps = 1  # forces per plain step (cli --timers diff: 2)
        self._rcap_calibrated = False
        self._melt_calibrated = False
        self.setup_time = None  # run()'s set-up seconds (run docstring)
        pad_unit = 1024 if self._rowlist else 256
        self.caps = Capacities(
            nlocal_pad=(self.nlocal + pad_unit - 1) // pad_unit * pad_unit,
            ghost=_estimate_ghost_capacity(params, self.nlocal),
            maxneighs=_estimate_maxneighs(params),
            cell=self.grid.capacity,
        )
        self._build_device_state()

    # -- state assembly ---------------------------------------------------

    def _build_device_state(self):
        p, caps = self.params, self.caps
        dtype, dev = p.dtype, self.device
        self.grid = self.grid._replace(capacity=caps.cell)
        # locals, ghost slots, then >= 16 sentinel rows, rounded so that the
        # last 16-atom row is all sentinel (the row lists' padding id) and
        # the last row the per-atom lists' sentinel row
        nrows = (caps.nlocal_pad + caps.ghost + 16 + 15) // 16 * 16
        xp = np.full((nrows, 3), SENTINEL_COORD, np.float64)
        xp[: self.nlocal] = self._x0
        vp = np.zeros((caps.nlocal_pad, 3), np.float64)
        vp[: self.nlocal] = self._v0
        tp = np.zeros(nrows, np.int32)
        tp[: self.nlocal] = self._types0
        self.x0 = torch.as_tensor(xp, dtype=dtype, device=dev)
        self.v0 = torch.as_tensor(vp, dtype=dtype, device=dev)
        self.types0 = torch.as_tensor(tp, device=dev)
        nt = p.ntypes
        if nt == 1:
            self.tables = None
            self.cutforcesq = p.cutforce**2
            self.cutneighsq = p.cutneigh**2
        else:
            def full(val):
                return torch.full((nt, nt), val, dtype=dtype, device=dev)

            self.tables = TypeTables(
                types=self.types0, epsilon=full(p.epsilon), sigma6=full(p.sigma6),
                cutforcesq=full(p.cutforce**2), cutneighsq=full(p.cutneigh**2))
            self.cutforcesq = self.tables.cutforcesq
            self.cutneighsq = self.tables.cutneighsq
        if self.eam_tables is not None:
            self.eam_dev = EamDevice.from_tables(self.eam_tables, dev, dtype)

    # -- device phases ----------------------------------------------------

    def _reneighbor(self, x, types):
        """Wrap, ghosts, lists (reference reneighbour(), main.c:76-95).
        Returns (x, types, halo, nlist, overflow)."""
        with region("reneighbor"):
            return self._reneighbor_inner(x, types)

    def _reneighbor_inner(self, x, types):
        p, caps = self.params, self.caps
        with region("reneighbor.halo"):
            x = wrap_into_box(x, self.prd, self.nlocal)
            halo = setup_pbc(
                x, self.nlocal, caps.nlocal_pad, caps.ghost, self.prd,
                (p.pbc_x, p.pbc_y, p.pbc_z), p.cutneigh,
                # rowlist path: cell-sorted ghosts keep ghost rows compact;
                # off elsewhere so that the ghost order is the reference's
                sort_grid=self.grid if self._rowlist else None,
            )
            types = ghost_types(types, halo, caps.nlocal_pad)
            x = update_pbc(x, halo, caps.nlocal_pad)
        if not self._rowlist:
            with region("reneighbor.rows"):
                nlist = self.per_atom_lists(x, types)
            return x, types, halo, nlist, halo.overflow | nlist.overflow
        with region("reneighbor.rows"):
            if self._rowbuild_ranges:
                rows, numrows, ncmax, rovf = derive_rowlists_from_ranges(
                    self.grid, x, self.nlocal, caps.nlocal_pad, caps.ghost,
                    self.rcap, p.cutneigh, ucol=self.ucl, kcap=self.ukr,
                    ccap=self.ccap)
            else:
                cl = build_cells(self.grid, x)
                rows, numrows, ncmax, rovf = derive_rowlists_from_cells(
                    self.grid, cl, x, self.nlocal, caps.nlocal_pad, self.rcap,
                    p.cutneigh, brcap=self.ubr, ucol=self.ucl, zw=self.zw,
                    ccap=self.ccap)
                rovf = rovf | cl.overflow
        brows = bcrows = binv = None
        if self.rbuckets is not None:
            with region("reneighbor.buckets"):
                brows, bcrows, binv, bovf = bucket_maps_core(
                    rows, numrows, caps.nlocal_pad // 8, 2, x.shape[0] // 8,
                    *self.rbuckets)
                rovf = rovf | bovf
        dummy = torch.zeros((1, 8), dtype=torch.int64, device=x.device)
        nlist = NeighborList(
            neighbors=dummy, numneigh=dummy[0], overflow=rovf, rows=rows,
            numrows=numrows, brows=brows, bcrows=bcrows, binv=binv, ncmax=ncmax)
        return x, types, halo, nlist, halo.overflow | nlist.overflow

    def per_atom_lists(self, x, types) -> NeighborList:
        """Per-atom verlet lists from current coordinates (the planar
        path's lists; on the rowlist path, which never builds them in its
        loop, for stats and tracing)."""
        return build_neighbors(
            self.grid, build_cells(self.grid, x), x, types, self.cutneighsq,
            self.nlocal, self.caps.nlocal_pad, self.caps.maxneighs,
            half=bool(self.params.half_neigh))

    def _force(self, x, types, nlist: NeighborList, halo: Halo):
        """(nlocal_pad, 3) forces by the path (module docstring)."""
        with region("force"):
            return self._force_inner(x, types, nlist, halo)

    def _force_inner(self, x, types, nlist: NeighborList, halo: Halo):
        p, caps = self.params, self.caps
        if self.eam_tables is not None:
            args = (x, nlist.neighbors, nlist.numneigh, halo.border_map, self.nlocal,
                    caps.nlocal_pad, p.cutforce**2, self.eam_dev)
            if self.eam_poly is not None:
                return compute_force_eam_poly(*args, self.eam_poly)[0]
            return compute_force_eam(*args)[0]
        if p.half_neigh:
            return lj_ops.compute_force_lj_half(
                x, nlist.neighbors, nlist.numneigh, self.nlocal, caps.nlocal_pad,
                self.cutforcesq, p.sigma6, p.epsilon, types=types, tables=self.tables)
        if self._rowlist:
            return compute_force_lj_rowlist(
                x, nlist.rows, nlist.numrows, caps.nlocal_pad, self.cutforcesq,
                p.sigma6, p.epsilon, approx_rcp=p.approx_rcp, buckets=self.rbuckets,
                brows=nlist.brows, bcrows=nlist.bcrows, binv=nlist.binv)
        return lj_ops.compute_force_lj_full(
            x, nlist.neighbors, nlist.numneigh, caps.nlocal_pad, self.cutforcesq,
            p.sigma6, p.epsilon, types=types, tables=self.tables)

    def _thermo(self, v):
        """(t, p) device scalars (reference thermo.c:55-80)."""
        with region("thermo"):
            vl = v[: self.nlocal]
            t = torch.sum(vl * vl) * self.params.mass * self.scales.t_scale
            return t, (t * self.scales.dof_boltz) * self.scales.p_scale

    # -- stepping ----------------------------------------------------------

    def _plain_steps(self, state: StepState, n: int, thermo: list) -> StepState:
        """n steps without a rebuild; appends (t, p), or None when
        dense_thermo is off, per step. With _force_reps > 1 each step chains
        that many forces, each from x + 1e-30 * the previous force (cli
        --timers diff: one extra force a plain step, mdbench_tpu
        engine.py:474-481)."""
        p = self.params
        npad = self.caps.nlocal_pad
        x, v, f = state.x, state.v, state.f
        for _ in range(n):
            with region("integrate"):
                initial_integrate(x, v, f, p.dt, self.dtforce, self.nlocal)
            with region("halo_update"):
                update_pbc(x, state.halo, npad)
            f = self._force(x, state.types, state.nlist, state.halo)
            for _r in range(self._force_reps - 1):
                with region("force"):
                    xx = x.clone()
                    xx[:npad] += 1e-30 * f
                f = self._force(xx, state.types, state.nlist, state.halo)
            with region("integrate"):
                final_integrate(v, f, self.dtforce, self.nlocal)
            thermo.append(self._thermo(v) if p.dense_thermo else None)
        return state._replace(x=x, v=v, f=f)

    def _reneigh_step(self, state: StepState, resort: bool, thermo: list):
        """A step with a rebuild (and before it the re-sort, if `resort`);
        its thermo is always taken (the golden gate reads it)."""
        p = self.params
        with region("integrate"):
            x, v = initial_integrate(state.x, state.v, state.f, p.dt,
                                     self.dtforce, self.nlocal)
        types = state.types
        with region("reneighbor"):
            if resort:
                with region("reneighbor.sort"):
                    # wrap first: the sort must bin atoms where they will sit
                    x = wrap_into_box(x, self.prd, self.nlocal)
                    x, v, types = sort_atoms_device(self.grid, x, v, types,
                                                    self.nlocal)
            x, types, halo, nlist, ovf = self._reneighbor_inner(x, types)
            ovf = state.overflow | ovf
        f = self._force(x, types, nlist, halo)
        with region("integrate"):
            final_integrate(v, f, self.dtforce, self.nlocal)
        thermo.append(self._thermo(v))
        return StepState(x, v, f, types, halo, nlist, ovf)

    def _resort_every(self) -> int:
        p = self.params
        if not p.sort_atoms:
            return 0
        # the rowlist path re-sorts at every rebuild (mdbench_tpu
        # engine.py:440-453: the row lists assume bin-sorted atoms)
        return p.reneigh_every if self._rowlist else p.resort_every

    def _run_steps(self, state: StepState, ntimes: int):
        """`ntimes` steps at mdbench_tpu's cadence: intervals of
        (reneigh_every - 1) plain steps and a rebuild step, which re-sorts
        when its step is a multiple of the resort cadence; then a tail of
        plain steps. Consumes `state`. Returns (state, temps, press), the
        last two device tensors of length ntimes (0 where not taken)."""
        every = self.params.reneigh_every
        resort = self._resort_every()
        thermo: list = []
        for i in range(ntimes // every):
            state = self._plain_steps(state, every - 1, thermo)
            state = self._reneigh_step(
                state, resort > 0 and ((i + 1) * every) % resort == 0, thermo)
        state = self._plain_steps(state, ntimes - ntimes // every * every, thermo)
        with region("thermo"):
            tp = torch.zeros((ntimes, 2), dtype=self.params.dtype, device=self.device)
            for i, t in enumerate(thermo):
                if t is not None:  # a host int index: no copy to the device
                    tp[i] = torch.stack(t)
            return state, tp[:, 0], tp[:, 1]

    # -- run ---------------------------------------------------------------

    def initial_state(self) -> StepState:
        """Ghosts and lists built and the step-0 forces computed
        (reference setup() + the first computeForce, main.c:234-250)."""
        x, types, halo, nlist, ovf = self._reneighbor(self.x0, self.types0)
        f = self._force(x, types, nlist, halo)
        return StepState(x, self.v0.clone(), f, types, halo, nlist, ovf)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _calibrated_state(self, state0: StepState, nsteps: int) -> StepState:
        """The calibrations, once, in mdbench_tpu's order (the row-list
        caps, then the melt probe that plans the buckets), each followed by
        a rebuild of the initial state if it changed a capacity."""
        if self._calibrate_rcap(state0):
            state0 = self.initial_state()
        if nsteps >= self.params.reneigh_every and self._calibrate_melted():
            state0 = self.initial_state()
        return state0

    def run(self, ntimes: Optional[int] = None, max_retries: int = 3,
            repeats: int = 1, chain: int = 1) -> RunResult:
        """Run `ntimes` steps. Set-up builds the initial state and
        calibrates the capacities once; an un-timed run then checks the
        whole trajectory, initial state included, for overflow (grow from
        its final state and retry, as mdbench_tpu does) and gives the
        temperatures. The timed region is
        `repeats` regions of `chain` back-to-back runs, each from a fresh
        initial state built before the region, fenced with a device
        synchronise; total_time is the median region time / chain (the
        TOTAL of ClusterSimulation.run), NaN with repeats=0 (no timed
        region). setup_time is the seconds from the call to the checked
        run's start (initial state, calibrations, grows; synchronised)."""
        p = self.params
        ntimes = p.ntimes if ntimes is None else ntimes
        t_setup = time.perf_counter()
        for _ in range(max_retries + 1):
            state0 = self._calibrated_state(self.initial_state(), ntimes)
            self._sync()
            self.setup_time = time.perf_counter() - t_setup
            state, temps, press = self._run_steps(state0, ntimes)
            if bool(state.overflow):
                self._grow_caps(state)
                continue
            temps, press = temps.cpu().numpy(), press.cpu().numpy()
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
            return RunResult(temps=temps, press=press, state=state,
                             total_time=float(np.median(totals)) if totals
                             else float("nan"))
        raise RuntimeError("capacity overflow persisted after retries")

    def _calibrate_rcap(self, state0: StepState) -> bool:
        """Once: set the row-list capacity to the observed maximum + 50%
        and the candidate cap to the observed maximum + 40% (mdbench_tpu
        engine.py:620-669), or on the planar path shrink the list width to
        the observed maximum + 20%. Returns True if a capacity changed
        (the caller rebuilds)."""
        if self._rcap_calibrated:
            return False
        self._rcap_calibrated = True
        if not self._rowlist:
            kobs = int(state0.nlist.numneigh.max())
            kt = max((int(kobs * 1.2) + 7) // 8 * 8, 16)
            if kt < self.caps.maxneighs:
                self.caps = self.caps._replace(maxneighs=kt)
                self._build_device_state()
                return True
            return False
        nrmax = int(state0.nlist.numrows.max())
        target = max((int(nrmax * 1.5) + 7) // 8 * 8, 16)
        changed = target != self.rcap
        self.rcap = target
        st_ = state0.nlist.ncmax.cpu().numpy()
        ct = max((int(int(st_[0]) * 1.4) + 7) // 8 * 8, 24)
        if ct != self.ccap:
            self.ccap = ct
            changed = True
        changed = self._set_struct_caps(st_) or changed
        if changed:
            self._build_device_state()
        return changed

    def _bucket_plan(self, numrows: np.ndarray):
        """The capacity-bucket plan of the melted lists (mdbench_tpu
        engine.py:725-737: margin 4, a zero tier), None for boxes of fewer
        than 4096 units."""
        return plan_capacity_buckets(numrows, self.rcap, 2, zero_tier=True)

    def _calibrate_melted(self, max_retries: int = 3) -> bool:
        """Once, on the rowlist path on the card: run one reneighbour
        interval from t = 0 and set rcap, the ghost capacity, ccap and the
        structural caps from that melted rebuild, then plan the capacity
        buckets (mdbench_tpu engine.py:671-742). The probe runs on a fresh
        initial state (the caller's is not consumed). Returns True if
        anything changed (the caller rebuilds)."""
        if not self._rowlist or self._melt_calibrated or not self._on_card:
            return False
        self._melt_calibrated = True
        every = self.params.reneigh_every
        changed = False
        for _ in range(max_retries + 1):
            st1, _, _ = self._run_steps(self.initial_state(), every)
            if bool(st1.overflow):
                self._grow_caps(st1)
                changed = True
                continue
            nrh = st1.nlist.numrows.cpu().numpy()
            rt = max((int(nrh.max() * 1.3) + 7) // 8 * 8, 16)
            if rt != self.rcap:
                self.rcap = rt
                changed = True
            ng = int(st1.halo.nghost)
            gt = max((int(ng * 1.25) + 15) // 16 * 16, 512)
            if gt != self.caps.ghost:
                self.caps = self.caps._replace(ghost=gt)
                changed = True
            st_ = st1.nlist.ncmax.cpu().numpy()
            ct = max((int(int(st_[0]) * 1.3) + 7) // 8 * 8, 24)
            if ct != self.ccap:
                self.ccap = ct
                changed = True
            changed = self._set_struct_caps(st_) or changed
            plan = self._bucket_plan(nrh)
            if plan != self.rbuckets:
                self.rbuckets = plan
                changed = True
            break
        if changed:
            self._build_device_state()
        return changed

    def _set_struct_caps(self, stats, grow_only: bool = False) -> bool:
        """The row builds' structural caps from a build's observed maxima
        with drift headroom (ranges: [cand, dcol, n_ranges, 0] -> ucl,
        ukr; cells: [cand, dcol, zspan, rows per cell] -> ucl, zw, ubr).
        grow_only never shrinks (the retry path's maxima come from a
        failed build)."""
        dmax, zmax, bmax = int(stats[1]), int(stats[2]), int(stats[3])
        if self._rowbuild_ranges:
            want = {"ucl": max(dmax + 1, 2), "ukr": max((zmax + 6 + 7) // 8 * 8, 16)}
        else:
            want = {"ucl": max(dmax + 1, 2), "zw": max(zmax + 3, 3),
                    "ubr": max(bmax + 2, 4)}
        changed = False
        for name, w in want.items():
            cur = getattr(self, name)
            if w > cur or (not grow_only and w < cur):
                setattr(self, name, w)
                changed = True
        return changed

    def _grow_caps(self, state: Optional[StepState] = None):
        """Grow every capacity that can overflow (reference RESIZE), rcap
        and ccap to at least the failed state's observed maxima + margin
        when it is given, and rebuild the device state (mdbench_tpu
        engine.py:773-809)."""
        self.caps = self.caps._replace(
            ghost=int(self.caps.ghost * 1.5),
            maxneighs=int(self.caps.maxneighs * 1.3) // 8 * 8 + 8,
            cell=int(self.caps.cell * 1.5) // 8 * 8 + 8,
        )
        self.rcap = int(self.rcap * 1.6 + 7) // 8 * 8
        self.ccap = int(self.ccap * 1.5 + 7) // 8 * 8
        grew_struct = False
        if state is not None and self._rowlist:
            nrmax = int(state.nlist.numrows.max())
            self.rcap = max(self.rcap, (int(nrmax * 1.5) + 7) // 8 * 8)
            st_ = state.nlist.ncmax.cpu().numpy()
            self.ccap = max(self.ccap, (int(int(st_[0]) * 1.4) + 7) // 8 * 8)
            grew_struct = self._set_struct_caps(st_, grow_only=True)
        if not grew_struct:
            self.ucl += 2
            self.zw += 1
            self.ubr += 8
            self.ukr += 16
        if self.rbuckets is not None:
            # every bucket cap widens by 8, the last follows rcap
            sizes, caps = self.rbuckets
            self.rbuckets = (sizes, tuple(c + 8 for c in caps[:-1]) + (self.rcap,))
        self._build_device_state()

    def _restart_from(self, xb, vb, tb, failed_state=None,
                      max_retries: int = 3) -> StepState:
        """Grow the capacities and rebuild a runnable state from host
        snapshots of the local atoms, which become the engine's t = 0
        arrays (the lists are a function of the positions, so the physics
        is the same)."""
        self._x0, self._v0, self._types0 = xb, vb, tb
        self._grow_caps(failed_state)
        for _ in range(max_retries + 1):
            state = self.initial_state()
            if not bool(state.overflow):
                return state
            self._grow_caps()
        raise RuntimeError("capacity overflow persisted in restart")

    def _snapshot(self, state: StepState):
        """Host copies of the local atoms (x, v, types): float64 and int32
        numpy arrays that own their memory (the steps update the state in
        place, and on the CPU .numpy() would share it)."""
        n = self.nlocal
        return tuple(np.array(t[:n].cpu().numpy(), dtype=dt)
                     for t, dt in ((state.x, np.float64), (state.v, np.float64),
                                   (state.types, np.int32)))

    def run_chunked(self, chunk: int, nchunks: int, callback, max_retries: int = 3,
                    tail: int = 0) -> RunResult:
        """Run nchunks * chunk + tail steps in host-visible chunks (for
        trajectory output; mdbench_tpu engine.py:829-924). callback(state,
        step) runs at step 0 and after every chunk and the tail. Each chunk
        is `_run_steps(chunk)`, so its rebuild cadence counts from the
        chunk's start. Set-up grows until the initial state fits, then
        calibrates as run() does. A chunk that overflows is
        discarded: the capacities grow, the state is rebuilt from the
        chunk's starting boundary (a host snapshot of the local atoms) and
        the chunk replays. total_time is the host time from the first
        chunk to the end, callbacks included."""
        for _ in range(max_retries + 1):
            state = self.initial_state()
            if bool(state.overflow):
                self._grow_caps()
                continue
            state = self._calibrated_state(state, nchunks * chunk + tail)
            break
        else:
            raise RuntimeError("capacity overflow persisted after retries")
        callback(state, 0)
        temps_all, press_all = [], []
        t0 = time.perf_counter()
        retries = 0
        lengths = [chunk] * nchunks + ([tail] if tail else [])
        c = 0
        while c < len(lengths):
            snap = self._snapshot(state)  # the chunk consumes the state
            state, temps, press = self._run_steps(state, lengths[c])
            if bool(state.overflow):
                retries += 1
                if retries > max_retries:
                    raise RuntimeError("capacity overflow persisted in run_chunked")
                state = self._restart_from(*snap, state, max_retries)
                continue  # replay chunk c from its boundary
            c += 1
            callback(state, sum(lengths[:c]))
            temps_all.append(temps.cpu().numpy())
            press_all.append(press.cpu().numpy())
        self._sync()
        total = time.perf_counter() - t0
        empty = np.zeros((0,))
        return RunResult(
            temps=np.concatenate(temps_all) if temps_all else empty,
            press=np.concatenate(press_all) if press_all else empty,
            state=state, total_time=total,
        )

    def measure_phases(self, state: StepState, reps: int = 20):
        """Out-of-band FORCE and NEIGH times in seconds per call
        (mdbench_tpu engine.py:926-971): `reps` chained forces on `state`'s
        lists, each fed x + 1e-30 * the previous force's f[0, 0], and
        max(reps // 4, 1) rebuilds (_reneighbor, no re-sort) from state.x,
        chained the same way through the first list length. Each is run
        once to warm up, then timed between device synchronisations.
        `state` is not changed."""
        def force_reps():
            x = state.x
            for _ in range(reps):
                f = self._force(x, state.types, state.nlist, state.halo)
                x = x + 1e-30 * f[0, 0]

        n_neigh = max(reps // 4, 1)

        def neigh_reps():
            x, types = state.x, state.types
            for _ in range(n_neigh):
                x, types, _, nlist, _ = self._reneighbor(x, types)
                n0 = (nlist.numrows if self._rowlist else nlist.numneigh)[0]
                x = x + 1e-30 * n0.to(x.dtype)

        times = []
        for fn, n in ((force_reps, reps), (neigh_reps, n_neigh)):
            fn()
            self._sync()
            t0 = time.perf_counter()
            fn()
            self._sync()
            times.append((time.perf_counter() - t0) / n)
        return times[0], times[1]

    # convenience ----------------------------------------------------------

    def first_force(self) -> np.ndarray:
        """Step-0 forces of the local atoms in the engine's (sorted) atom
        order, float64 numpy."""
        for _ in range(5):
            state = self.initial_state()
            if not bool(state.overflow):
                return state.f[: self.nlocal].double().cpu().numpy()
            self._grow_caps()
        raise RuntimeError("capacity overflow persisted after retries")


class FlatSimulation(Simulation):
    """Simulation that never plans capacity buckets: every rowlist force
    runs on the flat lists (the flat side of a flat-against-bucketed
    comparison)."""

    def _bucket_plan(self, numrows):
        return None
