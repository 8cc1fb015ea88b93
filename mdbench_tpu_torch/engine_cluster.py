"""Cluster-pair scheme simulation engine (the port of
``mdbench_tpu.engine_cluster``; reference src/clusterpair/main.c).

State lives in cluster layout between reneighbor events:

  reneighbor (every reneigh_every steps):
    cheap: keep cluster membership; wrap j16 pairs into the box,
      rebuild bboxes, ghosts, bins, group lists and either the exact
      unit lists or the group lists' per-member tile windows
    full (at resort_every boundaries): flatten to atoms, wrap, re-sort
      and re-chop into clusters, then the same list chain
  prune (every prune_every steps inside an interval, when
    0 < prune_every < reneigh_every): re-derive the exact unit lists or
    refresh the tile windows from current coordinates
  every step:
    integrate cluster planes -> refresh ghost rows -> force -> integrate

The force follows the kernel axis of mdbench_tpu (`kernel_mode`): the
exact-list LJ or two-pass EAM force ("auto", "ilist_pl"; CUDA kernels on
the card), the group-window LJ force ("pallas"; a CUDA kernel on the
card), the Newton half-list force (half_neigh=1; torch ops), or, asked
for by name, the plain twins ("ilist", "xla"). On a CPU tensor every
name runs the plain versions.

The time-step loop is a Python loop of eager torch ops on `device`
(mdbench_tpu compiled it into one lax.scan). The integration and the
ghost refresh update the state's tensors IN PLACE, where mdbench_tpu
rebuilt arrays with .at[].set/add: a state passed to `_run_steps` is
consumed. Capacity overflows raise device flags that are read once per
run, as in mdbench_tpu; the host then grows the capacity and retries.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mdbench_tpu_torch.config import FF_EAM, FF_LJ, Params
from mdbench_tpu_torch.models.eam_tables import (
    apply_eam_overrides,
    fit_eam_poly,
    load_eam,
)
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops.cluster import (
    ClusterGrid,
    ClusterHalo,
    ClusterPairList,
    Clusters,
    bin_clusters,
    build_cluster_pairs,
    build_clusters,
    compute_bboxes,
    derive_ilists,
    make_cluster_grid,
    make_j16_bboxes,
    refresh_pair_ranges,
    setup_cluster_pbc,
    update_cluster_pbc,
)
from mdbench_tpu_torch.ops.eam import EamDevice
from mdbench_tpu_torch.ops.eam_cluster import (
    eam_cluster_force,
    eam_cluster_force_ref,
)
from mdbench_tpu_torch.ops.lj_cluster import (
    lj_cluster_force_group_ref,
    lj_cluster_force_half_ref,
    lj_cluster_force_ilist,
    lj_cluster_force_ilist_ref,
    lj_cluster_force_stream,
)
from mdbench_tpu_torch.state import SENTINEL_COORD
from mdbench_tpu_torch.thermo import (
    ThermoScales,
    adjust_thermo,
    adjusted_dtforce,
    setup_thermo,
)

GROUP = 16  # i-clusters per shared group list
# the force-kernel names of mdbench_tpu's kernel axis
KERNELS = ("auto", "ilist", "ilist_pl", "pallas", "xla")

# overflow flags, in mdbench_tpu's order
FLAG_NAMES = ("clusters", "ghosts", "bin_cap", "z_ext", "pairs_nj",
              "pairs_coverage", "ilist_nji")
N_FLAGS = len(FLAG_NAMES)


class CStepState(NamedTuple):
    clusters: Clusters
    vxc: torch.Tensor  # (n_clusters_pad, 8)
    vyc: torch.Tensor
    vzc: torch.Tensor
    fxc: torch.Tensor
    fyc: torch.Tensor
    fzc: torch.Tensor
    halo: ClusterHalo
    pairs: ClusterPairList
    overflow: torch.Tensor  # (N_FLAGS,) bool


class CRunResult(NamedTuple):
    temps: np.ndarray
    press: np.ndarray
    state: CStepState
    total_time: float


def kernel_mode(params: Params) -> str:
    """The force kernel `params.kernel` names, as mdbench_tpu's
    _kernel_mode resolves it, with "auto" -> "ilist_pl": the exact-list
    kernels. "ilist" and "xla" are mdbench_tpu's plain twins; the port
    runs them (its plain torch versions) only when they are asked for by
    name. Raises ValueError for a name outside KERNELS."""
    if params.kernel not in KERNELS:
        raise ValueError(
            f"kernel must be one of {', '.join(KERNELS)}, got {params.kernel!r}")
    return "ilist_pl" if params.kernel == "auto" else params.kernel


def check_slice(params: Params) -> None:
    """Raise NotImplementedError for settings this port does not run yet
    (each is a queue entry in ROADMAP.md)."""
    unported = {
        "scheme other than 'cluster'": params.scheme != "cluster",
        "force_field other than lj or eam": (
            params.force_field not in (FF_LJ, FF_EAM)
        ),
        "ntypes > 1 (typed tables)": params.ntypes > 1,
        "derive_bf16": bool(params.derive_bf16),
        "input_file (atom readers)": bool(params.input_file),
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(
            "mdbench_tpu_torch does not run " + ", ".join(missing)
            + " yet; see ROADMAP.md"
        )


class ClusterSimulation:
    """The cluster-scheme LJ or EAM simulation on one torch device.

    `device` is explicit (default "cuda"); asking for a CUDA device
    without one raises — nothing drops to the CPU. On the CPU the force
    runs the plain torch versions of the CUDA kernels. The kernel axis
    (`params.kernel`, `params.half_neigh`) picks the force as
    mdbench_tpu's engine does; see the module docstring."""

    def __init__(
        self,
        params: Params,
        x: Optional[np.ndarray] = None,
        v: Optional[np.ndarray] = None,
        adjust: Optional[bool] = None,
        device="cuda",
    ):
        if params.force_field == FF_EAM:
            # mdbench_tpu's refusals for cluster EAM, ahead of check_slice
            # (which would call half_neigh merely unported)
            if not params.eam_file:
                raise ValueError("force_field=eam requires eam_file")
            if params.half_neigh:
                raise ValueError(
                    "cluster-scheme EAM supports full neighbor lists only"
                )
            if params.eam_eval == "spline":
                raise ValueError(
                    "cluster-scheme EAM is polynomial-evaluation only "
                    "(eam_eval=auto|poly); the spline parity axis runs "
                    "on the verlet scheme"
                )
        self._kmode = kernel_mode(params)
        # exact unit lists, or group lists with tile windows
        self._ilist = (
            self._kmode in ("ilist", "ilist_pl") and not params.half_neigh
        )
        if params.force_field == FF_EAM and not self._ilist:
            raise ValueError(
                "cluster-scheme EAM runs on the exact-list kernels only "
                "(kernel=auto|ilist|ilist_pl)"
            )
        check_slice(params)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch finds no CUDA device; "
                "pass device='cpu' to run the plain path"
            )
        self.params = params
        # EAM: the funcfl tables, initEam's overrides (BEFORE the lattice
        # is made, since they set rho), the pair polynomials and the frho
        # spline on the device, as in mdbench_tpu
        self.eam_tables = self.eam_poly = self.eam_dev = None
        if params.force_field == FF_EAM:
            self.eam_tables = load_eam(params.eam_file)
            apply_eam_overrides(params, self.eam_tables)
            self.eam_poly = fit_eam_poly(self.eam_tables)
            self.eam_dev = EamDevice.from_tables(
                self.eam_tables, self.device, params.dtype
            )
        if x is None:
            x, v, _ = create_fcc_lattice(params)
            if adjust is None:
                adjust = True
        self.natoms = self.nlocal = x.shape[0]
        self.scales: ThermoScales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        if adjust:
            v = adjust_thermo(params, self.scales, v, self.natoms)

        prd = np.array([params.xprd, params.yprd, params.zprd])
        self.prd = prd
        self.grid: ClusterGrid = make_cluster_grid(
            prd, params.cutneigh, params.rho, GROUP
        )

        # host capacity estimates (grown on overflow), as in mdbench_tpu
        ncx, ncy = self.grid.col_dims
        sx, sy = self.grid.col_size
        cx = np.clip((x[:, 0] / sx).astype(np.int64), 0, ncx - 1)
        cy = np.clip((x[:, 1] / sy).astype(np.int64), 0, ncy - 1)
        counts = np.bincount(cx * ncy + cy, minlength=ncx * ncy)
        cl_per_col = np.ceil(np.ceil(counts / 8.0) / GROUP) * GROUP
        n_clusters = int(cl_per_col.sum())
        blk = 8 * GROUP
        self.n_clusters_pad = (int(n_clusters * 1.08) + blk) // blk * blk
        gc = (
            int(
                self.n_clusters_pad
                * ((1 + 2 * params.cutneigh / prd[0])
                   * (1 + 2 * params.cutneigh / prd[1])
                   * (1 + 2 * params.cutneigh / prd[2]) - 1.0)
                * 1.6
            )
            + 64
        )
        self.ghost_cap = (gc + 1) // 2 * 2  # even: rows pair into j16
        # per-group j-list capacity from the dilated group-bbox volume
        zspan = GROUP * 8 / (sx * sy * params.rho)
        vol = (
            (sx + 2 * params.cutneigh + sx)
            * (sy + 2 * params.cutneigh + sy)
            * (zspan + 2 * params.cutneigh + 2.0)
        )
        L = int(math.ceil(vol * params.rho / 16.0 * 1.45 / 8.0)) * 8
        self.list_cap = max(32, L)
        # i-clusters sharing one exact list (1 on the group-window path),
        # and the exact-list capacity (atoms in a dilated cutneigh sphere
        # / 16, with headroom; calibrated after the first build, grown on
        # overflow)
        self.ishare = (params.ishare if params.ishare else 2) if self._ilist else 1
        zsp = 8.0 / (sx * sy * params.rho)  # one i-cluster's z-extent
        r_eff = (
            params.cutneigh + 0.5 * max(sx, sy) + 1.2
            + (self.ishare - 1) * 0.5 * zsp
        )
        self.icap = max(
            16,
            int(math.ceil(4.19 * r_eff**3 * params.rho / 16.0 * 1.35 / 8.0))
            * 8,
        )
        self.dtype = params.dtype
        self.grows: list = []  # the flags behind each capacity growth
        self.x_flat0 = self._flat(x, SENTINEL_COORD)
        self.v_flat0 = self._flat(v, 0.0)

    def _flat(self, a: np.ndarray, pad: float) -> torch.Tensor:
        """(nlocal+1, 3) device array with a trailing `pad` row."""
        out = np.full((self.nlocal + 1, 3), pad, np.float64)
        out[: self.nlocal] = a
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)

    # -- device phases ----------------------------------------------------

    def _wrap_flat(self, x_flat):
        prd = torch.as_tensor(self.prd, dtype=x_flat.dtype, device=x_flat.device)
        xl = x_flat[: self.nlocal]
        xl = torch.where(xl < 0.0, xl + prd, xl)
        xl = torch.where(xl >= prd, xl - prd, xl)
        out = x_flat.clone()
        out[: self.nlocal] = xl
        return out

    def _lists(self, clusters: Clusters, ovf_c):
        """Ghosts, bins, group lists and exact unit lists from cluster
        planes with current local bboxes (shared by both rebuilds).
        Returns (clusters, halo, pairs, overflow flags)."""
        p = self.params
        npad = self.n_clusters_pad
        halo = setup_cluster_pbc(
            clusters, npad, self.ghost_cap, self.prd,
            (p.pbc_x, p.pbc_y, p.pbc_z), p.cutneigh,
        )
        clusters = update_cluster_pbc(clusters, halo, npad, update_bbox=True)
        bb_cells, (ovf_bcap, ovf_zext) = bin_clusters(
            self.grid, make_j16_bboxes(clusters.bbox)
        )
        pairs = build_cluster_pairs(
            self.grid, bb_cells, clusters.bbox, npad, GROUP, self.list_cap,
            need_ranges=not self._ilist,
        )
        if self._ilist:
            pairs = derive_ilists(
                clusters, pairs, npad, GROUP, p.cutneigh, self.icap,
                share=self.ishare,
            )
            iovf = pairs.iovf
        else:
            iovf = torch.zeros((), dtype=torch.bool, device=self.device)
        ovf = torch.stack([
            ovf_c, halo.overflow, ovf_bcap, ovf_zext,
            pairs.overflow[0], pairs.overflow[1], iovf,
        ])
        return clusters, halo, pairs, ovf

    def _reneighbor_from_flat(self, x_flat, v_flat):
        """Full build from flat atom arrays: wrap, cluster, lists.
        Returns (clusters, (vxc, vyc, vzc), halo, pairs, overflow)."""
        x_flat = self._wrap_flat(x_flat)
        clusters, ovf_c = build_clusters(
            self.grid, x_flat, self.nlocal, self.n_clusters_pad,
            self.ghost_cap, group=GROUP,
        )
        aid = clusters.atom_id
        valid = aid >= 0
        a = aid.clamp(0, self.nlocal - 1)
        vel = tuple(
            torch.where(valid, v_flat[a, c], 0.0) for c in range(3)
        )
        clusters, halo, pairs, ovf = self._lists(clusters, ovf_c)
        return clusters, vel, halo, pairs, ovf

    def _flatten(self, state: CStepState):
        """Cluster planes back to flat atom arrays through the inverse map
        (reference updateSingleAtoms, neighbor.c:1023-1049)."""
        inv = state.clusters.inv_map
        npad = self.n_clusters_pad

        def gath(px, py, pz):
            out = torch.full((self.nlocal + 1, 3), SENTINEL_COORD,
                             dtype=px.dtype, device=px.device)
            out[: self.nlocal] = torch.stack(
                [q[:npad].reshape(-1)[inv] for q in (px, py, pz)], dim=1
            )
            return out

        cl = state.clusters
        x_flat = gath(cl.xc, cl.yc, cl.zc)
        v_flat = gath(state.vxc, state.vyc, state.vzc)
        v_flat[self.nlocal] = 0.0
        return x_flat, v_flat

    def _force_from(self, clusters: Clusters, pairs: ClusterPairList,
                    halo: ClusterHalo):
        """(fx, fy, fz) on the local cluster rows, by the kernel axis
        (mdbench_tpu engine_cluster.py:424-482): the two-pass EAM force
        (its ghost-fp refresh reads the halo), the half-list force, the
        exact-list force, the group-window force, or a plain twin."""
        p = self.params
        npad, cutsq = self.n_clusters_pad, p.cutforce**2
        planes = (clusters.xc, clusters.yc, clusters.zc)
        if self.eam_poly is not None:
            args = (npad, cutsq, self.eam_dev, self.eam_poly)
            if self._kmode == "ilist_pl":
                return eam_cluster_force(
                    *planes, pairs.ijlist, pairs.nji, halo.border_map, *args,
                    share=self.ishare)[:3]
            return eam_cluster_force_ref(
                *planes, pairs.ijlist, halo.border_map, *args,
                share=self.ishare)[:3]
        lj = (cutsq, p.sigma6, p.epsilon)
        if p.half_neigh:
            return lj_cluster_force_half_ref(*planes, pairs.jlist, npad, *lj)
        if self._kmode == "ilist_pl":
            return lj_cluster_force_ilist(
                *planes, pairs.ijlist, pairs.nji, npad, *lj, share=self.ishare)
        if self._kmode == "ilist":
            return lj_cluster_force_ilist_ref(
                *planes, pairs.ijlist, npad, *lj, share=self.ishare)
        if self._kmode == "pallas":
            return lj_cluster_force_stream(
                *planes, pairs.jlist, pairs.ranges, npad, *lj)
        return lj_cluster_force_group_ref(*planes, pairs.jlist, npad, *lj)

    def _thermo(self, vxc, vyc, vzc):
        vsq = (
            torch.sum(vxc * vxc) + torch.sum(vyc * vyc) + torch.sum(vzc * vzc)
        ) * self.params.mass
        t = vsq * self.scales.t_scale
        pr = (t * self.scales.dof_boltz) * self.scales.p_scale
        return t, pr

    # -- stepping ----------------------------------------------------------

    def _kick_drift(self, state: CStepState):
        """v += dtf*f, then x += dt*v on the local rows (in place)."""
        dt, dtf = self.params.dt, self.dtforce
        npad = self.n_clusters_pad
        cl = state.clusters
        for v, f, x in ((state.vxc, state.fxc, cl.xc),
                        (state.vyc, state.fyc, cl.yc),
                        (state.vzc, state.fzc, cl.zc)):
            v += dtf * f
            x[:npad] += dt * v

    def _kick(self, state: CStepState, f3):
        """v += dtf*f with the new forces; returns the state holding them."""
        dtf = self.dtforce
        for v, f in zip((state.vxc, state.vyc, state.vzc), f3):
            v += dtf * f
        return state._replace(fxc=f3[0], fyc=f3[1], fzc=f3[2])

    def _plain_steps(self, state: CStepState, n: int, thermo: list):
        """n plain steps (mdbench_tpu's _plain_scan). Appends (t, p) per
        step to `thermo`, or None when dense_thermo is off."""
        npad = self.n_clusters_pad
        for _ in range(n):
            self._kick_drift(state)
            update_cluster_pbc(state.clusters, state.halo, npad, False)
            state = self._kick(
                state, self._force_from(state.clusters, state.pairs, state.halo)
            )
            thermo.append(
                self._thermo(state.vxc, state.vyc, state.vzc)
                if self.params.dense_thermo else None
            )
        return state

    def _reneigh_step(self, state: CStepState, thermo: list):
        """Step with a full re-cluster (the sortAtom analogue)."""
        self._kick_drift(state)
        x_flat, v_flat = self._flatten(state)
        clusters, vel, halo, pairs, ovf = self._reneighbor_from_flat(x_flat, v_flat)
        state = CStepState(
            clusters, *vel, state.fxc, state.fyc, state.fzc, halo, pairs,
            state.overflow | ovf,
        )
        state = self._kick(state, self._force_from(clusters, pairs, halo))
        thermo.append(self._thermo(state.vxc, state.vyc, state.vzc))
        return state

    def _reneigh_step_cheap(self, state: CStepState, thermo: list):
        """Step with a list rebuild that keeps cluster membership: wrap
        at j16-pair granularity (a whole pair shifts by a box period when
        its bbox midpoint leaves the box), then rebuild bboxes, ghosts,
        bins and lists from current coordinates."""
        p = self.params
        npad = self.n_clusters_pad
        self._kick_drift(state)
        cl = state.clusters
        bbox_l = compute_bboxes(cl.xc[:npad], cl.yc[:npad], cl.zc[:npad])
        bb16 = make_j16_bboxes(bbox_l)
        shifts = []
        for d, (plane, L, on) in enumerate(
            zip((cl.xc, cl.yc, cl.zc), self.prd, (p.pbc_x, p.pbc_y, p.pbc_z))
        ):
            mid = 0.5 * (bb16[:, 2 * d] + bb16[:, 2 * d + 1])
            sh = (-float(L) * torch.floor(mid / float(L)) * float(on)).repeat_interleave(2)
            plane[:npad] += sh[:, None]
            shifts += [sh, sh]
        z = torch.zeros_like(shifts[0])
        cl.bbox[:npad] = bbox_l + torch.stack(shifts + [z, z], dim=1)
        cl, halo, pairs, ovf = self._lists(
            cl, torch.zeros((), dtype=torch.bool, device=self.device)
        )
        state = state._replace(
            clusters=cl, halo=halo, pairs=pairs, overflow=state.overflow | ovf
        )
        state = self._kick(state, self._force_from(cl, pairs, halo))
        thermo.append(self._thermo(state.vxc, state.vyc, state.vzc))
        return state

    def _prune(self, state: CStepState) -> CStepState:
        """The pruneNeighbor analogue (reference neighbor.c:483-531;
        mdbench_tpu engine_cluster.py:769-795): from current coordinates,
        re-derive the exact unit lists (their candidates stay the group
        list's) or refresh the group lists' tile windows."""
        p = self.params
        if self._ilist:
            pairs = derive_ilists(
                state.clusters, state.pairs, self.n_clusters_pad, GROUP,
                p.cutneigh, self.icap, share=self.ishare,
            )
        else:
            pairs = refresh_pair_ranges(
                state.clusters, state.pairs, self.n_clusters_pad, GROUP,
                p.cutneigh,
            )
        return state._replace(pairs=pairs)

    def _interval_plain_steps(self, state: CStepState, thermo: list):
        """An interval's reneigh_every - 1 plain steps, with a prune after
        every prune_every of them that does not end the run of plain steps
        when 0 < prune_every < reneigh_every (mdbench_tpu _make_run_fn)."""
        every = self.params.reneigh_every
        prune = self.params.prune_every
        if not 0 < prune < every:
            return self._plain_steps(state, every - 1, thermo)
        done = 0
        while done < every - 1:
            n = min(prune, every - 1 - done)
            state = self._plain_steps(state, n, thermo)
            done += n
            if n == prune and done < every - 1:
                state = self._prune(state)
        return state

    def _run_steps(self, state: CStepState, ntimes: int):
        """`ntimes` steps at the reneighbor/resort/prune cadence of
        mdbench_tpu's _make_run_fn: intervals of (reneigh_every - 1) plain
        steps, pruned as `_interval_plain_steps` says, and one rebuild
        step, the rebuild a full re-cluster when its step is a multiple of
        resort_every, else the cheap one; then a tail of plain steps
        without a prune. Consumes `state`. Returns (state, temps, press)
        with temps and press as device tensors of length ntimes (0 where
        not taken)."""
        p = self.params
        every = p.reneigh_every
        resort = p.resort_every
        n_intervals = ntimes // every
        thermo: list = []
        for i in range(n_intervals):
            state = self._interval_plain_steps(state, thermo)
            if resort > 0 and ((i + 1) * every) % resort == 0:
                state = self._reneigh_step(state, thermo)
            else:
                state = self._reneigh_step_cheap(state, thermo)
        state = self._plain_steps(state, ntimes - n_intervals * every, thermo)
        tp = torch.zeros((ntimes, 2), dtype=self.dtype, device=self.device)
        taken = [i for i, x in enumerate(thermo) if x is not None]
        if taken:
            tp[taken] = torch.stack([torch.stack(thermo[i]) for i in taken])
        return state, tp[:, 0], tp[:, 1]

    # -- run ---------------------------------------------------------------

    def initial_state(self) -> CStepState:
        clusters, vel, halo, pairs, ovf = self._reneighbor_from_flat(
            self.x_flat0, self.v_flat0
        )
        f3 = self._force_from(clusters, pairs, halo)
        return CStepState(clusters, *vel, *f3, halo, pairs, ovf)

    def _calibrate_list_cap(self, state0: CStepState) -> bool:
        """Shrink the group-list capacity to the observed need (+25%) and
        the exact-list capacity to the observed maximum (+15% + 2): every
        padded slot costs work each step. The need is the longest group
        list on the exact-list path, the farthest window end (njg tiles of
        8) on the group-window path. Returns True if either shrank (the
        caller rebuilds; later growth is the overflow retry)."""
        if self._ilist:
            need = int(state0.pairs.nj.max())
        else:
            need = int(state0.pairs.ranges[:, 2 * GROUP].max()) * 8
        tight = max((int(need * 1.25) + 7) // 8 * 8, 32)
        shrunk = False
        if tight < self.list_cap:
            self.list_cap = tight
            shrunk = True
        if state0.pairs.nji is None:
            return shrunk
        need_i = int(state0.pairs.nji.max())
        tight_i = max((int(need_i * 1.15) + 2 + 7) // 8 * 8, 16)
        if tight_i < self.icap:
            self.icap = tight_i
            shrunk = True
        return shrunk

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, ntimes: Optional[int] = None, max_retries: int = 5,
            repeats: int = 1, chain: int = 1) -> CRunResult:
        """Run `ntimes` steps. Set-up builds the initial state, grows any
        overflowed capacity and calibrates the list capacities once; an
        un-timed run then checks the whole trajectory for overflow (grow
        and retry) and gives the temperatures. The timed region is
        `repeats` regions of `chain` back-to-back runs, each from a fresh
        initial state built before the region, fenced with a device
        synchronise; total_time is the median region time / chain."""
        p = self.params
        ntimes = p.ntimes if ntimes is None else ntimes
        calibrated = False
        for _ in range(max_retries + 1):
            state0 = self.initial_state()
            flags = state0.overflow.cpu().numpy()
            if flags.any():
                self._grow(flags)
                continue
            if not calibrated:
                calibrated = True
                if self._calibrate_list_cap(state0):
                    continue
            state, temps, press = self._run_steps(state0, ntimes)
            flags = state.overflow.cpu().numpy()
            if flags.any():
                self._grow(flags)
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
            return CRunResult(
                temps=temps, press=press, state=state,
                total_time=float(np.median(totals)),
            )
        raise RuntimeError("cluster capacity overflow persisted")

    def _grow(self, flags=None):
        """Targeted capacity growth; flags in N_FLAGS order, None grows
        all."""
        if flags is None:
            flags = np.ones(N_FLAGS, bool)
        self.grows.append(
            "+".join(n for n, f in zip(FLAG_NAMES, flags) if f)
        )
        if flags[6]:
            self.icap = (int(self.icap * 1.5) + 7) // 8 * 8
        blk = 8 * GROUP
        if flags[0]:
            self.n_clusters_pad = (
                int(self.n_clusters_pad * 1.3) + blk
            ) // blk * blk
        if flags[1]:
            self.ghost_cap = (int(self.ghost_cap * 1.4) + 64 + 1) // 2 * 2
        if flags[4]:
            self.list_cap = int(self.list_cap * 1.5 + 7) // 8 * 8
        if flags[2] or flags[3] or flags[5]:
            g = self.grid
            self.grid = make_cluster_grid(
                self.prd, self.params.cutneigh, self.params.rho, GROUP,
                bin_capacity=(
                    int(g.bin_capacity * 1.5 + 3) // 4 * 4
                    if flags[2] else g.bin_capacity
                ),
                slop_z=g.slop_z * 1.5 if flags[3] else g.slop_z,
                slop_xy=g.slop_xy * 1.5 if flags[3] else g.slop_xy,
                zspan_factor=(
                    g.zspan_factor * 1.3 if flags[5] else g.zspan_factor
                ),
                drift_xy=g.drift_xy * 1.5 if flags[5] else g.drift_xy,
            )

    # convenience ----------------------------------------------------------

    def first_force_atoms(self) -> np.ndarray:
        """Step-0 forces in original atom order, float64 numpy (tests)."""
        state = self.initial_state()
        aid = state.clusters.atom_id.reshape(-1).cpu().numpy()
        f = torch.stack([state.fxc, state.fyc, state.fzc], dim=-1)
        f = f.reshape(-1, 3).double().cpu().numpy()
        out = np.zeros((self.nlocal, 3))
        m = aid >= 0
        out[aid[m]] = f[m]
        return out
