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
  (params.derive_bf16 on an SP run: every exact-list derivation runs its
    distance math in bfloat16 and keeps a superset of the exact lists)
  every step:
    integrate cluster planes -> refresh ghost rows -> force -> integrate

The force follows the kernel axis of mdbench_tpu (`kernel_mode`): the
exact-list LJ or two-pass EAM force ("auto", "ilist_pl"; CUDA kernels on
the card), the group-window LJ force ("pallas"; a CUDA kernel on the
card), the Newton half-list force (half_neigh=1; torch ops), or, asked
for by name, the plain twins ("ilist", "xla"). On a CPU tensor every
name runs the plain versions. On "auto"/"ilist_pl" untyped runs of 4096
units or more, the calibration after the first build plans capacity
buckets, as mdbench_tpu does: every rebuild then sorts the units by list
length into the plan's buckets (ops/cluster.attach_bucket_maps), and the
exact-list force runs bucketed (on the card the bucketed forms of the
kernels). run_chunked runs in host-visible chunks with a replay of a
chunk that overflowed; measure_phases times the force and the rebuild.

Typed LJ runs (the reference's EXPLICIT_TYPES, clusterpair/atom.c:78-92)
carry an int32 type plane in the clusters and three (T, T) tables
(epsilon, sigma^6, cutoff^2) on the device; every force of the axis then
takes its typed form (on the card the typed kernels). Types come from
`types=`, or from an atom file (`params.input_file`) with more than one
type; `params.ntypes > 1` alone runs the tables over all-zero types, as
mdbench_tpu does on the lattice.

The time-step loop is a Python loop of eager torch ops on `device`
(mdbench_tpu compiled it into one lax.scan). The integration and the
ghost refresh update the state's tensors IN PLACE, where mdbench_tpu
rebuilt arrays with .at[].set/add: a state passed to `_run_steps` is
consumed. Capacity overflows raise device flags that are read once per
run, as in mdbench_tpu; the host then grows the capacity and retries. Each
phase of a step runs inside a tracing.region span ("reneighbor" and its
children around both rebuilds and the prune, "force", "integrate",
"halo_update", "thermo"; tracing.py lists them), spans of a profile and
nothing outside one.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mdbench_tpu_torch.config import FF_EAM, FF_LJ, Params
from mdbench_tpu_torch.io.readers import read_atom
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
    attach_bucket_maps,
    bin_clusters,
    build_cluster_pairs,
    build_clusters,
    compute_bboxes,
    derive_ilists,
    make_cluster_grid,
    make_j16_bboxes,
    plan_capacity_buckets,
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
    lj_cluster_force_buckets,
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
from mdbench_tpu_torch.tracing import region

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
    """Raise NotImplementedError for the settings the port does not run:
    a scheme other than "cluster" or "verlet" and a force field other
    than LJ or EAM (mdbench_tpu's engines compute no other force). Every
    other field of Params runs: derive_bf16 on the cluster scheme's
    single engine in SP, ignored elsewhere, as in mdbench_tpu."""
    unported = {
        "scheme other than 'cluster' or 'verlet'": (
            params.scheme not in ("cluster", "verlet")
        ),
        "force_field other than lj or eam": (
            params.force_field not in (FF_LJ, FF_EAM)
        ),
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
    mdbench_tpu's engine does; see the module docstring.

    Without `x`, the atoms come from `params.input_file` (read with its
    box; velocities not rescaled unless `adjust`) or else from the FCC
    lattice. `types` (nlocal,) and `tables` (eps, sig6, cutsq), each
    (T, T), make the run typed, as mdbench_tpu's engine takes them; a
    table whose cutsq exceeds cutforce**2 raises ValueError (the lists
    reach only cutforce + skin)."""

    def __init__(
        self,
        params: Params,
        x: Optional[np.ndarray] = None,
        v: Optional[np.ndarray] = None,
        adjust: Optional[bool] = None,
        device="cuda",
        types: Optional[np.ndarray] = None,
        tables: Optional[tuple] = None,
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
        if params.scheme != "cluster":
            raise ValueError("ClusterSimulation runs scheme='cluster'; the verlet "
                             "scheme runs on engine.Simulation")
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
        if x is None and params.input_file:
            r = read_atom(params)
            x, v = r.x, r.v
            if r.ntypes > 1 and types is None:
                types = r.types
            if adjust is None:
                adjust = False
        if x is None:
            # the lattice's types are dropped, as in mdbench_tpu: with
            # params.ntypes > 1 its tables run over all-zero types
            x, v, _ = create_fcc_lattice(params)
            if adjust is None:
                adjust = True
        self.natoms = self.nlocal = x.shape[0]
        # EXPLICIT_TYPES tables (reference clusterpair/atom.c:78-92): every
        # type pair gets the single epsilon/sigma/cutoff of params unless
        # `tables` is given
        types0 = (np.zeros(self.nlocal, np.int32) if types is None
                  else np.asarray(types, np.int32))
        nt_seen = int(types0.max()) + 1 if self.nlocal else 1
        self.ntypes = max(int(params.ntypes), nt_seen)
        if tables is None and self.ntypes > 1:
            nt = self.ntypes
            tables = (np.full((nt, nt), params.epsilon),
                      np.full((nt, nt), params.sigma6),
                      np.full((nt, nt), params.cutforce**2))
        self.type_tables = (
            tuple(np.asarray(t, np.float64) for t in tables)
            if tables is not None else None
        )
        self.types_flat0 = self.tables = None
        if self.type_tables is not None:
            if params.force_field == FF_EAM:
                raise ValueError(
                    "cluster-scheme EAM is single-type (funcfl): it takes "
                    "no type tables and no ntypes > 1")
            # the pair lists are built with the scalar cutneigh, so a table
            # cutoff past cutforce would lose pairs (mdbench_tpu accepts it
            # silently; the port refuses it)
            if self.type_tables[2].max() > params.cutforce**2:
                raise ValueError(
                    f"a type table's cutoff squared ({self.type_tables[2].max()}) "
                    f"exceeds cutforce**2 ({params.cutforce**2}): the lists are "
                    "built with cutneigh = cutforce + skin and would lose pairs")
            self.types_flat0 = torch.as_tensor(types0, device=self.device)
            self.tables = tuple(
                torch.as_tensor(t, dtype=params.dtype, device=self.device)
                for t in self.type_tables
            )
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
        # the bf16 derive (superset lists, ops/cluster.derive_ilists): SP
        # only, as in mdbench_tpu; in DP the exact derive is the parity
        self._derive_bf16 = bool(params.derive_bf16 and params.precision == "sp")
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
        # capacity buckets of the exact-list kernels, (sizes, caps) in
        # units, or None for the flat capacity: planned once, after the
        # first build, by _calibrate_list_cap
        self.buckets = None
        self.dtype = params.dtype
        self._force_reps = 1  # forces per plain step (cli --timers diff: 2)
        self.grows: list = []  # the flags behind each capacity growth
        self.setup_time = None  # run()'s set-up seconds (run docstring)
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
        with region("reneighbor.halo"):
            halo = setup_cluster_pbc(
                clusters, npad, self.ghost_cap, self.prd,
                (p.pbc_x, p.pbc_y, p.pbc_z), p.cutneigh,
            )
            clusters = update_cluster_pbc(clusters, halo, npad, update_bbox=True)
        with region("reneighbor.rows"):
            bb_cells, (ovf_bcap, ovf_zext) = bin_clusters(
                self.grid, make_j16_bboxes(clusters.bbox)
            )
            pairs = build_cluster_pairs(
                self.grid, bb_cells, clusters.bbox, npad, GROUP, self.list_cap,
                need_ranges=not self._ilist,
            )
            if self._ilist:
                pairs = self._derive(clusters, pairs)
        if self._ilist:
            pairs = self._with_buckets(pairs, clusters)
            iovf = pairs.iovf
        else:
            iovf = torch.zeros((), dtype=torch.bool, device=self.device)
        ovf = torch.stack([
            ovf_c, halo.overflow, ovf_bcap, ovf_zext,
            pairs.overflow[0], pairs.overflow[1], iovf,
        ])
        return clusters, halo, pairs, ovf

    def _derive(self, clusters: Clusters, pairs: ClusterPairList):
        """The exact unit lists of the group lists (derive_ilists: the
        prune of the cluster scheme)."""
        with region("reneighbor.prune"):
            return derive_ilists(
                clusters, pairs, self.n_clusters_pad, GROUP, self.params.cutneigh,
                self.icap, share=self.ishare, bf16=self._derive_bf16)

    def _with_buckets(self, pairs: ClusterPairList, clusters: Clusters):
        """The exact lists with the bucket maps of the plan, if there is
        one (mdbench_tpu attaches them after every derive_ilists)."""
        if self.buckets is None:
            return pairs
        with region("reneighbor.buckets"):
            return attach_bucket_maps(pairs, self.n_clusters_pad, self.ishare,
                                      clusters.xc.shape[0], *self.buckets)

    def _reneighbor_from_flat(self, x_flat, v_flat):
        """Full build from flat atom arrays: wrap, cluster, lists.
        Returns (clusters, (vxc, vyc, vzc), halo, pairs, overflow)."""
        with region("reneighbor"):
            return self._reneighbor_from_flat_inner(x_flat, v_flat)

    def _reneighbor_from_flat_inner(self, x_flat, v_flat):
        with region("reneighbor.sort"):
            x_flat = self._wrap_flat(x_flat)
            clusters, ovf_c = build_clusters(
                self.grid, x_flat, self.nlocal, self.n_clusters_pad,
                self.ghost_cap, group=GROUP, types=self.types_flat0,
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
        (mdbench_tpu engine_cluster.py:387-482): the two-pass EAM force
        (its ghost-fp refresh reads the halo), the half-list force, the
        exact-list force, the group-window force, or a plain twin; each LJ
        force in its typed form on a typed run. The exact-list kernels
        (EAM, and untyped LJ) run bucketed when the lists carry the bucket
        maps."""
        with region("force"):
            return self._force_from_inner(clusters, pairs, halo)

    def _force_from_inner(self, clusters: Clusters, pairs: ClusterPairList,
                          halo: ClusterHalo):
        p = self.params
        npad, cutsq = self.n_clusters_pad, p.cutforce**2
        planes = (clusters.xc, clusters.yc, clusters.zc)
        bucketed = self.buckets is not None and pairs.bijlist is not None
        bpairs = (pairs.bijlist, pairs.bcrows, pairs.binv) if bucketed else None
        if self.eam_poly is not None:
            args = (npad, cutsq, self.eam_dev, self.eam_poly)
            if self._kmode == "ilist_pl":
                return eam_cluster_force(
                    *planes, pairs.ijlist, pairs.nji, halo.border_map, *args,
                    share=self.ishare, buckets=self.buckets if bucketed else None,
                    bpairs=bpairs)[:3]
            return eam_cluster_force_ref(
                *planes, pairs.ijlist, halo.border_map, *args,
                share=self.ishare)[:3]
        lj = (cutsq, p.sigma6, p.epsilon)
        typed = dict(tc=clusters.tc, tables=self.tables)
        if p.half_neigh:
            return lj_cluster_force_half_ref(*planes, pairs.jlist, npad, *lj,
                                             **typed)
        if self._kmode == "ilist_pl":
            # the exact-list kernels take approx_rcp (mdbench_tpu
            # engine_cluster.py:446/452/520); the group-window kernel does not
            if bucketed and clusters.tc is None:
                return lj_cluster_force_buckets(
                    *planes, *bpairs, pairs.nji, npad, self.buckets, *lj,
                    share=self.ishare, approx_rcp=p.approx_rcp)
            return lj_cluster_force_ilist(
                *planes, pairs.ijlist, pairs.nji, npad, *lj, share=self.ishare,
                approx_rcp=p.approx_rcp, **typed)
        if self._kmode == "ilist":
            return lj_cluster_force_ilist_ref(
                *planes, pairs.ijlist, npad, *lj, share=self.ishare, **typed)
        if self._kmode == "pallas":
            return lj_cluster_force_stream(
                *planes, pairs.jlist, pairs.ranges, npad, *lj, **typed)
        return lj_cluster_force_group_ref(*planes, pairs.jlist, npad, *lj,
                                          **typed)

    def _thermo(self, vxc, vyc, vzc):
        with region("thermo"):
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
        with region("integrate"):
            for v, f, x in ((state.vxc, state.fxc, cl.xc),
                            (state.vyc, state.fyc, cl.yc),
                            (state.vzc, state.fzc, cl.zc)):
                v += dtf * f
                x[:npad] += dt * v

    def _kick(self, state: CStepState, f3):
        """v += dtf*f with the new forces; returns the state holding them."""
        dtf = self.dtforce
        with region("integrate"):
            for v, f in zip((state.vxc, state.vyc, state.vzc), f3):
                v += dtf * f
        return state._replace(fxc=f3[0], fyc=f3[1], fzc=f3[2])

    def _plain_steps(self, state: CStepState, n: int, thermo: list):
        """n plain steps (mdbench_tpu's _plain_scan). Appends (t, p) per
        step to `thermo`, or None when dense_thermo is off. With
        _force_reps > 1 each step chains that many forces, each from xc +
        1e-30 * the previous fx (cli --timers diff, mdbench_tpu
        engine_cluster.py:589-595)."""
        npad = self.n_clusters_pad
        for _ in range(n):
            self._kick_drift(state)
            with region("halo_update"):
                cl = update_cluster_pbc(state.clusters, state.halo, npad, False)
            f3 = self._force_from(cl, state.pairs, state.halo)
            for _r in range(self._force_reps - 1):
                with region("force"):
                    xc = cl.xc.clone()
                    xc[:npad] += 1e-30 * f3[0]
                f3 = self._force_from(cl._replace(xc=xc), state.pairs, state.halo)
            state = self._kick(state, f3)
            thermo.append(
                self._thermo(state.vxc, state.vyc, state.vzc)
                if self.params.dense_thermo else None
            )
        return state

    def _reneigh_step(self, state: CStepState, thermo: list):
        """Step with a full re-cluster (the sortAtom analogue)."""
        self._kick_drift(state)
        with region("reneighbor"):
            with region("reneighbor.sort"):
                x_flat, v_flat = self._flatten(state)
            clusters, vel, halo, pairs, ovf = self._reneighbor_from_flat_inner(
                x_flat, v_flat)
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
        with region("reneighbor"):
            with region("reneighbor.halo"):
                bbox_l = compute_bboxes(cl.xc[:npad], cl.yc[:npad], cl.zc[:npad])
                bb16 = make_j16_bboxes(bbox_l)
                shifts = []
                for d, (plane, L, on) in enumerate(
                    zip((cl.xc, cl.yc, cl.zc), self.prd, (p.pbc_x, p.pbc_y, p.pbc_z))
                ):
                    mid = 0.5 * (bb16[:, 2 * d] + bb16[:, 2 * d + 1])
                    sh = (-float(L) * torch.floor(mid / float(L))
                          * float(on)).repeat_interleave(2)
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
        with region("reneighbor"):
            if self._ilist:
                with region("reneighbor.rows"):
                    pairs = self._derive(state.clusters, state.pairs)
                pairs = self._with_buckets(pairs, state.clusters)
            else:
                with region("reneighbor.rows"):
                    pairs = refresh_pair_ranges(
                        state.clusters, state.pairs, self.n_clusters_pad, GROUP,
                        self.params.cutneigh,
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
        with region("thermo"):
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
        8) on the group-window path. Then plan the capacity buckets
        (_plan_buckets). Returns True if a capacity shrank or buckets were
        planned (the caller rebuilds; later growth is the overflow
        retry)."""
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
        if self._plan_buckets(state0.pairs.nji.cpu().numpy()):
            shrunk = True
        return shrunk

    def _plan_buckets(self, nji: np.ndarray) -> bool:
        """Plan capacity buckets for the exact-list kernels from the
        observed list lengths (ops/cluster.plan_capacity_buckets with
        mdbench_tpu's margin 2 and zero tier), once, on kernel "ilist_pl"
        untyped runs only (mdbench_tpu engine_cluster.py:900-919); the
        planner itself refuses boxes of fewer than 4096 units. Returns True
        if it set a plan."""
        if self.buckets is not None:
            return False
        if self._kmode != "ilist_pl" or self.type_tables is not None:
            return False
        plan = plan_capacity_buckets(nji, self.icap, self.ishare, margin=2,
                                     zero_tier=True)
        if plan is None:
            return False
        self.buckets = plan
        return True

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
        synchronise; total_time is the median region time / chain, NaN with
        repeats=0 (no timed region). setup_time is the seconds from the
        call to the checked run's start (initial state, grows, the
        calibration; synchronised)."""
        p = self.params
        ntimes = p.ntimes if ntimes is None else ntimes
        calibrated = False
        t_setup = time.perf_counter()
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
            self._sync()
            self.setup_time = time.perf_counter() - t_setup
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
                total_time=float(np.median(totals)) if totals else float("nan"),
            )
        raise RuntimeError("cluster capacity overflow persisted")

    def _setup_state(self, max_retries: int = 5,
                     calibrate: bool = True) -> CStepState:
        """run()'s set-up alone: the initial state, grown until nothing
        overflows, with the list capacities calibrated (and the buckets
        planned) once if `calibrate`."""
        calibrated = not calibrate
        for _ in range(max_retries + 1):
            state = self.initial_state()
            flags = state.overflow.cpu().numpy()
            if flags.any():
                self._grow(flags)
                continue
            if not calibrated:
                calibrated = True
                if self._calibrate_list_cap(state):
                    continue
            return state
        raise RuntimeError("cluster capacity overflow persisted")

    def _restart_from_flat(self, xb, vb, flags=None,
                           max_retries: int = 5) -> CStepState:
        """Grow the capacities named by `flags` and rebuild a runnable
        state from flat atom arrays (a chunk boundary's _flatten, original
        atom order), which become the engine's t=0 arrays: the lists are a
        function of the positions, so the rebuilt state carries the same
        physics (mdbench_tpu engine_cluster.py:988-1005)."""
        self.x_flat0, self.v_flat0 = xb, vb
        self._grow(flags)
        return self._setup_state(max_retries, calibrate=False)

    def run_chunked(self, chunk: int, nchunks: int, callback,
                    max_retries: int = 5, tail: int = 0) -> CRunResult:
        """Run nchunks * chunk + tail steps in host-visible chunks (for
        trajectory output; mdbench_tpu engine_cluster.py:1007-1091).
        callback(state, step) runs at step 0 and after every chunk and the
        tail. Each chunk runs `_run_steps(chunk)`, so its rebuild cadence
        counts from the chunk's start. Set-up as in run(). A chunk that
        overflows is discarded: the capacities grow, the state is rebuilt
        from the chunk's starting boundary (snapshotted through _flatten
        before it ran) and the chunk is replayed. total_time is the host
        time from the first chunk to the end, callbacks included."""
        state = self._setup_state(max_retries)
        callback(state, 0)
        temps_all, press_all = [], []
        t0 = time.perf_counter()
        retries = 0
        lengths = [chunk] * nchunks + ([tail] if tail else [])
        c = 0
        while c < len(lengths):
            xb, vb = self._flatten(state)  # the chunk consumes the state
            state, temps, press = self._run_steps(state, lengths[c])
            flags = state.overflow.cpu().numpy()
            if flags.any():
                retries += 1
                if retries > max_retries:
                    raise RuntimeError(
                        "cluster capacity overflow persisted in run_chunked")
                state = self._restart_from_flat(xb, vb, flags, max_retries)
                continue  # replay chunk c from its boundary
            c += 1
            callback(state, sum(lengths[:c]))
            temps_all.append(temps.cpu().numpy())
            press_all.append(press.cpu().numpy())
        self._sync()
        total = time.perf_counter() - t0
        empty = np.zeros((0,))
        return CRunResult(
            temps=np.concatenate(temps_all) if temps_all else empty,
            press=np.concatenate(press_all) if press_all else empty,
            state=state, total_time=total,
        )

    def measure_phases(self, state: CStepState, reps: int = 20):
        """Out-of-band FORCE and NEIGH times in seconds per call
        (mdbench_tpu engine_cluster.py:1139-1182): `reps` chained forces
        on `state`'s lists, each fed the planes + 1e-30 * the previous
        force's fx[0, 0] so that no call can be skipped, and max(reps // 4,
        1) full rebuilds from the t=0 atoms (_reneighbor_from_flat, chained
        the same way through nj[0]). Each is run once to warm up, then timed
        between device synchronisations. `state` is not changed."""
        def force_reps():
            xc = state.clusters.xc
            for _ in range(reps):
                fx = self._force_from(state.clusters._replace(xc=xc),
                                      state.pairs, state.halo)[0]
                xc = xc + 1e-30 * fx[0, 0]

        n_neigh = max(reps // 4, 1)

        def neigh_reps():
            x_flat = self.x_flat0
            for _ in range(n_neigh):
                pairs = self._reneighbor_from_flat(x_flat, self.v_flat0)[3]
                x_flat = x_flat + 1e-30 * pairs.nj[0].to(x_flat.dtype)

        times = []
        for fn, n in ((force_reps, reps), (neigh_reps, n_neigh)):
            fn()
            self._sync()
            t0 = time.perf_counter()
            fn()
            self._sync()
            times.append((time.perf_counter() - t0) / n)
        return times[0], times[1]

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
            if self.buckets is not None:
                # a bucket overflowed, or the flat capacity: every cap
                # widens by 8 (a zero tier becomes an 8-cap tier) and the
                # last follows icap
                sizes, caps = self.buckets
                self.buckets = (sizes, tuple(c + 8 for c in caps[:-1]) + (self.icap,))
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


class FlatSimulation(ClusterSimulation):
    """ClusterSimulation that never plans capacity buckets: every exact-list
    force runs on the flat lists (the flat side of a flat-against-bucketed
    comparison, and the bf16 probe's run)."""

    def _plan_buckets(self, nji) -> bool:
        return False
