"""The cluster-pair scheme's spatial domain decomposition over 1-D slabs
(the port of ``mdbench_tpu.parallel.cluster_domain``).

The box is cut into `ndev` slabs along x; each domain runs the single
device cluster machinery (engine_cluster.ClusterSimulation: clusters,
j16 ghosts, bins, group lists, exact unit lists, the cluster force) on
its slab, in a slab-local frame that owns [0, slab_w). The only traffic
between domains is fixed-capacity buffers moved by the exchange layer
(`parallel/exchange.py`: `shift` for mdbench_tpu's `lax.ppermute`, `psum`
for its `lax.psum`):

  full rebuild (at resort_every boundaries):
    flatten the clusters to atoms (inverse map) -> wrap y/z -> MIGRATE
    the atoms that crossed an x face (parallel/common.migrate) -> re-chop
    into clusters on the slab's grid -> local y/z j16 ghosts
    (setup_cluster_pbc with pbc = (0, y, z)) -> export the j16 whose
    bounding box lies within cutneigh of an x face (locals and their y/z
    images, so edge and corner images ride along) -> shift their rows
    with the boxes -> the received rows become x-ghost rows -> bins,
    group lists, exact unit lists (and bucket maps) per domain
  cheap rebuild (every other rebuild): the same from the ghosts on, on
    the current clusters: no re-chop, no migration and no wrap in x
    (clusters that drift past a slab face stay owned until the next full
    rebuild, as the single engine's atoms between wraps; the exports and
    bins follow the boxes)
  every step:
    integrate the local planes -> refresh the y/z ghost rows -> re-gather
    the exported j16 rows, shift both ways, write the x-ghost rows ->
    force (EAM: pass 1 on every domain, the ghost fp from the y/z owners
    and over the same maps, then pass 2) -> integrate -> psum of the
    kinetic energy (at rebuild steps, and every step with dense_thermo)

Each phase runs for every domain this process holds, then the exchange,
then the next phase (parallel/verlet_domain's model; mdbench_tpu runs each
device's whole run as one scan inside `shard_map`). With one slab the
exchange still runs: the slab sends its own border rows to itself across
the x seam.

A domain's cluster rows (planes (nrows_cl, 8)):

  [0, ncl_pad)             local clusters
  [+gcap_rows)             local y/z ghost rows
  [+2 xcap16)              x-ghost rows from the left neighbour
  [+2 xcap16)              x-ghost rows from the right neighbour
  [2 rows]                 sentinel rows (the last j16: the padding id)

As in mdbench_tpu, the whole local atom window [0, acap) is clustered:
its padding rows, at the sentinel coordinate, become atoms of the last
cluster of some column that no distance test, box or face test takes
(their boxes are empty); the atom count comes from the migration. Unused
export and ghost slots name the sentinel j16, nrows_cl // 2 - 1.

Atom counts are 0-d device tensors, never read on the host inside a run;
each domain's overflow flags (FLAGS) are read once after a run, and the
capacities the flags name grow before the run repeats (mdbench_tpu's
targeted grow).

Forces by the kernel axis (engine_cluster.kernel_mode): "auto" /
"ilist_pl" take the exact unit lists, on a CUDA tensor K1 or, once the
melt calibration has planned capacity buckets (on the card only), K1b;
"pallas" the group lists with tile windows and K4; "ilist" and "xla" the
plain torch versions of those two. EAM runs on the exact lists only: the
density (K2 or K2b) on every domain, the ghost fp exchange, then the
pair force (K3 or K3b). On a CPU tensor every kernel name runs the
plain versions.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.engine_cluster import GROUP, kernel_mode
from mdbench_tpu_torch.models.eam_tables import apply_eam_overrides, fit_eam_poly, load_eam
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops.cluster import (
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
    setup_cluster_pbc,
    update_cluster_pbc,
)
from mdbench_tpu_torch.ops.eam import EamDevice
from mdbench_tpu_torch.ops.eam_cluster import (
    _fp_ghost_refresh,
    eam_cluster_density,
    eam_cluster_density_ref,
    eam_cluster_pair_forces,
    eam_cluster_pair_forces_ref,
)
from mdbench_tpu_torch.ops.lj_cluster import (
    lj_cluster_force_buckets,
    lj_cluster_force_group_ref,
    lj_cluster_force_ilist,
    lj_cluster_force_ilist_ref,
    lj_cluster_force_stream,
)
from mdbench_tpu_torch.parallel.common import migrate, wrap_dims
from mdbench_tpu_torch.parallel.exchange import InProcessMesh
from mdbench_tpu_torch.state import SENTINEL_COORD
from mdbench_tpu_torch.thermo import adjust_thermo, adjusted_dtforce, setup_thermo
from mdbench_tpu_torch.tracing import region

# a domain's overflow flags, in mdbench_tpu's order
FLAGS = ("migration", "clusters", "ghosts", "x_export", "bin_cap", "z_ext",
         "pairs_nj", "pairs_coverage", "ilist_nji")


class CDomain(NamedTuple):
    """One domain's step state (mdbench_tpu's scan carry)."""

    cl: Clusters
    vxc: torch.Tensor  # (ncl_pad, 8)
    vyc: torch.Tensor
    vzc: torch.Tensor
    fxc: Optional[torch.Tensor]  # (ncl_pad, 8); None until the force runs
    fyc: Optional[torch.Tensor]
    fzc: Optional[torch.Tensor]
    nloc: torch.Tensor  # () int64 live atoms
    halo: ClusterHalo  # local y/z j16 ghosts
    rows_l: torch.Tensor  # (2 xcap16,) rows exported to the LEFT neighbour
    rows_r: torch.Tensor
    pairs: ClusterPairList
    ovf: torch.Tensor  # (9,) bool, FLAGS


class ClusterDomainResult(NamedTuple):
    temps: np.ndarray  # one per step (0 where not taken)
    nlocal: np.ndarray  # (ndev,) atoms per domain at the end
    overflow: np.ndarray  # (ndev, 9) bool, FLAGS
    total_time: float  # median timed run, NaN without a timed region
    state: tuple  # the final CDomain of each held domain


class ClusterDomainSimulation:
    """The cluster-scheme LJ or EAM simulation over `ndev` x-slabs
    (module docstring).

    `device` is explicit (default "cuda"); asking for a CUDA device without
    one raises, and nothing drops to the CPU. `exchange` is the exchange
    layer (None: an InProcessMesh of ndev domains on `device`); its `ndev`
    must equal `ndev`. Without `x`, the atoms come from the FCC lattice;
    the velocities are always rescaled, as in mdbench_tpu. EAM loads
    `params.eam_file` and applies initEam's overrides to `params` first:
    pass a fresh `Params` to each engine. Like mdbench_tpu's engine it
    runs full lists, untyped, without the prune and with the exact derive,
    whatever `half_neigh`, `ntypes`, `prune_every` and `derive_bf16`
    say."""

    def __init__(self, params: Params, ndev: int, x: Optional[np.ndarray] = None,
                 v: Optional[np.ndarray] = None, device="cuda", exchange=None):
        self._kmode = kernel_mode(params)
        self._ilist = self._kmode in ("ilist", "ilist_pl")
        if params.force_field == FF_EAM:
            if not params.eam_file:
                raise ValueError("force_field=eam requires eam_file")
            if params.eam_eval == "spline":
                raise ValueError(
                    "cluster-scheme EAM is polynomial-evaluation only "
                    "(eam_eval=auto|poly); the spline parity axis runs on the "
                    "verlet scheme")
            if not self._ilist:
                raise ValueError("cluster-domain EAM runs on the exact-list kernels "
                                 "only (kernel=auto|ilist|ilist_pl)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch finds no CUDA device; "
                "pass device='cpu' to run the plain path")
        self.params = params
        self.eam_dev = self.eam_poly = None
        if params.force_field == FF_EAM:
            # the overrides set rho, so they come before the slab geometry
            # and the lattice (reference setup() calls initEam first)
            t = load_eam(params.eam_file)
            apply_eam_overrides(params, t)
            self.eam_poly = fit_eam_poly(t)
            self.eam_dev = EamDevice.from_tables(t, self.device, params.dtype)
        self.ndev = ndev
        self.slab_w = params.xprd / ndev
        c = params.cutneigh
        if self.slab_w < c:
            raise ValueError(f"slab width {self.slab_w:.2f} < cutneigh {c}: "
                             "use fewer domains or a larger box")
        if exchange is None:
            exchange = InProcessMesh(ndev, self.device)
        if exchange.shape != (ndev,):
            raise ValueError(f"the exchange holds a mesh of {exchange.ndev} domains in "
                             f"shape {exchange.shape}, not {ndev} slabs")
        self.exchange = exchange
        if x is None:
            x, v, _ = create_fcc_lattice(params)
        self.natoms = x.shape[0]
        self.scales = setup_thermo(params, self.natoms)
        self.dtforce = adjusted_dtforce(params, self.scales)
        v = adjust_thermo(params, self.scales, v, self.natoms)

        self.slab_prd = np.array([self.slab_w, params.yprd, params.zprd])
        self.grid = make_cluster_grid(self.slab_prd, c, params.rho, GROUP)
        # capacities (per domain), mdbench_tpu's: the cluster window from
        # the t = 0 per-column occupancy of each slab, with a 1.18 margin
        # (the padding rows of the atom window become clusters too; the
        # drift is the grow-and-retry's), rounded to 8 x GROUP clusters
        sx, sy = self.grid.col_size
        ncx, ncy = self.grid.col_dims
        blk = 8 * GROUP
        n_cl_max = 0
        for d in range(ndev):
            xs = x[(x[:, 0] >= d * self.slab_w) & (x[:, 0] < (d + 1) * self.slab_w)]
            cx = np.clip(((xs[:, 0] - d * self.slab_w) / sx).astype(np.int64), 0, ncx - 1)
            cy = np.clip((xs[:, 1] / sy).astype(np.int64), 0, ncy - 1)
            counts = np.bincount(cx * ncy + cy, minlength=ncx * ncy)
            n_cl_max = max(n_cl_max, int((np.ceil(np.ceil(counts / 8.0) / GROUP)
                                          * GROUP).sum()))
        self.ncl_pad = max((int(n_cl_max * 1.18) + blk - 1) // blk * blk, blk)
        self.acap = int(math.ceil(self.natoms / ndev * 1.12 / 8)) * 8 + 8
        # local y/z ghost rows
        gfrac = (1 + 2 * c / params.yprd) * (1 + 2 * c / params.zprd) - 1.0
        self.gcap_rows = (int(math.ceil(self.ncl_pad * gfrac * 1.8)) + 64 + 1) // 2 * 2
        # x-face exports: the j16 within c of a face, with a box slop margin
        xfrac = (c + 2 * sx) / self.slab_w
        self.xcap16 = int(math.ceil((self.ncl_pad + self.gcap_rows) / 2 * xfrac * 1.8)) + 32
        self.migcap = int(math.ceil(self.acap * 0.2)) + 32
        # the group lists' capacity (engine_cluster's shape)
        zspan = GROUP * 8 / (sx * sy * params.rho)
        vol = (sx + 2 * c + sx) * (sy + 2 * c + sy) * (zspan + 2 * c + 2.0)
        self.list_cap = max(32, int(math.ceil(vol * params.rho / 16.0 * 1.45 / 8.0)) * 8)
        # exact lists shared by 2 i-clusters, and their capacity (the melt
        # calibration re-sets it)
        self.ishare = 2
        self.icap = 48
        # the calibration's capacity-bucket plan (sizes, caps): the card's
        # K1b / K2b / K3b (mdbench_tpu: its Pallas backend)
        self.buckets = None
        self._calibrated = False
        self._on_card = self.device.type == "cuda"
        self.grows: list = []  # the flags behind each capacity growth
        self._fix_layout()
        self._xv_init = (x, v)
        self._init_host_state(x, v)

    # ---- layout and set-up ------------------------------------------------

    def _fix_layout(self):
        """Total cluster rows: locals, y/z ghosts, two x-ghost blocks of
        xcap16 j16, and the two sentinel rows."""
        self.nrows_cl = self.ncl_pad + self.gcap_rows + 4 * self.xcap16 + 2

    def _init_host_state(self, x, v):
        """Each held domain's atoms in its slab frame: x0 (acap, 3) sentinel
        padded, v0 (acap, 3) and the 0-d count n0, lists over the held
        domains."""
        p, dev = self.params, self.device
        slab = np.minimum((x[:, 0] / self.slab_w).astype(np.int64), self.ndev - 1)
        self.x0, self.v0, self.n0 = [], [], []
        for d in self.exchange.domains:
            idx = np.nonzero(slab == d)[0]
            n = len(idx)
            if n > self.acap:
                raise RuntimeError(f"slab {d} holds {n} atoms, more than acap {self.acap}")
            xs = np.full((self.acap, 3), SENTINEL_COORD, np.float64)
            vs = np.zeros((self.acap, 3), np.float64)
            xs[:n] = x[idx] - np.array([d * self.slab_w, 0.0, 0.0])
            vs[:n] = v[idx]
            self.x0.append(torch.as_tensor(xs, dtype=p.dtype, device=dev))
            self.v0.append(torch.as_tensor(vs, dtype=p.dtype, device=dev))
            self.n0.append(torch.tensor(n, dtype=torch.int64, device=dev))

    # ---- per-domain phases ----------------------------------------------------

    def _export_rows(self, bbox):
        """The cluster rows of the j16 (locals and y/z ghosts) whose box lies
        within cutneigh of the low and of the high x face, each (2 xcap16,)
        with the sentinel j16's rows in unused slots, and the overflow
        flag."""
        c = self.params.cutneigh
        xcap16 = self.xcap16
        n16 = (self.ncl_pad + self.gcap_rows) // 2
        bb16 = make_j16_bboxes(bbox[: 2 * n16])
        live = bb16[:, 0] < SENTINEL_COORD * 0.25  # an empty box fails
        ids = torch.arange(n16, device=bbox.device)
        sent16 = self.nrows_cl // 2 - 1

        def pack(mask):
            pos = torch.cumsum(mask, 0) - 1
            pos = torch.where(mask & (pos < xcap16), pos, xcap16)
            m = torch.full((xcap16 + 1,), sent16, dtype=torch.int64, device=bbox.device)
            m[pos] = ids
            rows = 2 * m[:xcap16, None] + torch.arange(2, device=bbox.device)[None, :]
            return rows.reshape(-1), mask.sum()

        rows_l, cnt_l = pack(live & (bb16[:, 0] < c))
        rows_r, cnt_r = pack(live & (bb16[:, 1] >= self.slab_w - c))
        return rows_l, rows_r, (cnt_l > xcap16) | (cnt_r > xcap16)

    def _ghosts(self, cl):
        """Local y/z ghosts (refreshed in place, boxes too) and the export
        rows of one domain: (halo, rows_l, rows_r, export overflow)."""
        p = self.params
        halo = setup_cluster_pbc(cl, self.ncl_pad, self.gcap_rows, self.slab_prd,
                                 (0, p.pbc_y, p.pbc_z), p.cutneigh)
        update_cluster_pbc(cl, halo, self.ncl_pad, update_bbox=True)
        return (halo, *self._export_rows(cl.bbox))

    def _lists(self, cl):
        """Bins, group lists and exact unit lists (with the bucket maps of
        the plan) of one domain whose ghost rows are in place: (pairs,
        [bin_cap, z_ext, pairs_nj, pairs_coverage, ilist_nji] flags)."""
        p = self.params
        bb_cells, (ovf_b, ovf_z) = bin_clusters(self.grid, make_j16_bboxes(cl.bbox))
        pairs = build_cluster_pairs(self.grid, bb_cells, cl.bbox, self.ncl_pad, GROUP,
                                    self.list_cap, need_ranges=not self._ilist)
        if not self._ilist:
            return pairs, [ovf_b, ovf_z, *pairs.overflow, torch.zeros_like(ovf_b)]
        pairs = derive_ilists(cl, pairs, self.ncl_pad, GROUP, p.cutneigh, self.icap,
                              share=self.ishare)
        if self.buckets is not None:
            pairs = attach_bucket_maps(pairs, self.ncl_pad, self.ishare, cl.xc.shape[0],
                                       *self.buckets)
        return pairs, [ovf_b, ovf_z, *pairs.overflow, pairs.iovf]

    def _rewrap_yz(self, cl):
        """The cheap rebuild's wrap, in place: a whole j16 pair shifts by a
        box period in y or z when its box midpoint has left the slab's box
        (never in x: the full rebuild migrates); the local boxes are
        recomputed."""
        p = self.params
        npad = self.ncl_pad
        bbox_l = compute_bboxes(cl.xc[:npad], cl.yc[:npad], cl.zc[:npad])
        bb16 = make_j16_bboxes(bbox_l)
        zero = torch.zeros_like(bb16[:, 0]).repeat_interleave(2)
        shifts = [zero, zero]
        for d, plane, L, on in ((1, cl.yc, p.yprd, p.pbc_y), (2, cl.zc, p.zprd, p.pbc_z)):
            mid = 0.5 * (bb16[:, 2 * d] + bb16[:, 2 * d + 1])
            sh = (-float(L) * torch.floor(mid / float(L)) * float(on)).repeat_interleave(2)
            plane[:npad] += sh[:, None]
            shifts += [sh, sh]
        cl.bbox[:npad] = bbox_l + torch.stack(shifts + [zero, zero], dim=1)

    def _flatten(self, d: CDomain):
        """The clusters back to the (acap, 3) atom window through the
        inverse map (reference updateSingleAtoms): (x, v)."""
        inv = d.cl.inv_map
        npad = self.ncl_pad

        def gath(px, py, pz):
            return torch.stack([q[:npad].reshape(-1)[inv] for q in (px, py, pz)], dim=1)

        return gath(d.cl.xc, d.cl.yc, d.cl.zc), gath(d.vxc, d.vyc, d.vzc)

    def _kick_drift(self, d: CDomain):
        """v += dtf f, then x += dt v on the local rows (in place)."""
        dt, dtf = self.params.dt, self.dtforce
        for v, f, x in ((d.vxc, d.fxc, d.cl.xc), (d.vyc, d.fyc, d.cl.yc),
                        (d.vzc, d.fzc, d.cl.zc)):
            v += dtf * f
            x[: self.ncl_pad] += dt * v

    def _kick(self, d: CDomain, f3) -> CDomain:
        """v += dtf f with the new forces; returns the domain holding them."""
        for v, f in zip((d.vxc, d.vyc, d.vzc), f3):
            v += self.dtforce * f
        return d._replace(fxc=f3[0], fyc=f3[1], fzc=f3[2])

    def _lj_force(self, d: CDomain):
        """(fx, fy, fz) of one domain by the kernel axis (module docstring)."""
        p = self.params
        cl, pairs = d.cl, d.pairs
        planes = (cl.xc, cl.yc, cl.zc)
        lj = (p.cutforce**2, p.sigma6, p.epsilon)
        if self._kmode == "ilist_pl":
            if self.buckets is not None and pairs.bijlist is not None:
                return lj_cluster_force_buckets(
                    *planes, pairs.bijlist, pairs.bcrows, pairs.binv, pairs.nji,
                    self.ncl_pad, self.buckets, *lj, share=self.ishare,
                    approx_rcp=p.approx_rcp)
            return lj_cluster_force_ilist(*planes, pairs.ijlist, pairs.nji, self.ncl_pad,
                                          *lj, share=self.ishare, approx_rcp=p.approx_rcp)
        if self._kmode == "ilist":
            return lj_cluster_force_ilist_ref(*planes, pairs.ijlist, self.ncl_pad, *lj,
                                              share=self.ishare)
        if self._kmode == "pallas":
            return lj_cluster_force_stream(*planes, pairs.jlist, pairs.ranges,
                                           self.ncl_pad, *lj)
        return lj_cluster_force_group_ref(*planes, pairs.jlist, self.ncl_pad, *lj)

    def _eam_args(self, d: CDomain):
        """The split EAM passes of one domain: (density, pair force) and
        their list arguments, bucketed once the plan exists."""
        pairs = d.pairs
        bucketed = self.buckets is not None and pairs.bijlist is not None
        kw = dict(share=self.ishare, buckets=self.buckets if bucketed else None,
                  bpairs=(pairs.bijlist, pairs.bcrows, pairs.binv) if bucketed else None)
        if self._kmode == "ilist_pl":
            return eam_cluster_density, eam_cluster_pair_forces, (pairs.ijlist, pairs.nji), kw
        return eam_cluster_density_ref, eam_cluster_pair_forces_ref, (pairs.ijlist,), kw

    # ---- mesh phases: every held domain, then the exchange ----------------

    def _exchange_rows(self, cls, rows_l, rows_r, with_bbox: bool):
        """The x-ghost refresh: gather each domain's exported rows (with their
        boxes at a rebuild), shift them by -+slab_w into the receiver's frame,
        move them to the neighbours, write the x-ghost blocks in place."""
        def payload(cl, rows, xshift):
            parts = [cl.xc[rows] + xshift, cl.yc[rows], cl.zc[rows]]
            if with_bbox:
                bb = cl.bbox[rows]
                bb[:, 0:2] += xshift
                parts.append(bb)
            return torch.cat(parts, dim=1)

        # to the LEFT neighbour: its right side, and the reverse
        send_l = [payload(cl, r, +self.slab_w) for cl, r in zip(cls, rows_l)]
        send_r = [payload(cl, r, -self.slab_w) for cl, r in zip(cls, rows_r)]
        from_right = self.exchange.shift(send_l, -1)
        from_left = self.exchange.shift(send_r, +1)
        g0, nxr = self.ncl_pad + self.gcap_rows, 2 * self.xcap16
        for cl, fl, fr in zip(cls, from_left, from_right):
            for base, rec in ((g0, fl), (g0 + nxr, fr)):
                for k, plane in enumerate((cl.xc, cl.yc, cl.zc)):
                    plane[base : base + nxr] = rec[:, 8 * k : 8 * k + 8]
                if with_bbox:
                    cl.bbox[base : base + nxr] = rec[:, 24:32]

    def _fp_exchange(self, fps, doms):
        """The ghost fp between the EAM passes, in place: local y/z ghosts
        from their owners, then the x-border fp over the exchange with the
        row maps and layout of `_exchange_rows` (no shift: fp is
        translation invariant; the multi-device force_eam.c:117-120)."""
        for fp, d in zip(fps, doms):
            _fp_ghost_refresh(fp, d.halo.border_map, self.ncl_pad)
        from_right = self.exchange.shift([fp[d.rows_l] for fp, d in zip(fps, doms)], -1)
        from_left = self.exchange.shift([fp[d.rows_r] for fp, d in zip(fps, doms)], +1)
        g0, nxr = self.ncl_pad + self.gcap_rows, 2 * self.xcap16
        for fp, fl, fr in zip(fps, from_left, from_right):
            fp[g0 : g0 + nxr] = fl
            fp[g0 + nxr : g0 + 2 * nxr] = fr

    def _reneighbor(self, xs, vs, ns):
        """The full rebuild of every held domain from its (acap, 3) atom
        window. Returns a list of CDomain with no forces and the rebuild's
        flags."""
        p = self.params
        with region("reneighbor"):
            xs = [wrap_dims(x, n, ((1, p.yprd), (2, p.zprd))) for x, n in zip(xs, ns)]
            xs, vs, ns, ovf_m = migrate(self.exchange, xs, vs, ns, self.acap,
                                        self.migcap, self.slab_w)
            built = []
            for x, v in zip(xs, vs):
                cl, ovf_c = build_clusters(self.grid, x, self.acap, self.ncl_pad,
                                           self.gcap_rows + 4 * self.xcap16, group=GROUP)
                valid = cl.atom_id >= 0
                a = cl.atom_id.clamp(0, self.acap - 1)
                vel = tuple(torch.where(valid, v[a, k], 0.0) for k in range(3))
                built.append((cl, vel, ovf_c, self._ghosts(cl)))
            return self._finish_rebuild(built, ns, ovf_m)

    def _rebuild_cheap(self, doms):
        """The cheap rebuild of every held domain (module docstring):
        CDomain with no forces and the rebuild's flags."""
        with region("reneighbor"):
            built = []
            for d in doms:
                self._rewrap_yz(d.cl)
                built.append((d.cl, (d.vxc, d.vyc, d.vzc), torch.zeros_like(d.ovf[0]),
                              self._ghosts(d.cl)))
            f_ = torch.zeros_like(doms[0].ovf[0])
            return self._finish_rebuild(built, [d.nloc for d in doms], [f_] * len(doms))

    def _finish_rebuild(self, built, ns, ovf_m):
        """Both rebuilds' common tail: the x-ghost rows with their boxes,
        then the lists of every domain."""
        self._exchange_rows([b[0] for b in built], [b[3][1] for b in built],
                            [b[3][2] for b in built], True)
        doms = []
        for (cl, vel, ovf_c, (halo, rl, rr, ovf_x)), n, om in zip(built, ns, ovf_m):
            pairs, ovf_l = self._lists(cl)
            ovf = torch.stack([om, ovf_c, halo.overflow, ovf_x, *ovf_l])
            doms.append(CDomain(cl, *vel, None, None, None, n, halo, rl, rr, pairs, ovf))
        return doms

    def _forces(self, doms):
        """The forces (fx, fy, fz) of every held domain."""
        with region("force"):
            if self.eam_dev is None:
                return [self._lj_force(d) for d in doms]
            cutsq = self.params.cutforce**2
            npad = self.ncl_pad
            fps = []
            for d in doms:
                dens, _, lists, kw = self._eam_args(d)
                fps.append(dens(d.cl.xc, d.cl.yc, d.cl.zc, *lists, npad, cutsq,
                                self.eam_dev, self.eam_poly, **kw))
            self._fp_exchange(fps, doms)
            out = []
            for d, fp in zip(doms, fps):
                _, pair, lists, kw = self._eam_args(d)
                out.append(pair(d.cl.xc, d.cl.yc, d.cl.zc, fp, *lists, npad, cutsq,
                                self.eam_poly, **kw))
            return out

    def _temperature(self, doms):
        """The temperature, a 0-d tensor (the kinetic energy's psum)."""
        vsq = [(torch.sum(d.vxc * d.vxc) + torch.sum(d.vyc * d.vyc)
                + torch.sum(d.vzc * d.vzc)) * self.params.mass for d in doms]
        return self.exchange.psum(vsq)[0] * self.scales.t_scale

    # ---- the run --------------------------------------------------------------

    def initial_state(self, xs=None, vs=None, ns=None) -> list:
        """The first full rebuild and forces of every held domain from (xs,
        vs, ns), by default the t = 0 atoms (x0, v0, n0); the inputs are not
        changed."""
        xs = [x.clone() for x in (self.x0 if xs is None else xs)]
        doms = self._reneighbor(xs, self.v0 if vs is None else vs,
                                self.n0 if ns is None else ns)
        return [d._replace(fxc=f[0], fyc=f[1], fzc=f[2])
                for d, f in zip(doms, self._forces(doms))]

    def _plain_step(self, doms, temps: list):
        for d in doms:
            self._kick_drift(d)
            update_cluster_pbc(d.cl, d.halo, self.ncl_pad, False)
        self._exchange_rows([d.cl for d in doms], [d.rows_l for d in doms],
                            [d.rows_r for d in doms], False)
        doms = [self._kick(d, f) for d, f in zip(doms, self._forces(doms))]
        temps.append(self._temperature(doms) if self.params.dense_thermo else None)
        return doms

    def _reneigh_step(self, doms, temps: list, full: bool):
        for d in doms:
            self._kick_drift(d)
        if full:
            flat = [self._flatten(d) for d in doms]
            new = self._reneighbor([f[0] for f in flat], [f[1] for f in flat],
                                   [d.nloc for d in doms])
        else:
            new = self._rebuild_cheap(doms)
        new = [n._replace(ovf=d.ovf | n.ovf) for d, n in zip(doms, new)]
        new = [self._kick(n, f) for n, f in zip(new, self._forces(new))]
        temps.append(self._temperature(new))
        return new

    def _run_steps(self, doms, ntimes: int):
        """max(ntimes // reneigh_every, 1) intervals of (reneigh_every - 1)
        plain steps and one rebuild step, the full rebuild at resort_every
        boundaries (every rebuild without sort_atoms or with resort_every
        <= 0), else the cheap one, as mdbench_tpu's run program. Consumes
        `doms`. Returns (doms, temps), temps a device tensor with one entry a
        step (0 where not taken)."""
        p = self.params
        every = p.reneigh_every
        resort = p.resort_every if p.sort_atoms else 0
        temps: list = []
        for i in range(max(ntimes // every, 1)):
            for _ in range(every - 1):
                doms = self._plain_step(doms, temps)
            full = resort <= 0 or ((i + 1) * every) % resort == 0
            doms = self._reneigh_step(doms, temps, full)
        zero = torch.zeros((), dtype=p.dtype, device=self.device)
        return doms, torch.stack([zero if t is None else t for t in temps])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _gather(self, vals) -> np.ndarray:
        """The values of all ndev domains on the host, stacked."""
        return torch.stack(self.exchange.all_gather(vals)).cpu().numpy()

    def _grow_and_reinit(self, flags) -> None:
        """Targeted capacity growth from the (9,) flags (FLAGS, any domain),
        mdbench_tpu's: each array capacity the flags name grows, and the
        bin, z-extent and coverage flags regrow the grid's slop factors,
        which no capacity fixes. Only an ncl_pad growth drops the bucket
        plan (its sizes hold the units); an icap growth widens it (every
        lower cap by 8, as engine_cluster's grow, the top one to icap).
        Then the domains are re-initialised from t = 0."""
        self.grows.append(tuple(n for n, f in zip(FLAGS, flags) if f))
        blk = 8 * GROUP
        if flags[0]:
            self.migcap = int(self.migcap * 1.4) + 32
            self.acap = (int(self.acap * 1.4) + 39) // 8 * 8
        if flags[1]:
            self.ncl_pad = (int(self.ncl_pad * 1.3) + blk) // blk * blk
        if flags[2]:
            self.gcap_rows = (int(self.gcap_rows * 1.4) + 33) // 2 * 2
        if flags[3]:
            self.xcap16 = int(self.xcap16 * 1.4) + 32
        if flags[6]:
            self.list_cap = (int(self.list_cap * 1.4) + 7) // 8 * 8
        if flags[8]:
            self.icap = (int(self.icap * 1.5) + 7) // 8 * 8
        if flags[4] or flags[5] or flags[7]:
            g = self.grid
            self.grid = make_cluster_grid(
                self.slab_prd, self.params.cutneigh, self.params.rho, GROUP,
                bin_capacity=(int(g.bin_capacity * 1.5 + 3) // 4 * 4 if flags[4]
                              else g.bin_capacity),
                slop_z=g.slop_z * 1.5 if flags[5] else g.slop_z,
                slop_xy=g.slop_xy * 1.5 if flags[5] else g.slop_xy,
                zspan_factor=g.zspan_factor * 1.3 if flags[7] else g.zspan_factor,
                drift_xy=g.drift_xy * 1.5 if flags[7] else g.drift_xy,
            )
        if flags[1]:
            self.buckets = None
        elif self.buckets is not None and flags[8]:
            sizes, caps = self.buckets
            self.buckets = (sizes, tuple(min(c + 8, self.icap) for c in caps[:-1])
                            + (self.icap,))
        self._fix_layout()
        self._init_host_state(*self._xv_init)

    def _calibrate(self, ntimes: int, retries: int = 4) -> None:
        """Once, on the exact-list path (mdbench_tpu's melted probe): a
        throwaway reneighbour interval from t = 0, one more full rebuild
        of its final atoms, and from those melted maxima the ghost and
        export caps, icap and list_cap (wider margins than the single
        engine's: clusters drift for a whole resort interval between
        re-chops) and, on the card's exact-list kernels, the capacity-bucket
        plan from the rank-wise maximum of each domain's sorted list
        lengths, one plan for the whole mesh; then the domains are
        re-initialised."""
        if self._calibrated or not self._ilist:
            return
        self._calibrated = True
        every = self.params.reneigh_every
        if ntimes < every:
            return
        out = self._run_raw(every, retries=retries)
        flat = [self._flatten(d) for d in out.state]
        doms = self._reneighbor([f[0] for f in flat], [f[1] for f in flat],
                                [d.nloc for d in out.state])
        sent = 2 * (self.nrows_cl // 2 - 1)  # the sentinel j16's first row
        nji = self._gather([d.pairs.nji for d in doms])  # (ndev, units)
        nj = self._gather([d.pairs.nj for d in doms])
        ng16 = int(self._gather([d.halo.nghost for d in doms]).max())
        nx16 = int(self._gather([torch.maximum((d.rows_l[0::2] != sent).sum(),
                                               (d.rows_r[0::2] != sent).sum())
                                 for d in doms]).max())
        self.gcap_rows = max((int(ng16 * 2 * 1.25) + 15) // 16 * 16, 64)
        self.xcap16 = max(int(nx16 * 1.25) + 16, 64)
        self.icap = max((int(nji.max() * 1.35) + 2 + 7) // 8 * 8, 16)
        self.list_cap = max((int(nj.max() * 1.45) + 7) // 8 * 8, 32)
        if self._on_card and self._kmode == "ilist_pl":
            self.buckets = plan_capacity_buckets(np.sort(nji, axis=1).max(axis=0),
                                                 self.icap, self.ishare, margin=3,
                                                 zero_tier=True)
        self._fix_layout()
        self._init_host_state(*self._xv_init)

    def run(self, ntimes: Optional[int] = None, repeats: int = 1, chain: int = 1,
            retries: int = 6) -> ClusterDomainResult:
        """Run `ntimes` steps. Set-up calibrates once (the exact-list path);
        an un-timed run then checks the whole trajectory for overflow (grow
        and retry) and gives the temperatures. The timed region is
        `repeats` regions of `chain` back-to-back runs, each from a fresh
        initial state built before the region, fenced with a device
        synchronise; total_time is the median region time / chain, NaN with
        repeats=0 (no timed region)."""
        ntimes = self.params.ntimes if ntimes is None else ntimes
        self._calibrate(ntimes)
        return self._run_raw(ntimes, repeats, chain, retries)

    def _run_raw(self, ntimes: int, repeats: int = 0, chain: int = 1,
                 retries: int = 6) -> ClusterDomainResult:
        for _ in range(retries + 1):
            doms, temps = self._run_steps(self.initial_state(), ntimes)
            flags = self._gather([d.ovf.to(torch.int32) for d in doms]).astype(bool)
            if flags.any():
                self._grow_and_reinit(flags.any(axis=0))
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
            return ClusterDomainResult(
                temps=temps, nlocal=self._gather([d.nloc for d in doms]), overflow=flags,
                total_time=float(np.median(totals)) if totals else float("nan"),
                state=tuple(doms))
        raise RuntimeError("cluster-domain capacity overflow persisted after retries: "
                           + ", ".join(n for n, f in zip(FLAGS, flags.any(axis=0)) if f))
