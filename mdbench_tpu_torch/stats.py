"""Workload statistics (reference COMPUTE_STATS, src/verletlist/stats.c,
src/clusterpair/stats.c): the port of ``mdbench_tpu.stats``.

The reference accumulates per-iteration counters inside its kernels
(addStat). Here, as in mdbench_tpu, the same quantities are computed from
the pair lists with torch ops, off the hot path, once per report, and
scaled by the steps each list was live: the lists do not change between
rebuilds. The counters are exact integers, the same as mdbench_tpu's on
the same state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# width of one "SIMD iteration" in the counters (an 8-atom i-cluster row);
# mdbench_tpu's value, so that both packages print the same block
VECTOR_WIDTH = 8


@dataclass
class Stats:
    total_force_neighs: int = 0
    total_force_iters: int = 0
    atoms_within_cutoff: int = 0
    atoms_outside_cutoff: int = 0
    num_neighs: int = 0  # clusterpair: cluster pairs
    force_iters: int = 0

    def accumulate_list(self, numneigh: np.ndarray, steps_live: int):
        """Add a neighbor list's per-step work, times the steps it was
        used (force runs once per step + once at setup)."""
        nn = int(numneigh.sum())
        iters = int(((numneigh + VECTOR_WIDTH - 1) // VECTOR_WIDTH).sum())
        self.total_force_neighs += nn * steps_live
        self.total_force_iters += iters * steps_live


def _rsq(clusters, rows, jl):
    """(c, r, W) squared distances between the flat i-atom rows `rows`
    (c, r) and the atoms of the j16 lists `jl` (c, K), W = K*16."""
    c, k = jl.shape
    cjn = clusters.xc.shape[0] // 2
    rsq = None
    for p in (clusters.xc, clusters.yc, clusters.zc):
        d = p.reshape(-1)[rows][:, :, None] - p.reshape(cjn, 16)[jl].reshape(c, 1, k * 16)
        rsq = d * d if rsq is None else rsq + d * d
    return rsq


def compute_cluster_stats(
    clusters,
    pairs,
    n_clusters_pad: int,
    group: int,
    cutforcesq: float,
    cutneighsq: float,
    chunk: int = 16,
) -> dict:
    """Exact cluster-scheme counters (reference clusterpair/stats.c:26-85):
    processed cluster pairs, real atom-pair interactions and clusters
    inside the force cutoff, over the pairs the force touches: the
    exact unit lists where the state has them (`_compute_ilist_stats`),
    else the group lists' per-member tile windows, `chunk` groups at a
    time. Returns Python integers: pairs_within_cutforce,
    pairs_within_cutneigh, clusters_within_cutoff, clusters_processed,
    tiles (8-row x 128-atom pair blocks) and padded_pairs (tiles * 1024:
    the pairs the group-window kernel evaluates)."""
    if pairs.ijlist is not None:
        return _compute_ilist_stats(
            clusters, pairs, n_clusters_pad, cutforcesq, cutneighsq)
    ng, L = pairs.jlist.shape
    dev = clusters.xc.device
    gm = group * 8
    jl_all = pairs.jlist.long()
    rg_all = pairs.ranges.long()
    tile_of_lane = (torch.arange(L * 16, device=dev) // 128)[None, None, :]
    member = torch.arange(gm, device=dev) // 8
    tile16 = (torch.arange(L, device=dev) // 8)[None, None, :]
    pf = pn = ci = cp = 0
    for g0 in range(0, ng, chunk):
        g1 = min(g0 + chunk, ng)
        c = g1 - g0
        rg = rg_all[g0:g1]
        rows = (torch.arange(g0, g1, device=dev)[:, None] * gm
                + torch.arange(gm, device=dev)[None, :])
        rsq = _rsq(clusters, rows, jl_all[g0:g1])
        # window mask: lane l -> tile l // 128; row r -> member r // 8
        start = rg[:, member][:, :, None]
        end = rg[:, group + member][:, :, None]
        inwin = (tile_of_lane >= start) & (tile_of_lane < end)
        nonself = rsq > 0.0
        in_force = inwin & nonself & (rsq < cutforcesq)
        pf += int(in_force.sum())
        pn += int((inwin & nonself & (rsq < cutneighsq)).sum())
        # cluster (member, j16) granularity: any atom pair within cutforce
        cl_any = in_force.reshape(c, group, 8, L, 16).any(4).any(2)
        inwin16 = ((tile16 >= rg[:, :group, None])
                   & (tile16 < rg[:, group:2 * group, None]))
        ci += int((cl_any & inwin16).sum())
        cp += int(inwin16.sum())
    tiles = int((rg_all[:, group:2 * group] - rg_all[:, :group]).clamp(min=0).sum())
    return dict(
        pairs_within_cutforce=pf,
        pairs_within_cutneigh=pn,
        clusters_within_cutoff=ci,
        clusters_processed=cp,
        tiles=tiles,
        padded_pairs=tiles * 1024,
    )


def _compute_ilist_stats(
    clusters, pairs, n_clusters_pad: int,
    cutforcesq: float, cutneighsq: float, chunk: int = 256,
) -> dict:
    """Exact counters of the exact-list path, flat capacity: the kernel
    processes every (i-unit row, listed j16) pair, so the counts come
    from ijlist/nji directly (reference clusterpair/stats.c:26-85 at
    unit granularity). padded_pairs is n_units * share*8 * icap*16; the
    bucketed accounting of mdbench_tpu comes with the capacity buckets
    (ROADMAP 1a)."""
    ijl = pairs.ijlist.long()
    nji = pairs.nji.long()
    nu, icap = ijl.shape
    share = n_clusters_pad // nu
    dev = clusters.xc.device
    su = share * 8
    lane_unit = (torch.arange(icap * 16, device=dev) // 16)[None, :]
    pf = pn = ci = 0
    for u0 in range(0, nu, chunk):
        u1 = min(u0 + chunk, nu)
        c = u1 - u0
        rows = (torch.arange(u0, u1, device=dev)[:, None] * su
                + torch.arange(su, device=dev)[None, :])
        rsq = _rsq(clusters, rows, ijl[u0:u1])
        live = (lane_unit < nji[u0:u1, None])[:, None, :]  # listed lanes
        nonself = rsq > 0.0
        in_force = live & nonself & (rsq < cutforcesq)
        pf += int(in_force.sum())
        pn += int((live & nonself & (rsq < cutneighsq)).sum())
        ci += int(in_force.reshape(c, su, icap, 16).any(3).any(1).sum())
    padded = nu * su * icap * 16
    return dict(
        pairs_within_cutforce=pf,
        pairs_within_cutneigh=pn,
        clusters_within_cutoff=ci,
        clusters_processed=int(nji.sum()),
        tiles=padded // (8 * 128),
        padded_pairs=padded,
    )


def display_statistics(
    stats: Stats,
    nlocal: int,
    ntimes: int,
    force_time: float,
    proc_freq: float,
    float_size: int,
) -> str:
    """Render the statistics block (reference stats.c:22-68)."""
    evals = nlocal * (ntimes + 1)
    force_useful_volume = 1e-9 * (
        float(evals) * (float_size * 6 + 4)
        + float(stats.total_force_neighs) * (float_size * 3 + 4)
    )
    avg_neigh = stats.total_force_neighs / float(evals)
    avg_simd = stats.total_force_iters / float(evals)
    lines = ["Statistics:"]
    lines.append(
        "\tVector width: %d, Processor frequency: %.4f GHz"
        % (VECTOR_WIDTH, proc_freq)
    )
    lines.append("\tAverage neighbors per atom: %.4f" % avg_neigh)
    lines.append("\tAverage SIMD iterations per atom: %.4f" % avg_simd)
    lines.append(
        "\tTotal number of computed pair interactions: %d"
        % stats.total_force_neighs
    )
    lines.append(
        "\tTotal number of SIMD iterations: %d" % stats.total_force_iters
    )
    lines.append(
        "\tUseful read data volume for force computation: %.2fGB"
        % force_useful_volume
    )
    if stats.total_force_iters and np.isfinite(force_time):
        lines.append(
            "\tCycles/SIMD iteration: %.4f"
            % (force_time * proc_freq * 1e9 / stats.total_force_iters)
        )
    return "\n".join(lines)
