"""The port's scale path on the CPU: what the 1M and 10.1M runs on the
card (chip_smoke.py phases 46-48) lean on, at small boxes.

(a) the chunked list builds (ops/verlet.py's per-atom lists and both row
    builds, ops/cluster.derive_ilists) on a non-cubic 12x8x6 box give the
    same bits with a chunk limit of 1 << 12 as with the default, and
    mdbench_tpu's lists as sets;
(b) bench.run_bench_scale on the CPU against mdbench_tpu's engines on a
    10x8x6 DP box, both schemes, rel 1e-9 over 40 steps;
(c) bench.check_trace passes its own trace and refuses one moved by 2e-3
    at step 20;
(d) tests/test_parallel.py's quarter-million smoke on the port: 8 slabs
    of an in-process mesh at 128x16x32 cells (262,144 atoms, SP, 4 steps,
    a rebuild every 2) against the single engine, on the per-atom lists
    (kernel "xla", mdbench_tpu's path on the CPU; the row lists' plain
    force takes minutes at this size on one thread);
(e) the 136^3 (10.1M-atom) plans of the single verlet engine and of 8
    slabs, and the 64^3 cluster engine's: every int32 list's and kernel
    argument's largest flat offset stays under 2^31, and the one index
    converted to the coordinates' type (the row build's cell columns) is
    exact in float32."""

import math

import jax
import numpy as np
import pytest
import torch

from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine import Simulation as JSim
from mdbench_tpu.engine_cluster import ClusterSimulation as JCSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops import cells as jcells
from mdbench_tpu.ops import verlet as jver
from mdbench_tpu_torch.bench import check_trace, run_bench_scale
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.engine import Simulation as TSim
from mdbench_tpu_torch.engine import _estimate_ghost_capacity, _estimate_maxneighs
from mdbench_tpu_torch.engine_cluster import GROUP
from mdbench_tpu_torch.engine_cluster import ClusterSimulation as TCSim
from mdbench_tpu_torch.ops import cells as tcells
from mdbench_tpu_torch.ops import cluster as tcl
from mdbench_tpu_torch.ops import verlet as tver
from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation, plan_capacities

torch.set_num_threads(1)

SMALL = 1 << 12  # the chunk limit of (a): every chunked loop takes many chunks
BOX = dict(nx=12, ny=8, nz=6)


def _sets(rows, counts):
    return [set(r[:c].tolist()) for r, c in zip(np.asarray(rows), np.asarray(counts))]


def _chunked(monkeypatch, fn, limit):
    """fn() with ops/verlet.MAX_ELEMS at `limit`; returns (its result, the
    chunk count of each chunked loop it ran)."""
    real, counts = tver._chunks, []

    def counting(n, per_item, max_elems=None):
        out = real(n, per_item, max_elems)
        counts.append(len(out))
        return out

    with monkeypatch.context() as m:
        m.setattr(tver, "MAX_ELEMS", limit)
        m.setattr(tver, "_chunks", counting)
        return fn(), counts


@pytest.fixture(scope="module")
def verlet_state():
    """The port's 12x8x6 rowlist state from a jittered lattice (locals
    bin-sorted at set-up, ghosts cell-sorted): (sim, state)."""
    x, v, _ = create_fcc_lattice(JParams(**BOX))
    x = x + np.random.default_rng(5).normal(0.0, 0.1, x.shape)
    sim = TSim(TParams(**BOX, kernel="rowlist"), x=x, v=v, device="cpu")
    sim.rcap = 128
    st = sim.initial_state()
    assert not bool(st.overflow)
    return sim, st


def test_verlet_lists_chunk_invariant_and_equal_jax(verlet_state, monkeypatch):
    """The per-atom lists and both row builds: the same bits under the
    small chunk limit (which the module reads at each call: setting
    ops.verlet.MAX_ELEMS reaches every loop), and mdbench_tpu's lists as
    sets."""
    sim, st = verlet_state
    p, c = sim.params, sim.caps
    x = st.x
    xj = jax.numpy.asarray(x.numpy())
    gj = jcells.CellGrid(*sim.grid)
    cl = tcells.build_cells(sim.grid, x)
    clj = jcells.build_cells(gj, xj)
    builds = {
        "per-atom": (
            lambda: tver.build_neighbors(sim.grid, cl, x, st.types, p.cutneigh**2,
                                         sim.nlocal, c.nlocal_pad, c.maxneighs, False),
            lambda: jver.build_neighbors(gj, clj, xj, jax.numpy.asarray(st.types.numpy()),
                                         p.cutneigh**2, sim.nlocal, c.nlocal_pad,
                                         c.maxneighs, False)),
        "cells": (
            lambda: tver.derive_rowlists_from_cells(
                sim.grid, cl, x, sim.nlocal, c.nlocal_pad, sim.rcap, p.cutneigh,
                zw=8, brcap=12, ccap=256),
            lambda: jver.derive_rowlists_from_cells(
                gj, clj, xj, sim.nlocal, c.nlocal_pad, sim.rcap, p.cutneigh,
                zw=8, brcap=12, ccap=256)),
        "ranges": (
            lambda: tver.derive_rowlists_from_ranges(
                sim.grid, x, sim.nlocal, c.nlocal_pad, c.ghost, sim.rcap, p.cutneigh),
            lambda: jver.derive_rowlists_from_ranges(
                gj, xj, sim.nlocal, c.nlocal_pad, c.ghost, sim.rcap, p.cutneigh)),
    }
    for name, (port, ref) in builds.items():
        default, n_default = _chunked(monkeypatch, port, tver.MAX_ELEMS)
        small, n_small = _chunked(monkeypatch, port, SMALL)
        assert n_small and min(n_small) > 1 and n_small != n_default, name
        want = ref()
        if name == "per-atom":
            got = (default.neighbors, default.numneigh, default.overflow)
            again = (small.neighbors, small.numneigh, small.overflow)
            want = (want.neighbors, want.numneigh, want.overflow)
        else:
            got, again = default, small
        for a, b in zip(got, again):
            assert torch.equal(a, b), name
        lists, counts, ovf = got[0], got[1], got[-1]
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want[1]))
        assert _sets(lists, counts) == _sets(want[0], want[1]), name
        assert not bool(ovf) and not bool(want[-1]), name
        assert int(counts.max()) > 16, name


def test_derive_ilists_chunk_invariant_and_equal_jax():
    """derive_ilists on the 12x8x6 cluster box: the same bits with
    max_elems=1 << 12 (one group a chunk) as with the default, and the
    exact lists of mdbench_tpu's full build as sets."""
    kw = dict(**BOX, precision="dp", scheme="cluster")
    x, v, _ = create_fcc_lattice(JParams(**kw))
    x = x + np.random.default_rng(11).normal(0.0, 0.1, x.shape)
    sj = JCSim(JParams(**kw), x=x, v=v)
    st = TCSim(TParams(**kw), x=x, v=v, device="cpu")
    pj = jax.jit(sj._reneighbor_from_flat)(sj.x_flat0, sj.v_flat0)[3]
    cl, _, _, pt, ovf = st._reneighbor_from_flat(st.x_flat0, st.v_flat0)
    assert not ovf.any()
    args = (cl, pt, st.n_clusters_pad, GROUP, st.params.cutneigh, st.icap)
    default = tcl.derive_ilists(*args, share=st.ishare)
    small = tcl.derive_ilists(*args, share=st.ishare, max_elems=SMALL)
    assert SMALL // (GROUP * tcl.M * pt.jlist.shape[1] * tcl.N_J) < 1 < pt.jlist.shape[0]
    for name in ("ijlist", "nji", "iovf"):
        assert torch.equal(getattr(default, name), getattr(small, name)), name
    assert torch.equal(default.ijlist, pt.ijlist)
    nji = np.asarray(pj.nji)
    np.testing.assert_array_equal(default.nji.numpy(), nji)
    assert _sets(default.ijlist, nji) == _sets(pj.ijlist, nji)
    assert int(nji.max()) > 8


@pytest.mark.parametrize("scheme", ["verlet", "cluster"])
def test_run_bench_scale_matches_jax(scheme):
    """run_bench_scale(device="cpu") on a 10x8x6 DP box, thermo at the
    rebuilds (dense_thermo off, as the scale runs take it), against
    mdbench_tpu's engine of the same scheme (the verlet row lists against
    its rowlist path)."""
    box = dict(nx=10, ny=8, nz=6)
    sim, out, rate, peak = run_bench_scale((10, 8, 6), 40, scheme=scheme,
                                           precision="dp", repeats=0, device="cpu")
    assert peak is None and math.isnan(rate)
    assert sim.natoms == 4 * 10 * 8 * 6 and sim.setup_time > 0 and sim.construct_time > 0
    kw = dict(**box, ntimes=40, precision="dp", scheme=scheme, dense_thermo=False)
    if scheme == "verlet":
        ref = JSim(JParams(**kw, kernel="rowlist")).run()
    else:
        ref = JCSim(JParams(**kw)).run()
    np.testing.assert_array_equal(np.nonzero(out.temps)[0], [19, 39])
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-9)


def test_check_trace():
    temps = np.linspace(0.7, 0.8, 40)
    check_trace(temps, temps, (20, 40), (1e-3, 1e-3))
    moved = temps.copy()
    moved[19] *= 1.0 + 2e-3
    with pytest.raises(SystemExit, match="TRACE GATE FAILED at step 20"):
        check_trace(moved, temps, (20, 40), (1e-3, 1e-3))
    with pytest.raises(SystemExit, match="step 40"):
        check_trace(temps * np.where(np.arange(40) == 39, np.nan, 1.0), temps,
                    (20, 40), (1e-3, 1e-3))


def test_eight_slabs_quarter_million():
    """tests/test_parallel.py:140-161 on the port: 262,144 atoms on 8 slabs
    of the in-process mesh, SP, 4 steps across two rebuilds: every atom on
    some slab, finite temperatures within rel 1e-6 of the single engine's
    at every step."""
    kw = dict(nx=128, ny=16, nz=32, ntimes=4, reneigh_every=2, precision="sp",
              kernel="xla")
    dom = DomainSimulation(TParams(**kw), ndev=8, device="cpu")
    out = dom.run(repeats=0)
    assert dom.natoms == 262_144
    assert sum(int(n) for n in out.state.nlocal) == dom.natoms
    assert np.isfinite(out.temps).all()
    single = TSim(TParams(**kw), device="cpu").run(repeats=0)
    assert out.temps.shape == single.temps.shape == (4,)
    np.testing.assert_allclose(out.temps, single.temps, rtol=1e-6)


def test_scale_plans_stay_under_2_31():
    """The largest flat offsets of the 10.1M runs' int32 lists and kernel
    arguments, from the engines' own capacity rules grown as far as their
    retries go, stay under 2^31; the cluster engine's at 64^3 too."""
    lim = 2**31
    p = TParams(nx=136, ny=136, nz=136, precision="sp")
    natoms = 4 * 136**3
    # the single verlet engine: locals in blocks of 1024, its ghost
    # estimate grown 1.5x on each of run()'s 3 retries and the melt
    # calibration's 3, row-list caps 1.6x from 64 with the same count
    nlocal_pad = -(-natoms // 1024) * 1024
    ghost = int(_estimate_ghost_capacity(p, natoms) * 1.5**6)
    nrows = (nlocal_pad + ghost + 31) // 16 * 16
    rcap = int(64 * 1.6**6 + 7) // 8 * 8
    nu = nlocal_pad // 16
    maxneighs = int(_estimate_maxneighs(p) * 1.3**6) + 8
    offsets = {
        "x (nrows, 3): K5/K6 rows, the planes": 3 * nrows,
        "K1 planes (C_total, 8): j16 id x 16 + 15": nrows,
        "row lists (nu, rcap) int32": nu * rcap,
        "bucket maps: bcrows (nu * 2,)": nu * 2,
        # K5/K6's int arguments; their per-atom lists are int64 and the
        # kernels offset them in 64 bits (nlocal_pad * K passes 2^31 here)
        "K5/K6 nrows, nlocal_pad, K": max(nrows, nlocal_pad, maxneighs),
    }
    # the verlet EAM scale run's per-atom lists (64^3 cells)
    n1m = 4 * 64**3
    offsets["per-atom lists at 64^3 (nlocal_pad, K)"] = (
        -(-n1m // 256) * 256 * maxneighs)
    # 8 slabs: plan_capacities' caps grown 1.4x on each of 6 retries
    plan = plan_capacities(p, 8, natoms)
    g = 1.4**6
    acap = int(plan["acap"] * g) + 8
    slab_rows = acap + int(plan["gcap"] * g) + 2 * int(plan["bcap"] * g) + 16
    offsets["slab x (rows, 3)"] = 3 * slab_rows
    offsets["slab row lists"] = acap // 16 * rcap
    # the cluster engine at 64^3 (its scale run), from its constructor's
    # estimates, the exact lists' icap and the group lists' L grown 1.5x
    # three times
    cs = TCSim(TParams(nx=64, ny=64, nz=64, precision="sp", scheme="cluster"),
               device="cpu")
    c_total = cs.n_clusters_pad + int(cs.ghost_cap * 1.5**3) + 2
    offsets["cluster planes (C_total, 8)"] = 8 * c_total
    offsets["exact lists (units, icap) int32"] = (
        cs.n_clusters_pad // cs.ishare * int(cs.icap * 1.5**3))
    offsets["group lists (NG, L) int32"] = (
        cs.n_clusters_pad // GROUP * int(cs.list_cap * 1.5**3))
    for name, n in offsets.items():
        assert 0 < n < lim, (name, n)
    # the row build converts cell columns (ops/verlet.py, bxc/byc) to the
    # coordinates' type: exact in float32 below 2^24
    grid = tcells.make_cell_grid(np.array([p.xprd, p.yprd, p.zprd]), p.cutneigh, p.rho)
    assert grid.dims[0] * grid.dims[1] < 2**24
    cols = torch.arange(grid.dims[0] * grid.dims[1])
    assert torch.equal((cols // grid.dims[1]).to(torch.float32).long(),
                       cols // grid.dims[1])
    # the row and column sentinels of the row builds stay above every id
    assert grid.nbins < tver.COL_BIG and nrows // 16 < tver.RBIG
