"""The port's verlet-scheme modules against mdbench_tpu's, in float64 on
the CPU, on the same numpy inputs: the cell table and the device re-sort
(equal), the halo (border_map, shift, nghost and the sorted ghost order:
equal; two-stage and small-box forms), the per-atom lists (full, half,
typed: equal), the row lists of all three builds (equal, in the same
order, with numrows, the observed maxima and the overflow flags), the
planar full and half forces and the energy/virial (to 1e-10 of max
|value|), the row-list force against mdbench_tpu's XLA twin (1e-10), the
bucket planner and maps on row lists (bit for bit), the bucketed plain
force (equal to the flat one in float64; float32 against mdbench_tpu's
Pallas kernel in interpret mode per bucket, 1e-5), and the converters.

The inputs are a jittered lattice and the port's own state after a
20-step melt (locals bin-sorted at the rebuild, ghosts cell-sorted): the
row builds depend on those invariants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hand_plan
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine import Simulation as JSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops import cells as jcells
from mdbench_tpu.ops import cluster as jcl
from mdbench_tpu.ops import lj as jlj
from mdbench_tpu.ops import pbc as jpbc
from mdbench_tpu.ops import verlet as jver
from mdbench_tpu.state import Halo as JHalo
from mdbench_tpu_torch import convert
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.engine import Simulation as TSim
from mdbench_tpu_torch.ops import cells as tcells
from mdbench_tpu_torch.ops import cluster as tcl
from mdbench_tpu_torch.ops import lj as tlj
from mdbench_tpu_torch.ops import pbc as tpbc
from mdbench_tpu_torch.ops import verlet as tver
from mdbench_tpu_torch.state import Halo as THalo

torch.set_num_threads(1)


def _t(a, dtype=None):
    a = np.asarray(a)
    return torch.tensor(a, dtype=dtype) if dtype else torch.tensor(a)


def _jg(grid):
    """The port's CellGrid as mdbench_tpu's (same fields), or None."""
    return None if grid is None else jcells.CellGrid(*grid)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def melted():
    """The port's 6^3 rowlist state after 20 steps (a rebuild with the
    re-sort at step 20): (sim, state)."""
    sim = TSim(TParams(nx=6, ny=6, nz=6, kernel="rowlist"), device="cpu")
    sim.rcap = 128  # the melt outgrows the default cap
    st, _, _ = sim._run_steps(sim.initial_state(), 20)
    assert not bool(st.overflow)
    return sim, st


def _jittered_x(n=6, sigma=0.1, seed=3):
    """A jittered nx^3 lattice in a sentinel-padded (nrows, 3) buffer with
    the engine's layout, locals sorted by bin: (sim, x numpy)."""
    sim = TSim(TParams(nx=n, ny=n, nz=n, kernel="xla"), device="cpu")
    x = sim.x0.numpy().copy()
    x[: sim.nlocal] += np.random.default_rng(seed).normal(0.0, sigma,
                                                            (sim.nlocal, 3))
    return sim, x


def _ghosted(sim, x):
    """x with its ghost rows (port setup_pbc + update_pbc) as numpy."""
    p = sim.params
    xt = tpbc.update_pbc(
        _t(x), tpbc.setup_pbc(_t(x), sim.nlocal, sim.caps.nlocal_pad, sim.caps.ghost,
                              sim.prd, (1, 1, 1), p.cutneigh), sim.caps.nlocal_pad)
    return xt.numpy()


def test_lists_of_atoms_that_left_the_box():
    """Locals that left the box since their last wrap sit in the margin
    bins, whose stencils reach past the grid: those stencil bins read the
    trap bin, and each atom's list is every row within cutneigh (brute
    force), as on any other atom."""
    sim, x = _jittered_x()
    n, p = sim.nlocal, sim.params
    x[:n] = np.mod(x[:n], sim.prd)
    halo = tpbc.setup_pbc(_t(x), n, sim.caps.nlocal_pad, sim.caps.ghost, sim.prd,
                          (1, 1, 1), p.cutneigh)
    moved = [0, 7, 50, 100, 150, 200]
    for k, i in enumerate(moved):
        d = k % 3
        x[i, d] = -0.01 if k < 3 else sim.prd[d] + 0.01
    xt = tpbc.update_pbc(_t(x), halo, sim.caps.nlocal_pad)
    ib = tcells.coord_to_bin(sim.grid, xt)[moved]
    bins = tcells.stencil_bins(sim.grid, ib)
    assert bool((bins == sim.grid.nbins).any(1).all())
    assert bool(((bins >= 0) & (bins <= sim.grid.nbins)).all())
    nl = tver.build_neighbors(sim.grid, tcells.build_cells(sim.grid, xt), xt,
                              sim.types0, p.cutneigh**2, n, sim.caps.nlocal_pad,
                              sim.caps.maxneighs, half=False)
    xa = xt.numpy()
    rsq = ((xa[:n, None, :] - xa[None, :-1, :]) ** 2).sum(-1)
    for i in range(n):
        want = set(np.flatnonzero(rsq[i] <= p.cutneigh**2)) - {i}
        got = nl.neighbors[i, : int(nl.numneigh[i])].tolist()
        assert set(got) == want and len(got) == len(want), i


def test_cell_table_and_sort_equal_jax():
    sim, x = _jittered_x()
    x = _ghosted(sim, x)
    cj = jcells.build_cells(_jg(sim.grid), jnp.asarray(x))
    ct = tcells.build_cells(sim.grid, _t(x))
    np.testing.assert_array_equal(ct.cells.numpy(), np.asarray(cj.cells))
    np.testing.assert_array_equal(ct.bin_of.numpy(), np.asarray(cj.bin_of))
    assert bool(ct.overflow) == bool(cj.overflow) is False
    np.testing.assert_array_equal(tcells.stencil_offsets(sim.grid, "cpu").numpy(),
                                  _jg(sim.grid).stencil)
    # a too-small capacity overflows in both
    small = sim.grid._replace(capacity=8)
    assert bool(tcells.build_cells(small, _t(x)).overflow)
    assert bool(jcells.build_cells(_jg(small), jnp.asarray(x)).overflow)
    # the device re-sort of shuffled locals
    rng = np.random.default_rng(1)
    n = sim.nlocal
    xs = x.copy()
    xs[:n] = xs[rng.permutation(n)]
    xs[:n] = np.mod(xs[:n], sim.prd)
    v = rng.normal(size=(sim.caps.nlocal_pad, 3))
    ty = rng.integers(0, 3, x.shape[0]).astype(np.int32)
    out_j = jcells.sort_atoms_device(_jg(sim.grid), jnp.asarray(xs), jnp.asarray(v),
                                     jnp.asarray(ty), n)
    out_t = tcells.sort_atoms_device(sim.grid, _t(xs), _t(v), _t(ty), n)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tcells.sort_atoms_host(sim.grid, xs[:n]), jcells.sort_atoms_host(_jg(sim.grid), xs[:n]))


@pytest.mark.parametrize("n, sort", [(6, False), (6, True), (3, False), (3, True)])
def test_halo_equals_jax(n, sort):
    """border_map, shift, nghost, overflow and the ghost order, on the
    two-stage form (6^3) and the small-box 26-candidate form (3^3); with
    sort_grid the ghosts are ordered by cell."""
    sim, x = _jittered_x(n, sigma=0.2)
    p, caps = sim.params, sim.caps
    args = (sim.nlocal, caps.nlocal_pad, caps.ghost, sim.prd, (1, 1, 1), p.cutneigh)
    grid = sim.grid if sort else None
    hj = jpbc.setup_pbc(jnp.asarray(x), *args, sort_grid=_jg(grid))
    ht = tpbc.setup_pbc(_t(x), *args, sort_grid=grid)
    for name in ("border_map", "shift", "nghost", "overflow"):
        np.testing.assert_array_equal(getattr(ht, name).numpy(),
                                      np.asarray(getattr(hj, name)), err_msg=name)
    assert int(ht.nghost) > 0
    xj = jpbc.update_pbc(jnp.asarray(x), hj, caps.nlocal_pad)
    xt = tpbc.update_pbc(_t(x), ht, caps.nlocal_pad)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    ty = np.arange(x.shape[0], dtype=np.int32) % 5
    np.testing.assert_array_equal(
        tpbc.ghost_types(_t(ty), ht, caps.nlocal_pad).numpy(),
        np.asarray(jpbc.ghost_types(jnp.asarray(ty), hj, caps.nlocal_pad)))
    # a ghost capacity below the count overflows in both
    small = (sim.nlocal, caps.nlocal_pad, 64, sim.prd, (1, 1, 1), p.cutneigh)
    assert bool(tpbc.setup_pbc(_t(x), *small).overflow)
    assert bool(jpbc.setup_pbc(jnp.asarray(x), *small).overflow)


def test_halo_without_periodic_dimensions():
    sim, x = _jittered_x(4)
    p, caps = sim.params, sim.caps
    for pbc in ((0, 0, 0), (1, 0, 1)):
        args = (sim.nlocal, caps.nlocal_pad, caps.ghost, sim.prd, pbc, p.cutneigh)
        hj = jpbc.setup_pbc(jnp.asarray(x), *args)
        ht = tpbc.setup_pbc(_t(x), *args)
        np.testing.assert_array_equal(ht.border_map.numpy(), np.asarray(hj.border_map))
        np.testing.assert_array_equal(ht.shift.numpy(), np.asarray(hj.shift))
        assert int(ht.nghost) == int(hj.nghost)


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("typed", [False, True])
def test_per_atom_lists_equal_jax(half, typed):
    sim, x = _jittered_x()
    x = _ghosted(sim, x)
    caps = sim.caps
    cut = sim.params.cutneigh**2
    ty = np.zeros(x.shape[0], np.int32)
    if typed:
        ty[: sim.nlocal] = np.arange(sim.nlocal) % 2
        cut = np.array([[cut, 2.2**2], [2.2**2, 2.6**2]])
    cl_j = jcells.build_cells(_jg(sim.grid), jnp.asarray(x))
    cl_t = tcells.build_cells(sim.grid, _t(x))
    nj = jver.build_neighbors(_jg(sim.grid), cl_j, jnp.asarray(x), jnp.asarray(ty),
                              jnp.asarray(cut), sim.nlocal, caps.nlocal_pad,
                              caps.maxneighs, half)
    nt = tver.build_neighbors(sim.grid, cl_t, _t(x), _t(ty),
                              _t(cut) if typed else cut, sim.nlocal, caps.nlocal_pad,
                              caps.maxneighs, half)
    np.testing.assert_array_equal(nt.numneigh.numpy(), np.asarray(nj.numneigh))
    np.testing.assert_array_equal(nt.neighbors.numpy(), np.asarray(nj.neighbors))
    assert bool(nt.overflow) == bool(nj.overflow) is False
    assert int(nt.numneigh.max()) > 20
    # too narrow a list overflows in both
    short = tver.build_neighbors(sim.grid, cl_t, _t(x), _t(ty),
                                 _t(cut) if typed else cut, sim.nlocal,
                                 caps.nlocal_pad, 16, half)
    assert bool(short.overflow)


def _rowlists_both(sim, st, build, **caps):
    """One row build of the port and of mdbench_tpu on the same x."""
    p, c = sim.params, sim.caps
    x = st.x.numpy()
    if build == "ranges":
        args = (sim.nlocal, c.nlocal_pad, c.ghost, caps.get("rcap", sim.rcap), p.cutneigh)
        kw = dict(ucol=caps.get("ucol", 4), kcap=caps.get("kcap", 40),
                  ccap=caps.get("ccap", 128))
        out_j = jver.derive_rowlists_from_ranges(_jg(sim.grid), jnp.asarray(x), *args, **kw)
        out_t = tver.derive_rowlists_from_ranges(sim.grid, _t(x), *args, **kw)
    else:
        args = (sim.nlocal, c.nlocal_pad, caps.get("rcap", sim.rcap), p.cutneigh)
        kw = dict(brcap=caps.get("brcap", 8), ucol=caps.get("ucol", 4),
                  zw=caps.get("zw", 4), ccap=caps.get("ccap", 128))
        out_j = jver.derive_rowlists_from_cells(
            _jg(sim.grid), jcells.build_cells(_jg(sim.grid), jnp.asarray(x)), jnp.asarray(x),
            *args, **kw)
        out_t = tver.derive_rowlists_from_cells(
            sim.grid, tcells.build_cells(sim.grid, _t(x)), _t(x), *args, **kw)
    return out_t, out_j


@pytest.mark.parametrize("build", ["ranges", "cells"])
def test_rowlists_equal_jax_in_order(melted, build):
    sim, st = melted
    # the cells build's caps with room over this state's maxima
    caps = {"brcap": 12, "zw": 8, "ccap": 256} if build == "cells" else {}
    (rows, nr, stats, ovf), (rj, nrj, sj, oj) = _rowlists_both(sim, st, build, **caps)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(nr.numpy(), np.asarray(nrj))
    np.testing.assert_array_equal(stats.numpy(), np.asarray(sj))
    assert bool(ovf) == bool(oj) is False
    # the engine's own rebuild gave these rows too
    np.testing.assert_array_equal(st.nlist.rows.numpy(), rows.numpy())
    assert int(nr.max()) > 64


@pytest.mark.parametrize("build, caps", [
    ("ranges", {"rcap": 16}), ("ranges", {"ccap": 24}), ("ranges", {"ucol": 1}),
    ("ranges", {"kcap": 8}), ("cells", {"rcap": 16}), ("cells", {"brcap": 2}),
    ("cells", {"zw": 3}), ("cells", {"ccap": 24}),
])
def test_rowlist_overflow_flags_equal_jax(melted, build, caps):
    """Each cap below the need raises the overflow flag in both packages,
    with the same observed maxima (the engine's growth reads them)."""
    sim, st = melted
    (_, nr, stats, ovf), (_, nrj, sj, oj) = _rowlists_both(sim, st, build, **caps)
    assert bool(ovf) and bool(oj)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(sj))
    if "rcap" in caps:
        np.testing.assert_array_equal(nr.numpy(), np.asarray(nrj))


def test_union_rowlists_equal_jax_and_builds(melted):
    """derive_rowlists (the union of the per-atom lists) equals
    mdbench_tpu's, and the range build's on the units with atoms."""
    sim, st = melted
    c = sim.caps
    x = st.x.numpy()
    cl_t = tcells.build_cells(sim.grid, _t(x))
    nl_t = tver.build_neighbors(sim.grid, cl_t, _t(x), st.types, sim.params.cutneigh**2,
                                sim.nlocal, c.nlocal_pad, c.maxneighs, False)
    nl_j = jver.build_neighbors(_jg(sim.grid), jcells.build_cells(_jg(sim.grid), jnp.asarray(x)),
                                jnp.asarray(x), jnp.asarray(st.types.numpy()),
                                sim.params.cutneigh**2, sim.nlocal, c.nlocal_pad,
                                c.maxneighs, False)
    rt, nt_, ot = tver.derive_rowlists(nl_t, c.nlocal_pad, x.shape[0], sim.rcap)
    rj, nj_, oj = jver.derive_rowlists(nl_j, c.nlocal_pad, x.shape[0], sim.rcap)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(nt_.numpy(), np.asarray(nj_))
    assert bool(ot) == bool(oj) is False
    rows, nr, _, _ = tver.derive_rowlists_from_ranges(
        sim.grid, _t(x), sim.nlocal, c.nlocal_pad, c.ghost, sim.rcap, sim.params.cutneigh)
    # the units that hold atoms (the union also lists an all-padding unit's
    # own row, which the direct builds prune)
    real = -(-sim.nlocal // 16)
    np.testing.assert_array_equal(rows.numpy()[:real], rt.numpy()[:real])
    np.testing.assert_array_equal(nr.numpy()[:real], nt_.numpy()[:real])
    assert not nr[real:].any()


@pytest.mark.parametrize("half", [False, True])
def test_planar_forces_match_jax(half):
    sim, x = _jittered_x()
    x = _ghosted(sim, x)
    c, p = sim.caps, sim.params
    cl = tcells.build_cells(sim.grid, _t(x))
    nl = tver.build_neighbors(sim.grid, cl, _t(x), torch.zeros(x.shape[0], dtype=torch.int32),
                              p.cutneigh**2, sim.nlocal, c.nlocal_pad, c.maxneighs, half)
    lj = (p.cutforce**2, p.sigma6, p.epsilon)
    nb, nn = jnp.asarray(nl.neighbors.numpy()), jnp.asarray(nl.numneigh.numpy())
    if half:
        ft = tlj.compute_force_lj_half(_t(x), nl.neighbors, nl.numneigh, sim.nlocal,
                                       c.nlocal_pad, *lj)
        fj = jlj.compute_force_lj_half(jnp.asarray(x), nb, nn, sim.nlocal, c.nlocal_pad,
                                       *lj)
    else:
        ft = tlj.compute_force_lj_full(_t(x), nl.neighbors, nl.numneigh, c.nlocal_pad, *lj)
        fj = jlj.compute_force_lj_full(jnp.asarray(x), nb, nn, c.nlocal_pad, *lj)
        et, wt = tlj.lj_energy_virial(_t(x), nl.neighbors, nl.numneigh, c.nlocal_pad, *lj)
        ej, wj = jlj.lj_energy_virial(jnp.asarray(x), nb, nn, c.nlocal_pad, *lj)
        assert float(et) == pytest.approx(float(ej), rel=1e-10)
        assert float(wt) == pytest.approx(float(wj), rel=1e-10)
    assert np.abs(np.asarray(fj)).max() > 1.0
    assert _rel(ft.numpy(), fj) < 1e-10


def test_typed_planar_force_matches_jax():
    """The tables' per-pair cutoff, sigma^6 and epsilon (full list)."""
    from mdbench_tpu.state import TypeTables as JTables
    from mdbench_tpu_torch.state import TypeTables as TTables

    sim, x = _jittered_x()
    x = _ghosted(sim, x)
    c = sim.caps
    ty = (np.arange(x.shape[0]) % 2).astype(np.int32)
    tabs = dict(epsilon=np.array([[1.0, 0.7], [0.7, 1.3]]),
                sigma6=np.array([[1.0, 0.95], [0.95, 1.05]]) ** 6,
                cutforcesq=np.full((2, 2), 2.5**2), cutneighsq=np.full((2, 2), 2.8**2))
    cl = tcells.build_cells(sim.grid, _t(x))
    nl = tver.build_neighbors(sim.grid, cl, _t(x), _t(ty), _t(tabs["cutneighsq"]),
                              sim.nlocal, c.nlocal_pad, c.maxneighs, False)
    tt = TTables(types=_t(ty), **{k: _t(v) for k, v in tabs.items()})
    tj = JTables(types=jnp.asarray(ty), **{k: jnp.asarray(v) for k, v in tabs.items()})
    ft = tlj.compute_force_lj_full(_t(x), nl.neighbors, nl.numneigh, c.nlocal_pad,
                                   None, None, None, types=_t(ty), tables=tt)
    fj = jlj.compute_force_lj_full(jnp.asarray(x), jnp.asarray(nl.neighbors.numpy()),
                                   jnp.asarray(nl.numneigh.numpy()), c.nlocal_pad,
                                   None, None, None, types=jnp.asarray(ty), tables=tj)
    assert _rel(ft.numpy(), fj) < 1e-10


def test_rowlist_force_matches_jax_xla_twin_and_planar(melted):
    sim, st = melted
    p, c = sim.params, sim.caps
    lj = (p.cutforce**2, p.sigma6, p.epsilon)
    x = st.x.numpy()
    ft = tver.compute_force_lj_rowlist(st.x, st.nlist.rows, st.nlist.numrows,
                                       c.nlocal_pad, *lj)
    fj = jver.compute_force_lj_rowlist(jnp.asarray(x), jnp.asarray(st.nlist.rows.numpy()),
                                       c.nlocal_pad, *lj, backend="xla")
    assert np.abs(np.asarray(fj)).max() > 1.0
    assert _rel(ft.numpy(), fj) < 1e-10
    np.testing.assert_allclose(ft.numpy(), st.f.numpy(), rtol=0, atol=1e-12)
    # the planar per-atom force on the same coordinates
    nl = tver.build_neighbors(sim.grid, tcells.build_cells(sim.grid, st.x), st.x,
                              st.types, p.cutneigh**2, sim.nlocal, c.nlocal_pad,
                              c.maxneighs, False)
    fp = tlj.compute_force_lj_full(st.x, nl.neighbors, nl.numneigh, c.nlocal_pad, *lj)
    assert _rel(ft.numpy(), fp.numpy()) < 1e-10


def _numrows_4096(numrows: np.ndarray) -> np.ndarray:
    """A 4096-unit list-length distribution tiled from a small box's (the
    planner refuses fewer units)."""
    return np.tile(numrows, -(-4096 // numrows.shape[0]))[:4096 + 64]


def test_bucket_plan_and_maps_equal_jax(melted):
    sim, st = melted
    c = sim.caps
    nrh = st.nlist.numrows.numpy()
    big = _numrows_4096(nrh)
    for cap in (sim.rcap, int(nrh.max() * 1.3 + 7) // 8 * 8):
        plan_t = tcl.plan_capacity_buckets(big, cap, 2, zero_tier=True)
        plan_j = jcl.plan_capacity_buckets(big, cap, 2, zero_tier=True)
        assert plan_t == plan_j and plan_t is not None
    plan = hand_plan(nrh, sim.rcap, gran=8)
    out_t = tcl.bucket_maps_core(st.nlist.rows, st.nlist.numrows, c.nlocal_pad // 8, 2,
                                 st.x.shape[0] // 8, *plan)
    out_j = jcl.bucket_maps_core(jnp.asarray(st.nlist.rows.numpy()),
                                 jnp.asarray(st.nlist.numrows.numpy()), c.nlocal_pad // 8,
                                 2, st.x.shape[0] // 8, *plan)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bucketed_rowlist_force(melted):
    """The bucketed plain force equals the flat one in float64; in float32
    it meets mdbench_tpu's bucketed Pallas calls in interpret mode."""
    sim, st = melted
    p, c = sim.params, sim.caps
    lj = (p.cutforce**2, p.sigma6, p.epsilon)
    # sizes in multiples of 64 units: mdbench_tpu's Pallas calls need them
    plan = hand_plan(st.nlist.numrows.numpy(), sim.rcap, gran=64)
    maps = tcl.bucket_maps_core(st.nlist.rows, st.nlist.numrows, c.nlocal_pad // 8, 2,
                                st.x.shape[0] // 8, *plan)[:3]
    kw = dict(buckets=plan, brows=maps[0], bcrows=maps[1], binv=maps[2])
    flat = tver.compute_force_lj_rowlist(st.x, st.nlist.rows, st.nlist.numrows,
                                         c.nlocal_pad, *lj)
    buck = tver.compute_force_lj_rowlist(st.x, st.nlist.rows, st.nlist.numrows,
                                         c.nlocal_pad, *lj, **kw)
    np.testing.assert_array_equal(buck.numpy(), flat.numpy())
    x32 = st.x.float()
    b32 = tver.compute_force_lj_rowlist(x32, st.nlist.rows, st.nlist.numrows,
                                        c.nlocal_pad, *lj, **kw)
    fj = jver.compute_force_lj_rowlist(
        jnp.asarray(x32.numpy()), jnp.asarray(st.nlist.rows.numpy()), c.nlocal_pad, *lj,
        backend="pallas", interpret=True, buckets=plan,
        **{k: jnp.asarray(v.numpy()) for k, v in zip(("brows", "bcrows", "binv"), maps)})
    assert _rel(b32.numpy(), fj) < 1e-5


def test_converters_carry_jax_state():
    """mdbench_tpu's verlet state (rowlist and planar) through
    convert.verlet_step_state_from_numpy: the port's force on it equals
    mdbench_tpu's step-0 force."""
    for kernel in ("rowlist", "xla"):
        kw = dict(nx=4, ny=4, nz=4, kernel=kernel)
        x, v, _ = create_fcc_lattice(JParams(**kw))
        x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
        js = JSim(JParams(**kw), x=x, v=v)
        jst = js.initial_state()
        sim = TSim(TParams(**kw), x=x, v=v, device="cpu")
        st = convert.verlet_step_state_from_numpy(jst, "cpu", torch.float64)
        assert isinstance(st.halo, THalo) and isinstance(jst.halo, JHalo)
        assert (st.nlist.rows is None) == (kernel == "xla")
        f = sim._force(st.x, st.types, st.nlist, st.halo)
        assert _rel(f.numpy(), jst.f) < 1e-10
        assert st.nlist.rows is None or st.nlist.rows.dtype == torch.int32
