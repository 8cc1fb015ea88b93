"""The port's cluster list build against mdbench_tpu's, in float64 on the
same flat positions: cluster membership, the ghost map, the group lists
and the exact per-unit lists (as sets), list lengths and every overflow
flag — for a full build and for the cheap (membership-keeping) rebuild."""

import jax
import numpy as np
import pytest
import torch

from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.convert import step_state_from_numpy
from mdbench_tpu_torch.engine_cluster import ClusterSimulation as TSim

torch.set_num_threads(1)


def _positions(n, sigma):
    p = JParams(nx=n, ny=n, nz=n)
    x, v, _ = create_fcc_lattice(p)
    if sigma:
        x = x + np.random.default_rng(11).normal(0.0, sigma, x.shape)
    return x, v


def _sims(n, sigma):
    x, v = _positions(n, sigma)
    kw = dict(nx=n, ny=n, nz=n, precision="dp", scheme="cluster")
    sj = JSim(JParams(**kw), x=x, v=v)
    st = TSim(TParams(**kw), x=x, v=v, device="cpu")
    for cap in ("n_clusters_pad", "ghost_cap", "list_cap", "icap", "ishare"):
        assert getattr(st, cap) == getattr(sj, cap), cap
    assert tuple(st.grid) == tuple(sj.grid)
    return sj, st


def _row_sets(lists, counts):
    return [set(row[:c].tolist()) for row, c in zip(lists, counts)]


def _assert_lists_equal(pj, pt):
    nj = np.asarray(pj.nj)
    np.testing.assert_array_equal(pt.nj.numpy(), nj)
    jl = np.asarray(pj.jlist).reshape(nj.shape[0], -1)
    assert _row_sets(pt.jlist.numpy(), nj) == _row_sets(jl, nj)
    nji = np.asarray(pj.nji)
    np.testing.assert_array_equal(pt.nji.numpy(), nji)
    assert _row_sets(pt.ijlist.numpy(), nji) == _row_sets(np.asarray(pj.ijlist), nji)
    assert (nji > 0).any()
    # past nji every row holds the sentinel j16
    ijl = pt.ijlist.numpy()
    cols = np.arange(ijl.shape[1])[None, :]
    np.testing.assert_array_equal(
        ijl[cols >= nji[:, None]], np.asarray(pj.ijlist)[cols >= nji[:, None]]
    )


@pytest.mark.parametrize("n,sigma", [(6, 0.0), (8, 0.0), (8, 0.1)])
def test_full_build_matches(n, sigma):
    sj, st = _sims(n, sigma)
    cj, vj, hj, pj, oj = jax.jit(sj._reneighbor_from_flat)(sj.x_flat0, sj.v_flat0)
    ct, vt, ht, pt, ot = st._reneighbor_from_flat(st.x_flat0, st.v_flat0)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(ct.atom_id.numpy(), np.asarray(cj.atom_id))
    np.testing.assert_array_equal(ct.inv_map.numpy(), np.asarray(cj.inv_map))
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("xc", "yc", "zc", "bbox"):
        a, b = getattr(ct, name).numpy(), np.asarray(getattr(cj, name))
        real = np.abs(b) < 1e29
        np.testing.assert_array_equal(a[real], b[real])
        # padding: SENTINEL * (1 + rank * 1e-6) in float32, where XLA and
        # torch may round the last bit differently
        np.testing.assert_allclose(a[~real], b[~real], rtol=1e-6)
    assert int(ht.nghost) == int(hj.nghost)
    np.testing.assert_array_equal(ht.border_map.numpy(), np.asarray(hj.border_map))
    _assert_lists_equal(pj, pt)


def test_cheap_rebuild_matches():
    """One step + the cheap rebuild from the same (converted) state."""
    sj, st = _sims(8, 0.1)
    s0 = jax.jit(sj.initial_state)()
    s1j, _ = jax.jit(sj._reneigh_step_cheap)(s0)
    s0t = step_state_from_numpy(s0, "cpu", torch.float64)
    s1t = st._reneigh_step_cheap(s0t, [])
    np.testing.assert_array_equal(s1t.overflow.numpy(), np.asarray(s1j.overflow))
    assert int(s1t.halo.nghost) == int(s1j.halo.nghost)
    np.testing.assert_array_equal(
        s1t.halo.border_map.numpy(), np.asarray(s1j.halo.border_map)
    )
    np.testing.assert_allclose(
        s1t.clusters.xc.numpy(), np.asarray(s1j.clusters.xc), rtol=1e-12, atol=1e-12
    )
    _assert_lists_equal(s1j.pairs, s1t.pairs)


def test_overflow_flags_match_on_small_capacities():
    """Capacities forced below need: both packages raise the same flags."""
    sj, st = _sims(6, 0.0)
    for sim in (sj, st):
        sim.ghost_cap = 64
        sim.list_cap = 16
        sim.icap = 8
    *_, oj = jax.jit(sj._reneighbor_from_flat)(sj.x_flat0, sj.v_flat0)
    *_, ot = st._reneighbor_from_flat(st.x_flat0, st.v_flat0)
    flags = np.asarray(oj)
    assert flags[1] and flags[4] and flags[6]
    np.testing.assert_array_equal(ot.numpy(), flags)
