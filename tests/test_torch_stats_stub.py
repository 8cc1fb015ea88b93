"""The port's statistics and cluster stub against mdbench_tpu's, on the CPU.

Stats: the exact counters of `compute_cluster_stats` (group windows) and
`_compute_ilist_stats` (exact unit lists, flat capacity) equal
mdbench_tpu's integers on the same state, and the within-cutoff pair
counts equal a dense minimum-image count. Stub: the synthetic planes and
lists are mdbench_tpu's bit for bit, a tiny run's first force is
mdbench_tpu's `lj_cluster_force_xla` on them (float64, 1e-12 of max |f|:
only the summation order differs), and the verlet stub refuses.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdbench_tpu import stats as jstats
from mdbench_tpu import stub as jstub
from mdbench_tpu.ops.pallas.lj_cluster import lj_cluster_force_xla
from mdbench_tpu_torch import stats as tstats
from mdbench_tpu_torch import stub as tstub
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine_cluster import ClusterSimulation
from mdbench_tpu_torch.models.lattice import create_fcc_lattice

torch.set_num_threads(1)


def _state(kernel):
    """The port's initial state of a jittered 4^3 box, float64."""
    p = Params(nx=4, ny=4, nz=4, precision="dp", scheme="cluster", kernel=kernel)
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(2).normal(0.0, 0.05, x.shape)
    sim = ClusterSimulation(p, x=x, v=v, device="cpu")
    return sim, sim.initial_state()


def _as_jax(st):
    """The state's clusters and pairs as mdbench_tpu reads them: jnp
    arrays, the lists and windows with their TPU block axis."""
    cl, pr = st.clusters, st.pairs

    def j(t, block=False):
        if t is None:
            return None
        a = jnp.asarray(t.numpy())
        return a.reshape(a.shape[0], 1, -1) if block else a

    clusters = SimpleNamespace(xc=j(cl.xc), yc=j(cl.yc), zc=j(cl.zc))
    pairs = SimpleNamespace(
        jlist=j(pr.jlist.to(torch.int32), True), ranges=j(pr.ranges, True),
        nj=j(pr.nj), ijlist=j(pr.ijlist), nji=j(pr.nji), bijlist=None)
    return clusters, pairs


def _dense_counts(sim, cutsq):
    x = sim._wrap_flat(sim.x_flat0)[: sim.nlocal].numpy()
    d = x[:, None, :] - x[None, :, :]
    d -= sim.prd * np.round(d / sim.prd)
    rsq = (d * d).sum(-1)
    np.fill_diagonal(rsq, np.inf)
    return int((rsq < cutsq).sum())


@pytest.mark.parametrize("kernel", ["pallas", "auto"])
def test_cluster_stats_equal_jax_and_dense(kernel):
    sim, st = _state(kernel)
    p = sim.params
    cut = (p.cutforce**2, p.cutneigh**2)
    got = tstats.compute_cluster_stats(st.clusters, st.pairs, sim.n_clusters_pad,
                                       16, *cut)
    want = jstats.compute_cluster_stats(*_as_jax(st), sim.n_clusters_pad, 16, *cut)
    assert got == {k: int(v) for k, v in want.items()}
    assert all(type(v) is int for v in got.values())
    assert got["pairs_within_cutforce"] == _dense_counts(sim, cut[0])
    assert got["pairs_within_cutneigh"] == _dense_counts(sim, cut[1])
    assert 0 < got["clusters_within_cutoff"] <= got["clusters_processed"]
    assert got["pairs_within_cutforce"] <= got["padded_pairs"]


def test_display_statistics_equals_jax():
    args = (256, 200, 0.25, 2.4, 8)
    s_t, s_j = tstats.Stats(), jstats.Stats()
    nn = np.random.default_rng(0).integers(20, 80, 256)
    s_t.accumulate_list(nn, 201)
    s_j.accumulate_list(nn, 201)
    assert tstats.display_statistics(s_t, *args) == jstats.display_statistics(s_j, *args)


@pytest.mark.parametrize("pattern", ["seq", "fix", "rand"])
def test_stub_arrays_bit_equal(pattern):
    for n_clusters in (100, 256):
        for a, b in zip(tstub.create_stub_clusters(n_clusters, 16),
                        jstub.create_stub_clusters(n_clusters, 16)):
            np.testing.assert_array_equal(a, b)
        n_pad = tstub.create_stub_clusters(n_clusters, 16)[3]
        for a, b in zip(tstub.create_cluster_pair_list(n_pad, 16, 12, pattern),
                        jstub.create_cluster_pair_list(n_pad, 16, 12, pattern)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pattern", ["seq", "fix", "rand"])
def test_tiny_cluster_stub_matches_jax(pattern, capsys):
    out = tstub.run_cluster_stub(natoms=2048, nneighs=12, pattern=pattern,
                                 ntimes=2, precision="dp", device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("Total time: ") and "Mega atom updates/s: " in lines[0]
    assert lines[1].startswith("Cycles per atom: ")
    assert out["mega_updates"] > 0 and out["ntimes"] == 2
    xc, yc, zc, n_pad = jstub.create_stub_clusters(256, 16)
    jl, _, _ = jstub.create_cluster_pair_list(n_pad, 16, 12, pattern)
    f_j = lj_cluster_force_xla(*(jnp.asarray(a) for a in (xc, yc, zc)),
                               jnp.asarray(jl), n_pad, 16, 1.0e12, 1.0, 1.0)
    a = np.stack([t.numpy() for t in out["first_force"]])
    b = np.stack([np.asarray(t) for t in f_j])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


def test_stub_csv_row(capsys):
    tstub.run_cluster_stub(natoms=2048, nneighs=12, ntimes=1, csv=True,
                           precision="dp", device="cpu")
    head, row = capsys.readouterr().out.splitlines()
    assert head.startswith("steps,pattern,natoms")
    assert row.startswith("1,seq,2048,12,1,")


@pytest.mark.parametrize("argv", [[], ["--scheme", "verlet"]])
def test_verlet_stub_is_not_ported(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tstub.main(argv)
