"""The port's cluster engine against mdbench_tpu's, in float64 on the CPU:
step-0 forces, the 6^3 100-step trajectory (against mdbench_tpu's run and
the C reference's golden trace), the grow-and-retry path, and that the
port's CPU path never imports jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.engine_cluster import ClusterSimulation as TSim
from test_golden import GOLDEN_LJ

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def test_step0_forces_match_jax():
    # jittered: on the perfect lattice forces cancel to ~1e-14 by symmetry
    kw = dict(nx=6, ny=6, nz=6, precision="dp", scheme="cluster")
    x, v, _ = create_fcc_lattice(JParams(**kw))
    x = x + np.random.default_rng(3).normal(0.0, 0.05, x.shape)
    f_j = JSim(JParams(**kw), x=x, v=v).first_force_atoms()
    f_t = TSim(TParams(**kw), x=x, v=v, device="cpu").first_force_atoms()
    assert np.abs(f_j).max() > 1.0
    assert np.abs(f_t - f_j).max() < 1e-10


def test_trajectory_matches_jax_and_golden():
    kw = dict(nx=6, ny=6, nz=6, ntimes=100, precision="dp", scheme="cluster")
    r_j = JSim(JParams(**kw)).run()
    r_t = TSim(TParams(**kw), device="cpu").run()
    assert r_t.temps.shape == (100,) and r_t.press.shape == (100,)
    # summation order differs (~1e-16) and grows at the Lyapunov rate
    np.testing.assert_allclose(r_t.temps[:40], r_j.temps[:40], rtol=1e-6)
    np.testing.assert_allclose(r_t.press[:40], r_j.press[:40], rtol=1e-6)
    for step, (t_gold, _) in GOLDEN_LJ.items():
        if step:
            assert r_t.temps[step - 1] == pytest.approx(t_gold, rel=1e-4)


def test_sparse_thermo_and_grow_retry():
    """dense_thermo off records only rebuild steps; an exact-list
    capacity far below need overflows, grows and retries to the same
    trajectory."""
    kw = dict(nx=4, ny=4, nz=4, ntimes=12, reneigh_every=5, precision="dp",
              scheme="cluster", dense_thermo=False)
    ref = TSim(TParams(**kw), device="cpu").run()
    sim = TSim(TParams(**kw), device="cpu")
    sim.icap = 8
    out = sim.run()
    assert sim.icap > 8
    np.testing.assert_array_equal(np.nonzero(out.temps)[0], [4, 9])
    np.testing.assert_allclose(out.temps, ref.temps, rtol=1e-12)


def test_full_recluster_cadence_matches_jax():
    """resort_every on a rebuild step takes the full re-cluster path."""
    kw = dict(nx=4, ny=4, nz=4, ntimes=15, reneigh_every=5, resort_every=10,
              precision="dp", scheme="cluster")
    r_j = JSim(JParams(**kw)).run()
    r_t = TSim(TParams(**kw), device="cpu").run()
    np.testing.assert_allclose(r_t.temps, r_j.temps, rtol=1e-9)


def test_cpu_path_imports_no_jax():
    code = (
        "import sys\n"
        "from mdbench_tpu_torch.config import Params\n"
        "from mdbench_tpu_torch.engine_cluster import ClusterSimulation\n"
        "from mdbench_tpu_torch import convert, bench, stats, stub\n"
        "p = Params(nx=4, ny=4, nz=4, ntimes=4, reneigh_every=2, scheme='cluster')\n"
        "out = ClusterSimulation(p, device='cpu').run()\n"
        "bench.load_check_golden()\n"
        "assert out.temps.shape == (4,)\n"
        "p = Params(nx=4, ny=4, nz=4, ntimes=4, reneigh_every=4, prune_every=1,\n"
        "           scheme='cluster', kernel='pallas')\n"
        "sim = ClusterSimulation(p, device='cpu')\n"
        "out = sim.run()\n"
        "cs = stats.compute_cluster_stats(out.state.clusters, out.state.pairs,\n"
        "                                 sim.n_clusters_pad, 16, 6.25, 7.84)\n"
        "assert out.temps.shape == (4,) and cs['pairs_within_cutforce'] > 0\n"
        "stub.run_cluster_stub(natoms=2048, nneighs=12, ntimes=1, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mdbench_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
