"""The exchange layer (parallel/exchange.py): InProcessMesh's shift and
psum against lax.ppermute / lax.psum under shard_map on the virtual CPU
mesh of tests/conftest.py, for 1, 2, 4 and 8 domains (one domain sends
to itself), and on the meshes with axes (2, 2), (4, 2), (2, 2, 2),
(2, 2, 1) and (1, 1, 2) along every axis; and DistExchange over a gloo
group (tests/domain_dist_worker.py): its shift, psum and all_gather on
rank-tagged buffers, and with two ranks the DP slab engines (8x4x4, 10
steps: the verlet engine's planar path, the cluster engine's exact-list
path), with four the pencil engine on (2, 2) and the brick engine on
(2, 1, 2), which must equal the in-process mesh bit for bit. The workers
have a hard time limit: on expiry they are killed and the test fails."""

import os
import socket
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.parallel.exchange import InProcessMesh
from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
JOIN_TIMEOUT_S = 120


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_shift_and_psum_match_ppermute(ndev):
    if len(jax.devices()) < ndev:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    bufs = np.random.default_rng(ndev).normal(size=(ndev, 5, 3))
    mesh = Mesh(np.array(jax.devices()[:ndev]), ("x",))

    def body(b, step):
        perm = [(i, (i + step) % ndev) for i in range(ndev)]
        return (jax.lax.ppermute(b, "x", perm),
                jax.lax.psum(jnp.sum(b), "x").reshape(1))

    ex = InProcessMesh(ndev, "cpu")
    tb = [torch.tensor(b) for b in bufs]
    for step in (1, -1):
        got_j, sum_j = jax.jit(jax.shard_map(
            partial(body, step=step), mesh=mesh, in_specs=P("x"),
            out_specs=(P("x"), P("x")), check_vma=False))(jnp.asarray(bufs))
        got_t = ex.shift(tb, step)
        np.testing.assert_array_equal(np.stack([t.numpy() for t in got_t]),
                                      np.asarray(got_j))
        sums = ex.psum([t.sum() for t in tb])
        assert len(sums) == ndev
        np.testing.assert_allclose([float(s) for s in sums], np.asarray(sum_j),
                                   rtol=1e-14)
    assert [t is b for t, b in zip(ex.all_gather(tb), tb)] == [True] * ndev


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 2, 2), (2, 2, 1), (1, 1, 2)])
def test_mesh_shift_and_psum_match_ppermute(shape):
    """A mesh with axes: shift along every axis, both ways, and psum over
    all domains, against ppermute over that mesh axis and psum over all of
    them (domains row-major, as mdbench_tpu's mesh reshape lays them out);
    an axis of size 1 sends to itself."""
    ndev = int(np.prod(shape))
    if len(jax.devices()) < ndev:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    names = ("dx", "dy", "dz")[: len(shape)]
    bufs = np.random.default_rng(ndev + len(shape)).normal(size=(ndev, 5, 3))
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(shape), names)
    spec = P(*names)

    def body(b, axis, step):
        n = shape[axis]
        perm = [(i, (i + step) % n) for i in range(n)]
        b = b.reshape(b.shape[len(shape):])
        got = jax.lax.ppermute(b, names[axis], perm)
        total = jax.lax.psum(jnp.sum(b), names)
        return (got.reshape((1,) * len(shape) + got.shape),
                total.reshape((1,) * len(shape)))

    ex = InProcessMesh(shape, "cpu")
    assert ex.shape == shape and ex.ndev == ndev
    tb = [torch.tensor(b) for b in bufs]
    for axis in range(len(shape)):
        for step in (1, -1):
            got_j, sum_j = jax.jit(jax.shard_map(
                partial(body, axis=axis, step=step), mesh=mesh, in_specs=spec,
                out_specs=(spec, spec), check_vma=False))(
                    jnp.asarray(bufs.reshape(shape + bufs.shape[1:])))
            got_t = ex.shift(tb, step, axis)
            np.testing.assert_array_equal(np.stack([t.numpy() for t in got_t]),
                                          np.asarray(got_j).reshape(bufs.shape))
            sums = ex.psum([t.sum() for t in tb])
            np.testing.assert_allclose([float(v) for v in sums],
                                       np.asarray(sum_j).reshape(-1), rtol=1e-14)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_run(tmp_path, scheme: str, world: int = 2, shape=None) -> list:
    """`world` gloo workers of `scheme` (a mesh of `shape`, None: 1-D);
    returns each rank's saved arrays."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "domain_dist_worker.py"), str(r), str(world),
         str(port), str(outs[r]), scheme], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the gloo workers did not finish within {JOIN_TIMEOUT_S} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    got = [dict(np.load(o)) for o in outs]
    for r, g in enumerate(got):
        if shape is None:
            np.testing.assert_array_equal(g["shift+1"], np.full((3, 2), (r - 1) % world))
            np.testing.assert_array_equal(g["shift-1"], np.full((3, 2), (r + 1) % world))
    shape = (world,) if shape is None else shape
    for r, g in enumerate(got):
        for axis in range(len(shape)):
            for step in (1, -1):
                c = list(np.unravel_index(r, shape))
                c[axis] = (c[axis] - step) % shape[axis]  # the sender
                np.testing.assert_array_equal(
                    g[f"shift{step:+d}@{axis}"],
                    np.full((3, 2), np.ravel_multi_index(c, shape)))
        assert float(g["psum"]) == sum(range(1, world + 1))
        np.testing.assert_array_equal(g["gather"], [[q, 2 * q] for q in range(world)])
    return got


def test_gloo_run_equals_in_process_mesh(tmp_path):
    from domain_dist_worker import DOMAIN_KW

    got = _gloo_run(tmp_path, "verlet")
    world = len(got)
    dom = DomainSimulation(Params(**DOMAIN_KW), ndev=world, device="cpu")
    want = dom.run(repeats=0)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["temps"], want.temps)
        assert int(g["nlocal"]) == int(want.state.nlocal[r])
        for key in ("x", "v", "f"):
            np.testing.assert_array_equal(g[key], getattr(want.state, key)[r].numpy())
    assert sum(int(g["nlocal"]) for g in got) == dom.natoms


def test_gloo_cluster_run_equals_in_process_mesh(tmp_path):
    from domain_dist_worker import CLUSTER_KW, final_state

    from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation

    got = _gloo_run(tmp_path, "cluster")
    world = len(got)
    dom = ClusterDomainSimulation(Params(**CLUSTER_KW), ndev=world, device="cpu")
    want = dom.run(repeats=0)
    assert dom._calibrated
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["temps"], want.temps)
        for key, val in final_state("cluster", want, r).items():
            np.testing.assert_array_equal(g[key], val)
    assert sum(int(g["nlocal"]) for g in got) == dom.natoms


@pytest.mark.parametrize("scheme", ["pencil", "brick"])
def test_gloo_mesh_run_equals_in_process_mesh(tmp_path, scheme):
    """Four gloo ranks, one domain each: the pencil engine on (2, 2) and the
    brick engine on (2, 1, 2), whose size-1 y axis DistExchange serves by
    a self-send; bit for bit the in-process mesh's run."""
    from domain_dist_worker import MESH_RUNS, final_state

    engine, shape, kw = MESH_RUNS[scheme]
    got = _gloo_run(tmp_path, scheme, world=4, shape=shape)
    dom = engine(Params(**kw), *shape, device="cpu")
    want = dom.run(repeats=0)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["temps"], want.temps)
        for key, val in final_state(scheme, want, r).items():
            np.testing.assert_array_equal(g[key], val)
    assert sum(int(g["nlocal"]) for g in got) == dom.natoms
