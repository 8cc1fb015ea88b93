"""The port's O(N^2) oracle (ops/dense.py) against mdbench_tpu's on a
jittered 4^3 box in float64 (1e-12 of the largest value: only the
summation order can differ), untyped and typed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdbench_tpu.config import Params
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops import dense as jdense
from mdbench_tpu.state import TypeTables as JTables
from mdbench_tpu_torch.ops import dense as tdense
from mdbench_tpu_torch.state import TypeTables as TTables


def _box():
    p = Params(nx=4, ny=4, nz=4)
    x, _, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    return x, (p.xprd, p.yprd, p.zprd)


def _close(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_dense_lj_matches_jax():
    x, prd = _box()
    want = jdense.lj_force_dense(jnp.asarray(x), prd, 2.5, 1.0, 1.0)
    got = tdense.lj_force_dense(torch.tensor(x), prd, 2.5, 1.0, 1.0)
    for a, b in zip(got, want):
        _close(a.numpy(), b)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_typed_matches_jax(seed):
    x, prd = _box()
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, x.shape[0]).astype(np.int32)
    tabs = [rng.uniform(lo, hi, (3, 3)) for lo, hi in ((0.7, 1.3), (0.8, 1.2),
                                                        (4.0, 6.25), (5.0, 7.0))]
    tabs = [(t + t.T) / 2 for t in tabs]
    jt = JTables(jnp.asarray(types), *(jnp.asarray(t) for t in tabs))
    tt = TTables(torch.tensor(types), *(torch.tensor(t) for t in tabs))
    want = jdense.lj_force_dense_typed(jnp.asarray(x), jnp.asarray(types), prd, jt)
    got = tdense.lj_force_dense_typed(torch.tensor(x), torch.tensor(types), prd, tt)
    _close(got.numpy(), want)
