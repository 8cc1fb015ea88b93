"""The port's cluster slab engine against mdbench_tpu's
(parallel/cluster_domain ClusterDomainSimulation under shard_map on the
8-device virtual CPU mesh of tests/conftest.py): 2 slabs of an 8x4x4
box, 10 steps with a rebuild every 5, in float64, on the group-window and
the exact-list plain paths. The temperature of every step agrees to rel
1e-9 and each domain ends with the same number of atoms. A file of its
own: mdbench_tpu's shard_map compile sets its pace."""

import jax
import numpy as np
import pytest
import torch

from mdbench_tpu.config import Params as JParams
from mdbench_tpu.parallel.cluster_domain import ClusterDomainSimulation as JDomain
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation as TDomain

torch.set_num_threads(1)


@pytest.mark.parametrize("kernel", ["xla", "ilist"])
def test_cluster_domain_matches_jax(kernel):
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    kw = dict(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5, kernel=kernel)
    out_j = JDomain(JParams(**kw), ndev=2).run()
    dom = TDomain(TParams(scheme="cluster", **kw), ndev=2, device="cpu")
    out_t = dom.run(repeats=0)
    np.testing.assert_allclose(out_t.temps, np.asarray(out_j.temps), rtol=1e-9)
    np.testing.assert_array_equal(out_t.nlocal, np.asarray(out_j.nlocal))
    assert int(out_t.nlocal.sum()) == dom.natoms
