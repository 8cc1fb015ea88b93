"""The port's pencil and brick engines against mdbench_tpu's
(parallel/verlet_domain2d.Domain2DSimulation and
parallel/verlet_domain3d.Domain3DSimulation under shard_map on the
8-device virtual CPU mesh of tests/conftest.py), the planar path in
float64, 10 steps with a rebuild every 5: pencils (2, 2) on an 8x8x4 box,
bricks (2, 2, 2) on a 4^3 box and (2, 2, 1) on the 8x8x4 box, and EAM on
(2, 2) pencils on the stand-in potential. The temperature of every step
agrees to rel 1e-9 and each domain (row-major over the mesh in both
packages) ends with the same number of atoms. A file of its own:
mdbench_tpu's shard_map compiles set its pace."""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.parallel.verlet_domain2d import Domain2DSimulation as J2D
from mdbench_tpu.parallel.verlet_domain3d import Domain3DSimulation as J3D
from mdbench_tpu_torch.config import FF_EAM
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation as T2D
from mdbench_tpu_torch.parallel.verlet_domain3d import Domain3DSimulation as T3D

torch.set_num_threads(1)

BOX_8x8x4 = dict(nx=8, ny=8, nz=4)
BOX_4x4x4 = dict(nx=4, ny=4, nz=4)


def _compare(jeng, teng, dims, kw):
    if len(jax.devices()) < np.prod(dims):
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    kw = dict(kw, ntimes=10, reneigh_every=5)
    out_j = jeng(JParams(**kw, kernel="auto"), *dims).run()  # its CPU path: planar
    dom = teng(TParams(**kw, kernel="xla"), *dims, device="cpu")
    out_t = dom.run(repeats=0)
    np.testing.assert_allclose(out_t.temps, np.asarray(out_j.temps), rtol=1e-9)
    nt = [int(n) for n in out_t.state.nlocal]
    np.testing.assert_array_equal(nt, np.asarray(out_j.nlocal).reshape(-1))
    assert sum(nt) == dom.natoms


@pytest.mark.parametrize("jeng,teng,dims,box", [
    (J2D, T2D, (2, 2), BOX_8x8x4),
    (J3D, T3D, (2, 2, 2), BOX_4x4x4),
    (J3D, T3D, (2, 2, 1), BOX_8x8x4),
], ids=["pencils-2x2", "bricks-2x2x2", "bricks-2x2x1"])
def test_planar_mesh_matches_jax(jeng, teng, dims, box):
    _compare(jeng, teng, dims, box)


def test_eam_pencils_match_jax(tmp_path):
    path = tmp_path / "standin.eam"
    write_standin_funcfl(path)
    _compare(J2D, T2D, (2, 2), dict(BOX_4x4x4, force_field=FF_EAM, eam_file=str(path),
                                     eam_eval="spline"))
