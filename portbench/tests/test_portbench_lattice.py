"""The frozen seeded generator against the program's lattice and thermo."""

import numpy as np
import pytest

from portbench.reference.lattice import box_lengths, fcc_atoms

CFG = dict(nx=6, ny=5, nz=4, rho=0.8442, temp=1.44, mass=1.0)


def test_seed0_is_the_references_bit_for_bit():
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.models.lattice import create_fcc_lattice
    from mdbench_tpu_torch.thermo import adjust_thermo, setup_thermo

    p = Params(nx=6, ny=5, nz=4)
    x, v, _ = create_fcc_lattice(p)
    v = adjust_thermo(p, setup_thermo(p, x.shape[0]), v, x.shape[0])
    x0, v0 = fcc_atoms(CFG, 0)
    assert np.array_equal(x, x0)
    assert np.array_equal(v, v0)
    assert np.allclose(box_lengths(CFG), [p.xprd, p.yprd, p.zprd], rtol=0, atol=0)


@pytest.mark.parametrize("seed", [1, 7, 2**31 + 11, 3 * 2**33])
def test_other_seeds_shift_the_velocity_streams(seed):
    x0, v0 = fcc_atoms(CFG, 0)
    x, v = fcc_atoms(CFG, seed)
    assert np.array_equal(x, x0)  # the same lattice in the same order
    assert not np.allclose(v, v0)
    assert np.allclose(v.sum(0), 0, atol=1e-12)
    n = v.shape[0]
    assert (v * v).sum() * CFG["mass"] / (3 * n - 3) == pytest.approx(CFG["temp"], rel=1e-12)
    x2, v2 = fcc_atoms(CFG, seed)
    assert np.array_equal(v, v2)
    assert not np.allclose(v, fcc_atoms(CFG, seed + 1)[1])
