"""The port's host foundations against mdbench_tpu: Params and the banner,
the param-file parser, the FCC lattice and its Park-Miller velocities
(bit-equal), the thermo set-up, and the settings the port refuses."""

import dataclasses

import numpy as np
import pytest
import torch

from mdbench_tpu import config as jconfig
from mdbench_tpu import thermo as jthermo
from mdbench_tpu.models import lattice as jlattice
from mdbench_tpu.utils import prng as jprng
from mdbench_tpu_torch import config as tconfig
from mdbench_tpu_torch import thermo as tthermo
from mdbench_tpu_torch.engine_cluster import ClusterSimulation, check_slice
from mdbench_tpu_torch.models import lattice as tlattice
from mdbench_tpu_torch.utils import prng as tprng

torch.set_num_threads(1)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("kw", [
    {},
    {"precision": "sp", "scheme": "cluster", "dense_thermo": False},
    {"nx": 6, "ny": 7, "nz": 8, "rho": 0.9, "cutforce": 2.2, "skin": 0.4},
])
def test_params_and_banner_match(kw):
    assert _fields(tconfig.Params) == _fields(jconfig.Params)
    pj, pt = jconfig.Params(**kw), tconfig.Params(**kw)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    assert tconfig.print_parameters(pt) == jconfig.print_parameters(pj)
    assert pt.dtype == (torch.float64 if pt.precision == "dp" else torch.float32)


def test_parameter_file_parses_the_same(tmp_path):
    f = tmp_path / "run.conf"
    f.write_text(
        "# comment\nnx 5 # x cells\nny 6\nnz 7\nntimes 40\ndt 0.004\n"
        "force_field lj\nscheme cluster\nprecision sp\nskin 0.25\n"
        "unknown_key 3\n"
    )
    pj = jconfig.read_parameter_file(jconfig.Params(), str(f))
    pt = tconfig.read_parameter_file(tconfig.Params(), str(f))
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)


@pytest.mark.parametrize("n", [6, 32])
def test_lattice_and_velocities_bit_equal(n):
    pj = jconfig.Params(nx=n, ny=n, nz=n)
    pt = tconfig.Params(nx=n, ny=n, nz=n)
    xj, vj, tj = jlattice.create_fcc_lattice(pj)
    xt, vt, tt = tlattice.create_fcc_lattice(pt)
    assert xt.shape == (4 * n**3, 3)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)


def test_prng_streams_bit_equal():
    seeds = np.arange(1, 2000, 7, dtype=np.int64)
    np.testing.assert_array_equal(
        tprng.park_miller_nth(seeds, 18), jprng.park_miller_nth(seeds, 18)
    )
    for coord in ([0.0, 0.0, 0.0], [1.5, -2.25, 3.125]):
        assert tprng.random_reset_seed(3, coord) == jprng.random_reset_seed(3, coord)


@pytest.mark.parametrize("ff", [jconfig.FF_LJ, jconfig.FF_EAM])
def test_thermo_setup_matches(ff):
    pj = jconfig.Params(nx=6, ny=6, nz=6, force_field=ff)
    pt = tconfig.Params(nx=6, ny=6, nz=6, force_field=ff)
    n = pj.natoms_expected
    sj, st = jthermo.setup_thermo(pj, n), tthermo.setup_thermo(pt, n)
    assert tuple(st) == tuple(sj)
    assert tthermo.adjusted_dtforce(pt, st) == jthermo.adjusted_dtforce(pj, sj)
    _, v, _ = jlattice.create_fcc_lattice(pj)
    np.testing.assert_array_equal(
        tthermo.adjust_thermo(pt, st, v, n), jthermo.adjust_thermo(pj, sj, v, n)
    )


@pytest.mark.parametrize("kw", [
    {"scheme": "verlet"},
    {"force_field": tconfig.FF_DEM},
    {"input_file": "atoms.dmp"},
    {"ntypes": 2},
    {"ntypes": 2, "kernel": "pallas"},
    {"derive_bf16": True},
    {"ntypes": 2, "half_neigh": 1},
])
def test_unported_settings_raise(kw):
    p = tconfig.Params(**{"scheme": "cluster", "nx": 4, "ny": 4, "nz": 4, **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_slice(p)
    with pytest.raises(NotImplementedError):
        ClusterSimulation(p, device="cpu")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = tconfig.Params(scheme="cluster", nx=4, ny=4, nz=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterSimulation(p)  # the default device is "cuda"
