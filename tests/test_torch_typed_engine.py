"""The port's typed (EXPLICIT_TYPES) cluster LJ engine against mdbench_tpu's,
on the CPU: every kernel name with `types=`/`tables=`, a run through
`Params(input_file=<a two-type dump>)`, uniform tables against the
untyped run, `ntypes=2` on the lattice (all-zero types, as in
mdbench_tpu), and chip_smoke's typed dump read back and run without jax.
The case and the tables are tests/test_torch_typed.py's.
Tolerances are relative: 1e-10 of max |f| for step-0 forces, 1e-9 for a
16-step trajectory (rounding differences grow along it), 1e-12 between
two runs of the port that do the same per-pair arithmetic."""

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
from mdbench_tpu_torch.io.readers import read_atom
from mdbench_tpu_torch.thermo import adjust_thermo, setup_thermo
from test_torch_typed import CUT2, ENGINES, JAX_OF, KW, _case, _jax, _port

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(ENGINES))
def test_typed_engine_matches_jax(name):
    """Step-0 forces and the 16-step trajectory (both rebuild kinds) of
    the port's typed engine on the CPU against mdbench_tpu's."""
    sj, _, r_j = _jax(JAX_OF[name])
    st = _port(name)
    assert st.ntypes == sj.ntypes == 2
    f_j = sj.first_force_atoms()
    assert np.abs(st.first_force_atoms() - f_j).max() <= 1e-10 * np.abs(f_j).max()
    r_t = st.run()
    assert st.grows == []
    np.testing.assert_allclose(r_t.temps, r_j.temps, rtol=1e-9)
    np.testing.assert_allclose(r_t.press, r_j.press, rtol=1e-9)


def _write_dmp(path, x, v, types, box):
    lines = ["ITEM: TIMESTEP", "0", "ITEM: NUMBER OF ATOMS", str(len(x)),
             "ITEM: BOX BOUNDS pp pp pp", *(f"0.0 {b!r}" for b in box),
             "ITEM: ATOMS id type x y z vx vy vz"]
    lines += [f"{i + 1} {types[i] + 1} " + " ".join(repr(float(a)) for a in (*x[i], *v[i]))
              for i in range(len(x))]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("name", ["auto", "pallas"])
def test_input_file_run_matches_jax(tmp_path, name):
    """Params(input_file=<a two-type dump>) in both packages: the file's
    box and types, velocities not rescaled, the default EXPLICIT_TYPES
    tables (uniform), forces and trajectory."""
    x, v, types = _case()
    p0 = JParams(**KW)
    box = (p0.xprd, p0.yprd, p0.zprd)
    path = tmp_path / "two_types.dmp"
    _write_dmp(path, x, v, types, box)
    kw = dict(KW, input_file=str(path), xprd=1.0, yprd=1.0, zprd=1.0)
    jkw = {"kernel": "xla"} if name == "pallas" else ENGINES[name]
    sj = JSim(JParams(**kw, **jkw))
    st = TSim(TParams(**kw, **ENGINES[name]), device="cpu")
    assert (st.params.xprd, st.params.yprd, st.params.zprd) == box
    assert st.params.ntypes == st.ntypes == 2
    np.testing.assert_array_equal(st.types_flat0.numpy(), types)
    for a, b in zip(st.type_tables, sj.type_tables):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(st.v_flat0[:-1].numpy(), v)  # not rescaled
    f_j = sj.first_force_atoms()
    assert np.abs(st.first_force_atoms() - f_j).max() <= 1e-10 * np.abs(f_j).max()
    np.testing.assert_allclose(st.run().temps, sj.run().temps, rtol=1e-9)


@pytest.mark.parametrize("name", ["auto", "pallas", "half"])
def test_uniform_tables_give_the_untyped_run(name):
    """Typed with uniform tables (the EXPLICIT_TYPES defaults) against the
    untyped run on the same atoms: the same per-pair arithmetic."""
    x, v, types = _case()
    kw = dict(KW, **ENGINES[name])
    r_u = TSim(TParams(**kw), x=x, v=v, device="cpu").run()
    typed = TSim(TParams(**kw, ntypes=2), x=x, v=v, types=types, device="cpu")
    assert typed.tables is not None
    for t, val in zip(typed.type_tables, (1.0, 1.0, CUT2)):
        np.testing.assert_array_equal(t, np.full((2, 2), val))
    np.testing.assert_allclose(typed.run().temps, r_u.temps, rtol=1e-12, atol=0)


def test_ntypes2_on_the_lattice_runs_zero_types():
    """mdbench_tpu drops the lattice's glibc-rand types: with ntypes=2 its
    tables run over all-zero types, and so do the port's."""
    kw = dict(KW, ntypes=2)
    sj = JSim(JParams(**kw))
    st = TSim(TParams(**kw), device="cpu")
    assert st.ntypes == sj.ntypes == 2
    assert (st.types_flat0 == 0).all()
    np.testing.assert_array_equal(st.types_flat0.numpy(), np.asarray(sj.types_flat0))
    assert create_fcc_lattice(JParams(**kw))[2].any()  # the lattice has type 1
    r_t = st.run()
    np.testing.assert_allclose(r_t.temps, sj.run().temps, rtol=1e-9)
    r_u = TSim(TParams(**KW), device="cpu").run()
    np.testing.assert_allclose(r_t.temps, r_u.temps, rtol=1e-12, atol=0)


def test_typed_dump_reads_back_bit_equal_without_jax(tmp_path):
    """chip_smoke's typed dump (here at 4^3 cells) reads back bit-equal to
    the lattice, its adjusted velocities and its glibc-rand types, and a
    typed run from it on both LJ paths imports nothing of jax."""
    path = tmp_path / "two_types.dmp"
    code = (
        "import sys\n"
        "from chip_smoke import write_typed_dump\n"
        "from mdbench_tpu_torch.config import Params\n"
        "from mdbench_tpu_torch.engine_cluster import ClusterSimulation\n"
        f"assert write_typed_dump({str(path)!r}, nx=4) == 256\n"
        "for k in ('auto', 'pallas'):\n"
        f"    p = Params(input_file={str(path)!r}, ntimes=4, reneigh_every=2,\n"
        "               scheme='cluster', kernel=k)\n"
        "    sim = ClusterSimulation(p, device='cpu')\n"
        "    assert sim.ntypes == 2 and sim.run().temps.shape == (4,)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mdbench_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    repo = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    p = TParams(nx=4, ny=4, nz=4, ntypes=2)
    x, v, types = create_fcc_lattice(JParams(nx=4, ny=4, nz=4, ntypes=2))
    v = adjust_thermo(p, setup_thermo(p, x.shape[0]), v, x.shape[0])
    r = read_atom(TParams(input_file=str(path)))
    np.testing.assert_array_equal(r.x, x)
    np.testing.assert_array_equal(r.v, v)
    np.testing.assert_array_equal(r.types, types)
    assert types.any() and r.box == (p.xprd, p.yprd, p.zprd)
