"""The port's verlet stub (stub.run_stub) against mdbench_tpu's, on the CPU:
the synthetic atoms and lists bit for bit, a tiny run's first force
against mdbench_tpu's force on the same arrays (LJ full and half lists,
EAM spline and poly; float64, 1e-12 of max |f|: only the summation order
differs), the CSV row and the command line."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu import stub as jstub
from mdbench_tpu.models import eam_tables as jtab
from mdbench_tpu.ops import eam as jeam
from mdbench_tpu.ops.lj import compute_force_lj_full, compute_force_lj_half
from mdbench_tpu_torch import stub as tstub

torch.set_num_threads(1)
N, NN = 512, 20


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


@pytest.mark.parametrize("pattern", ["seq", "fix", "rand"])
def test_stub_arrays_bit_equal(pattern):
    for a, b in zip(tstub.create_stub_atoms(300), jstub.create_stub_atoms(300)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tstub.create_neighbors(300, pattern, 12, 2),
                    jstub.create_neighbors(300, pattern, 12, 2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_force(kind, eam_file):
    """mdbench_tpu's first force of the stub's arrays (float64)."""
    xh, _ = jstub.create_stub_atoms(N)
    nb, nn = jstub.create_neighbors(N, "seq", NN, 1)
    x = jnp.asarray(np.concatenate([xh, [[1e30, 1e30, 1e30]]]))
    nb, nn = jnp.asarray(nb), jnp.asarray(nn)
    if kind == "full":
        return compute_force_lj_full(x, nb, nn, N, 1e12, 1.0, 1.0)
    if kind == "half":
        return compute_force_lj_half(x, nb, nn, N, N, 1e12, 1.0, 1.0)
    t = jtab.load_eam(eam_file)
    args = (x, nb, nn, jnp.zeros((0,), jnp.int32), N, N, float(t.cut) ** 2,
            jeam.EamDevice.from_tables(t, jnp.float64))
    if kind == "poly":
        return jeam.compute_force_eam_poly(*args, jtab.fit_eam_poly(t))[0]
    return jeam.compute_force_eam(*args)[0]


@pytest.mark.parametrize("kind", ["full", "half", "spline", "poly"])
def test_first_force_matches_jax(kind, eam_file, capsys):
    kw = dict(half=kind == "half")
    if kind in ("spline", "poly"):
        kw = dict(force_field="eam", eam_file=eam_file, eam_eval=kind)
    out = tstub.run_stub(natoms=N, nneighs=NN, ntimes=2, precision="dp", device="cpu",
                         **kw)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("Total time: ") and lines[1].startswith("Cycles per atom")
    assert out["mega_updates"] > 0 and out["cycles_per_neighbor"] > 0
    got = out["first_force"].numpy()
    want = np.asarray(_jax_force(kind, eam_file))
    assert got.shape == (N, 3) and np.isfinite(want).all()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_stub_csv_row(capsys):
    tstub.run_stub(natoms=N, nneighs=NN, nreps=2, ntimes=1, csv=True, precision="dp",
                   device="cpu")
    head, row = capsys.readouterr().out.splitlines()
    assert head == ("steps,pattern,natoms,nneighs,nreps,time(s),atom upds/s(M),"
                    "cy/atom,cy/neigh")
    assert row.startswith(f"1,seq,{N},{NN},2,") and len(row.split(",")) == 9


def test_eam_stub_needs_a_potential():
    with pytest.raises(ValueError, match="-e"):
        tstub.run_stub(natoms=N, nneighs=NN, ntimes=1, force_field="eam", device="cpu")


@pytest.mark.parametrize("argv", [
    ["--scheme", "verlet", "-half", "1"],
    ["--scheme", "verlet", "--pattern", "rand", "-nr", "2"],
    ["--scheme", "cluster"],
])
def test_main_runs_both_schemes(argv, capsys):
    assert tstub.main(argv + ["-na", "2048", "-nn", "12", "-n", "1", "--csv",
                              "--device", "cpu"]) == 0
    head, row = capsys.readouterr().out.splitlines()
    assert head.startswith("steps,pattern") and row.startswith("1,")
