"""The port's atom-file readers (mdbench_tpu_torch/io/readers.py) against
mdbench_tpu's, on small files written here: a two-type LAMMPS dump
(1-based types in the file), a GROMACS .gro, a PDB and the native .in
format in both its CSV and its space-separated form. Arrays must be
bit-equal (mdbench_tpu may parse the dump with its g++-built strtod
loader, the port with Python's float(); both round correctly), and the
box, the type count, the Params override and the errors the same."""

import dataclasses
import re

import numpy as np
import pytest

from mdbench_tpu.config import Params as JParams
from mdbench_tpu.io import readers as jreaders
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.io import readers as treaders

N = 40


def _atoms(seed=0):
    """Positions, velocities and 0-based types (two types) of N atoms in
    a (7.5, 8.25, 9.125) box, with full float64 digits."""
    rng = np.random.default_rng(seed)
    x = rng.random((N, 3)) * np.array([7.5, 8.25, 9.125])
    v = rng.normal(0.0, 1.3, (N, 3))
    return x, v, rng.integers(0, 2, N).astype(np.int32)


def _write_dmp(path, x, v, t):
    """A LAMMPS dump with the atoms in shuffled id order."""
    lines = ["ITEM: TIMESTEP", "0", "ITEM: NUMBER OF ATOMS", str(N),
             "ITEM: BOX BOUNDS pp pp pp", "0.0 7.5", "-1.25 7.0",
             "0.5 9.625", "ITEM: ATOMS id type x y z vx vy vz"]
    for i in np.random.default_rng(1).permutation(N):
        vals = " ".join(repr(float(a)) for a in (*x[i], *v[i]))
        lines.append(f"{i + 1} {t[i] + 1} {vals}")
    path.write_text("\n".join(lines) + "\n")


def _write_gro(path, x, v, _t):
    lines = ["argon test box", f" {N}"]
    for i in range(N):
        xs = " ".join(f"{a:.6f}" for a in x[i])
        vs = " ".join(f"{a:.6f}" for a in v[i])
        lines.append(f"    1ARGON   Ar {i + 1} {xs} {vs}")
    lines.append("   7.50000   8.25000   9.12500")
    path.write_text("\n".join(lines) + "\n")


def _write_pdb(path, x, _v, _t):
    lines = ["HEADER    test", "REMARK    written for the reader tests",
             "CRYST1    7.500    8.250    9.125  90.00  90.00  90.00 P 1",
             "MODEL        1"]
    for i in range(N):
        xs = " ".join(f"{a:.3f}" for a in x[i])
        lines.append(f"ATOM {i + 1} Ar AR {i + 1} {xs} 1.00 0.00")
    lines += ["TER", "ENDMDL"]
    path.write_text("\n".join(lines) + "\n")


def _write_in_csv(path, x, v, t):
    lines = [f"{N} 0.0 7.5 0.0 8.25 0.0 9.125"]
    for i in range(N):
        vals = ",".join(repr(float(a)) for a in (*x[i], *v[i]))
        lines.append(f"{t[i]},39.948,{vals},0")
    path.write_text("\n".join(lines) + "\n")


def _write_in_space(path, x, v, _t):
    lines = [f"{N} 0.0 7.5 0.0 8.25 0.0 9.125"]
    for i in range(N):
        vals = " ".join(repr(float(a)) for a in (*x[i], *v[i]))
        lines.append(f"39.948 {vals}")
    path.write_text("\n".join(lines) + "\n")


FILES = {
    "dmp": ("atoms.dmp", _write_dmp),
    "gro": ("argon.gro", _write_gro),
    "pdb": ("argon.pdb", _write_pdb),
    "in_csv": ("restart.in", _write_in_csv),
    "in_space": ("restart.in", _write_in_space),
}


@pytest.mark.parametrize("kind", list(FILES))
def test_reader_matches_jax(tmp_path, kind, capsys):
    name, write = FILES[kind]
    x, v, t = _atoms()
    path = tmp_path / name
    write(path, x, v, t)
    pj = JParams(ntypes=1, xprd=1.0, yprd=1.0, zprd=1.0, input_file=str(path))
    pt = TParams(ntypes=1, xprd=1.0, yprd=1.0, zprd=1.0, input_file=str(path))
    rj, rt = jreaders.read_atom(pj), treaders.read_atom(pt)
    for a, b in zip(rt[:3], rj[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (rt.box, rt.ntypes) == (rj.box, rj.ntypes)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    if kind == "dmp":  # the file's 1-based types come out 0-based
        np.testing.assert_array_equal(rt.x, x)
        np.testing.assert_array_equal(rt.v, v)
        np.testing.assert_array_equal(rt.types, t)
        assert rt.ntypes == 2 and pt.ntypes == 2
        assert pt.yprd == 8.25 and pt.zprd == 9.125
    if kind in ("in_csv", "in_space"):
        np.testing.assert_array_equal(rt.x, x)
        assert rt.ntypes == (2 if kind == "in_csv" else 1)
    assert "Read 40 atoms" in capsys.readouterr().out


def test_read_atom_keeps_the_larger_ntypes(tmp_path):
    x, v, t = _atoms()
    path = tmp_path / "atoms.dmp"
    _write_dmp(path, x, v, t)
    pj, pt = (P(ntypes=3, input_file=str(path)) for P in (JParams, TParams))
    jreaders.read_atom(pj)
    treaders.read_atom(pt)
    assert pt.ntypes == pj.ntypes == 3


def _bad_ext(tmp_path):
    path = tmp_path / "atoms.xyz"
    path.write_text("1\n")
    return str(path)


def _bad_gro_type(tmp_path):
    path = tmp_path / "xenon.gro"
    path.write_text("xenon\n 1\n    1XENON   Xe 1 0.1 0.2 0.3 0.0 0.0 0.0\n")
    return str(path)


def _bad_pdb_item(tmp_path):
    path = tmp_path / "odd.pdb"
    path.write_text("CRYST1 5.0 5.0 5.0\nHETATM 1 Ar AR 1 0.1 0.2 0.3\n")
    return str(path)


def _empty_pdb(tmp_path):
    path = tmp_path / "empty.pdb"
    path.write_text("HEADER empty\nCRYST1 5.0 5.0 5.0\n")
    return str(path)


def _empty_dmp(tmp_path):
    path = tmp_path / "empty.dmp"
    path.write_text("ITEM: TIMESTEP\n0\nITEM: NUMBER OF ATOMS\n0\n")
    return str(path)


@pytest.mark.parametrize("make", [_bad_ext, _bad_gro_type, _bad_pdb_item,
                                  _empty_pdb])
def test_reader_errors_match_jax(tmp_path, make):
    path = make(tmp_path)
    with pytest.raises(ValueError) as e_j:
        jreaders.read_atom(JParams(input_file=path))
    with pytest.raises(ValueError) as e_t:
        treaders.read_atom(TParams(input_file=path))
    assert str(e_t.value) == str(e_j.value)


def test_empty_dump_raises_jax_python_error(tmp_path):
    """An empty dump raises the error of mdbench_tpu's Python dump reader
    (its native loader, where built, fails on it with numpy's error)."""
    path = _empty_dmp(tmp_path)
    with pytest.raises(ValueError, match=f"^Input error: no atoms read from {re.escape(path)}$"):
        treaders.read_atom(TParams(input_file=path))
