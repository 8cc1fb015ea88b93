"""The port's I/O and tracing against mdbench_tpu's, on the CPU: the VTK
and tracer writers (native and Python paths) and the XTC and TRR writers
produce mdbench_tpu's bytes on the same arrays; the checkpoint saves both
engines' local atoms; the native .dmp/.in loader equals the Python
readers on a file that write_atom wrote; tracing.region is a no-op
outside a profile."""

import contextlib
import dataclasses
import io
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mdbench_tpu import tracing as jtracing
from mdbench_tpu.io import trr as jtrr
from mdbench_tpu.io import vtk as jvtk
from mdbench_tpu.io import xtc as jxtc
from mdbench_tpu_torch import tracing as ttracing
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.engine import Simulation as TSim
from mdbench_tpu_torch.engine_cluster import ClusterSimulation
from mdbench_tpu_torch.io import checkpoint, native, readers
from mdbench_tpu_torch.io import trr as ttrr
from mdbench_tpu_torch.io import vtk as tvtk
from mdbench_tpu_torch.io import xtc as txtc
from mdbench_tpu_torch.io.writers import local_atoms, write_atom

torch.set_num_threads(1)


def test_save_checkpoint_both_engines(tmp_path):
    """The saved arrays are the engines' local atoms (verlet rows in sorted
    order, cluster atoms in the original order)."""
    p = TParams(nx=4, ny=4, nz=4, precision="dp")
    for sim in (TSim(p, device="cpu"),
                ClusterSimulation(dataclasses.replace(p, scheme="cluster"), device="cpu")):
        st = sim.initial_state()
        path = str(tmp_path / "c.npz")
        checkpoint.save_checkpoint(path, sim, st, 3)
        x, v, types, meta = checkpoint.load_checkpoint(path)
        want = local_atoms(sim, st)
        for a, b in zip((x, v, types), want):
            np.testing.assert_array_equal(a, b)
        assert meta["step"] == 3 and meta["scheme"] == sim.params.scheme


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 20.0, (300, 3))
    nb = rng.integers(0, 400, (300, 24)).astype(np.int32)
    nn = rng.integers(0, 25, 300).astype(np.int32)
    planes = [np.where(rng.random((20, 8)) < 0.15, 1e30, rng.uniform(0, 9, (20, 8)))
              for _ in range(3)]
    return x, nb, nn, planes


@pytest.fixture(params=[True, False], ids=["native", "python"])
def writer_path(request, monkeypatch):
    """The port's writers with the native library (where it loads) or with
    their Python versions."""
    if not request.param:
        for fn in ("write_atoms_vtk", "write_index_trace", "write_mem_trace"):
            monkeypatch.setattr(native, fn, lambda *a, **k: False)
    return request.param


def _same_files(a: Path, b: Path, names):
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_vtk_and_trace_bytes_match_jax(tmp_path, arrays, writer_path):
    x, nb, nn, planes = arrays
    dj, dt = tmp_path / "j", tmp_path / "t"
    dj.mkdir()
    dt.mkdir()
    for d, vtk, tr in ((dj, jvtk, jtracing), (dt, tvtk, ttracing)):
        vtk.write_atoms_to_vtk_file(str(d / "a"), x, 5)
        vtk.write_ghost_atoms_to_vtk_file(str(d / "a"), x[:7], 5)
        tr.dump_index_trace(str(d / "i_"), nb, nn, 3)
        tr.dump_mem_trace(str(d / "m_"), nb, nn, 3, nlocal=250, float_size=8)
    cj = SimpleNamespace(xc=planes[0], yc=planes[1], zc=planes[2])
    ct = SimpleNamespace(**{k: torch.tensor(v) for k, v in vars(cj).items()})
    jvtk.write_cluster_vtk_files(str(dj / "c"), cj, 12, 2, 4)
    tvtk.write_cluster_vtk_files(str(dt / "c"), ct, 12, 2, 4)
    names = sorted(p.name for p in dj.iterdir())
    assert len(names) == 8 and names == sorted(p.name for p in dt.iterdir())
    _same_files(dj, dt, names)


def test_xtc_and_trr_bytes_match_jax(tmp_path, arrays):
    x = arrays[0]
    box = (20.0, 21.0, 22.0)
    for ext in ("xtc", "trr"):
        paths = []
        for name, mod in (("j", jtrr), ("t", ttrr)):
            w = mod.xtc_init(str(tmp_path / f"{name}.{ext}"), box)
            for step in (0, 20):
                mod.xtc_write(w, x + 0.01 * step, step, step * 0.005)
            mod.xtc_end(w)
            paths.append(w.path)
        assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()
    frames = ttrr.read_trr(str(tmp_path / "t.trr"))
    assert [f[0] for f in frames] == [0, 20]
    np.testing.assert_allclose(frames[1][3], x + 0.2, rtol=1e-6)
    xf = txtc.read_xtc(str(tmp_path / "t.xtc"))
    # precision 1000: half a unit, plus float32 rounding of 20 A coordinates
    assert len(xf) == 2 and np.abs(xf[0]["x"] - x).max() <= 5e-4 + 4e-6
    buf_j, buf_t = io.BytesIO(), io.BytesIO()
    jxtc.write_xtc_frame(buf_j, x[:5], box, 1, 0.5)  # the uncompressed form
    txtc.write_xtc_frame(buf_t, x[:5], box, 1, 0.5)
    assert buf_j.getvalue() == buf_t.getvalue()


def test_native_loader_matches_python_reader(tmp_path):
    """A file written by write_atom (behind the .in header) and a LAMMPS dump,
    read natively and in Python: the same arrays."""
    p = TParams(nx=4, ny=4, nz=4, precision="dp")
    sim = TSim(p, device="cpu")
    st = sim.initial_state()
    body = tmp_path / "body.csv"
    write_atom(str(body), sim, st)
    path_in = tmp_path / "a.in"
    path_in.write_text(f"{sim.nlocal} 0 {p.xprd} 0 {p.yprd} 0 {p.zprd}\n"
                       + body.read_text())
    x, v, types = local_atoms(sim, st)
    path_dmp = tmp_path / "a.dmp"
    path_dmp.write_text("\n".join(
        ["ITEM: TIMESTEP", "0", "ITEM: NUMBER OF ATOMS", str(sim.nlocal),
         "ITEM: BOX BOUNDS pp pp pp", *(f"0.0 {b!r}" for b in (p.xprd, p.yprd, p.zprd)),
         "ITEM: ATOMS id type x y z vx vy vz"]
        + [f"{i + 1} {types[i] + 1} " + " ".join(repr(float(a)) for a in (*x[i], *v[i]))
           for i in range(sim.nlocal)]) + "\n")
    assert native.available()
    for path, kind, read in ((path_in, "in", readers.read_atom_in),
                             (path_dmp, "dmp", readers.read_atom_dmp)):
        got = native.parse(str(path), kind)
        want = read(str(path))
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[3], want.box, rtol=1e-15)
    # write_atom's six decimals
    np.testing.assert_allclose(readers.read_atom_in(str(path_in)).x, x, atol=5e-7)


def test_region_is_a_noop_outside_a_profile(tmp_path):
    assert isinstance(ttracing.region("force"), contextlib.nullcontext)
    with ttracing.profile(str(tmp_path / "p")):
        assert not isinstance(ttracing.region("force"), contextlib.nullcontext)
    assert (tmp_path / "p" / ttracing.TRACE_FILE).exists()
