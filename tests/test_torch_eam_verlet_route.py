"""The verlet EAM force's route through ops/eam.py on the CPU: the split
passes (eam_density, the ghost fp, eam_pair_forces) against the composed
compute_force_eam(_poly) bit for bit and against mdbench_tpu's at 1e-12
(float64) and 1e-5 (float32) of max |value|, on chip_smoke's edge-case
lists (verlet_eam_edge_cases: numneigh 0 over real entries, sentinel and
NaN rows in lists, pairs at the cutoff and one ulp inside it, padding
rows, lists longer than their width; an odd width over 53 atoms with a
block of 16 empty rows and rows at and past the width; a single local
atom); CPU tensors never reach the kernel build; the kernel operand
checks hold for the lists that every verlet EAM path builds; ops/eam.py
imports no jax.

mdbench_tpu multiplies d by a masked 0, so a list that holds a NaN row
gives its atom a NaN force there and 0 here; those rows are compared to
the port's own expectation (0 for the NaN atom, finite elsewhere)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    VERLET_EAM_CUTSQ,
    verlet_eam_case,
    verlet_eam_edge_cases,
    write_standin_funcfl,
)
from mdbench_tpu.models import eam_tables as jtab
from mdbench_tpu.ops import eam as jeam
from mdbench_tpu_torch import _build
from mdbench_tpu_torch.config import FF_EAM, Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.models import eam_tables as ttab
from mdbench_tpu_torch.ops import eam as team

torch.set_num_threads(1)
TOL = {np.float64: 1e-12, np.float32: 1e-5}
T_OF = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


def _port_args(case, dtype, eam_file):
    t = ttab.load_eam(eam_file)
    return (torch.tensor(case["x"]), torch.tensor(case["neighbors"]),
            torch.tensor(case["numneigh"]), torch.tensor(case["border_map"]),
            case["nlocal_pad"], case["nlocal_pad"], VERLET_EAM_CUTSQ,
            team.EamDevice.from_tables(t, "cpu", T_OF[dtype]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("poly", [False, True], ids=["spline", "poly"])
def test_split_passes_on_edge_cases(eam_file, dtype, poly):
    for name, case in verlet_eam_edge_cases(dtype).items():
        _check_split_passes(eam_file, dtype, poly, case, name)


def _check_split_passes(eam_file, dtype, poly, case, name):
    x, nb, nn, bmap, _, npad, cutsq, tdev = _port_args(case, dtype, eam_file)
    tpoly = ttab.fit_eam_poly(ttab.load_eam(eam_file)) if poly else None
    st, fp = team.eam_density(x, nb, nn, npad, cutsq, tdev, tpoly)
    team.ghost_fp_refresh(fp, bmap, npad)
    f = team.eam_pair_forces(st, fp, nb, tpoly)
    composed = (team.compute_force_eam_poly(x, nb, nn, bmap, npad, npad, cutsq, tdev,
                                            tpoly) if poly else
                team.compute_force_eam(x, nb, nn, bmap, npad, npad, cutsq, tdev))
    assert torch.equal(f, composed[0]) and torch.equal(fp, composed[1]), name
    assert f.dtype == T_OF[dtype] and fp.shape == (x.shape[0],), name

    _, rho = team.eam_rho_nlist(x, nb, nn, npad, cutsq, tdev, tpoly)
    empty = case["empty"]
    assert bool((rho[empty] == 0).all()) and bool((f[empty] == 0).all()), name
    inside = case["inside"]
    assert float(rho[inside]) > 0 and float(f[inside, 1]) != 0, name
    assert bool(torch.isfinite(f).all()) and bool(torch.isfinite(fp).all()), name

    t = jtab.load_eam(eam_file)
    jargs = (jnp.asarray(case["x"]), jnp.asarray(case["neighbors"]),
             jnp.asarray(case["numneigh"]), jnp.asarray(case["border_map"]), npad, npad,
             cutsq, jeam.EamDevice.from_tables(t, jnp.dtype(dtype)))
    f_j, fp_j = (jeam.compute_force_eam_poly(*jargs, jtab.fit_eam_poly(t)) if poly
                 else jeam.compute_force_eam(*jargs))
    f_j, fp_j = np.asarray(f_j, np.float64), np.asarray(fp_j, np.float64)
    nan_rows = case["nan_rows"]
    assert np.isnan(f_j[nan_rows]).any(axis=1).all(), name
    keep = np.setdiff1d(np.arange(npad), nan_rows)
    for got, want in ((f.double().numpy()[keep], f_j[keep]), (fp.double().numpy(), fp_j)):
        assert np.abs(want).max() > 0, name
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL[dtype], (name, err)


def test_edge_cases_cover_the_layouts():
    """The edge cases hold what the kernels' layout is tested on: an odd
    width (rows 8 bytes off a 16-byte boundary), a row count no multiple of
    a block's 8 warps, a block of 16 empty rows, rows at and past the
    width, a single local atom, the sentinel row mid-list, a row with a
    pair inside the cutoff; row ids within the rows."""
    cases = verlet_eam_edge_cases(np.float64)
    odd, one = cases["odd k"], cases["one atom"]
    k = odd["neighbors"].shape[1]
    assert k % 2 == 1 and odd["nlocal_pad"] % 8 != 0
    assert (odd["numneigh"][16:32] == 0).all() and set(range(16, 32)) <= set(odd["empty"])
    assert (odd["numneigh"] == k).any() and (odd["numneigh"] > k).any()
    assert one["nlocal_pad"] == 1 and one["numneigh"][0] > 0
    for case in cases.values():
        nrows, sentinel = case["x"].shape[0], case["x"].shape[0] - 1
        nb, nn = case["neighbors"], case["numneigh"]
        assert nb.min() >= 0 and nb.max() < nrows
        assert nb.shape[0] == nn.shape[0] == case["nlocal_pad"]
        assert case["border_map"].shape == (nrows - 1 - case["nlocal_pad"],)
        listed = np.arange(nb.shape[1])[None, :] < np.minimum(nn, nb.shape[1])[:, None]
        assert (nb[listed] == sentinel).any()
        assert not (nb == np.arange(nb.shape[0])[:, None])[listed].any()
        assert nn[case["inside"]] > 0


def test_cpu_never_builds(eam_file, monkeypatch):
    """Every verlet EAM entry point on CPU tensors runs the plain versions
    without loading the kernel library."""
    def boom(*a, **k):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "load", boom)
    monkeypatch.setattr(_build, "build", boom)
    before = dict(team.LAUNCHES)
    case = verlet_eam_case(np.float64)
    x, nb, nn, bmap, _, npad, cutsq, tdev = _port_args(case, np.float64, eam_file)
    poly = ttab.fit_eam_poly(ttab.load_eam(eam_file))
    team.compute_force_eam(x, nb, nn, bmap, npad, npad, cutsq, tdev)
    team.compute_force_eam_poly(x, nb, nn, bmap, npad, npad, cutsq, tdev, poly)
    for ev in ("spline", "poly"):
        sim = Simulation(Params(nx=4, ny=4, nz=4, ntimes=4, reneigh_every=2,
                                precision="dp", force_field=FF_EAM, eam_file=eam_file,
                                eam_eval=ev), device="cpu")
        assert np.isfinite(sim.run(repeats=0).temps).all()
    assert team.LAUNCHES == before


@pytest.mark.parametrize("path", ["engine", "slabs", "pencils", "stub"])
def test_paths_meet_kernel_contract(eam_file, path):
    """The lists, coordinates and tables each verlet EAM path hands the
    force pass the checks the CUDA wrappers make (the card would raise)."""
    kw = dict(nx=4, ny=4, nz=4, ntimes=2, precision="dp", force_field=FF_EAM,
              eam_file=eam_file)
    seen = []
    real = team.eam_rho_nlist

    def spy(x, neighbors, numneigh, nlocal_pad, cutforcesq, eam, poly=None, **k):
        team.check_nlist_args(x, neighbors, numneigh, nlocal_pad, eam)
        seen.append(nlocal_pad)
        return real(x, neighbors, numneigh, nlocal_pad, cutforcesq, eam, poly, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(team, "eam_rho_nlist", spy)
        if path == "engine":
            Simulation(Params(**kw), device="cpu").first_force()
        elif path == "stub":
            from mdbench_tpu_torch.stub import run_stub

            run_stub(natoms=256, nneighs=20, ntimes=1, precision="dp", device="cpu",
                     force_field="eam", eam_file=eam_file)
        else:
            from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation
            from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation

            kw.update(nx=8, ny=8, nz=4)
            sim = (DomainSimulation(Params(**kw), ndev=2, device="cpu") if path == "slabs"
                   else Domain2DSimulation(Params(**kw), 2, 2, device="cpu"))
            sim.run(repeats=0)
    assert seen


@pytest.mark.parametrize("bad,exc", [
    (lambda a: {**a, "neighbors": a["neighbors"].int()}, TypeError),
    (lambda a: {**a, "numneigh": a["numneigh"][:-1]}, ValueError),
    (lambda a: {**a, "x": a["x"].t().contiguous().t()}, ValueError),
    (lambda a: {**a, "x": a["x"].half()}, TypeError),
    (lambda a: {**a, "neighbors": a["neighbors"].t().contiguous().t()}, ValueError),
    (lambda a: {**a, "eam": a["eam"]._replace(frho=a["eam"].frho.float())}, ValueError),
])
def test_kernel_operand_checks(eam_file, bad, exc):
    case = verlet_eam_case(np.float64)
    x, nb, nn, _, _, npad, _, tdev = _port_args(case, np.float64, eam_file)
    a = bad(dict(x=x, neighbors=nb, numneigh=nn, eam=tdev))
    team.check_nlist_args(x, nb, nn, npad, tdev)
    with pytest.raises(exc):
        team.check_nlist_args(a["x"], a["neighbors"], a["numneigh"], npad, a["eam"])


def test_other_devices_raise(eam_file):
    case = verlet_eam_case(np.float64)
    x, nb, nn, _, _, npad, cutsq, tdev = _port_args(case, np.float64, eam_file)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="no verlet EAM kernel"):
        team.eam_rho_nlist(meta, nb, nn, npad, cutsq, tdev)
    with pytest.raises(ValueError, match="no verlet EAM kernel"):
        team.eam_force_nlist(meta, nb, nn, meta[:npad, 0], meta[:, 0], cutsq, tdev)


def test_ops_eam_imports_no_jax():
    code = ("import sys; import mdbench_tpu_torch.ops.eam; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'mdbench_tpu' or m.startswith('mdbench_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
