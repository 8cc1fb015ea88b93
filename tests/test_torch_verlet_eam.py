"""The port's verlet-scheme EAM (ops/eam.py compute_force_eam and
compute_force_eam_poly, engine.Simulation with force_field=eam) against
mdbench_tpu's, on the CPU, with the stand-in funcfl potential of
chip_smoke.py (Cu_u3's grid, analytic tables): both passes (forces and
the fp array with its ghost rows) on the same lists in float64 and
float32, the eam_eval rule, the engine's step-0 forces and 40-step
trajectories in float64, the refusals, and that a verlet EAM run of the
port imports no jax.

Tolerances are relative to max |value|: 1e-12 in float64 and 1e-5 in
float32 for one evaluation (only the summation order differs; float32 on
a box jittered by 0.15 A, since near the lattice an EAM force is a small
difference of large terms), 1e-10 for step-0 forces and rel 1e-9 for a
40-step trajectory.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu.config import FF_EAM
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine import Simulation as JSim
from mdbench_tpu.models import eam_tables as jtab
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops import eam as jeam
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.engine import Simulation as TSim
from mdbench_tpu_torch.engine_cluster import check_slice
from mdbench_tpu_torch.models import eam_tables as ttab
from mdbench_tpu_torch.ops import eam as team

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TOL = {np.float64: 1e-12, np.float32: 1e-5}
T_OF = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(scope="module")
def eam_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("eam") / "standin.eam"
    write_standin_funcfl(path)
    return str(path)


def _kw(eam_file, n=4, **kw):
    return dict(nx=n, ny=n, nz=n, precision="dp", force_field=FF_EAM,
                eam_file=eam_file, **kw)


def _jittered(eam_file, n, sigma, seed=3):
    """FCC positions at the EAM lattice constant, jittered by `sigma` A,
    and the lattice's velocities."""
    x, v, _ = create_fcc_lattice(
        jtab.apply_eam_overrides(JParams(**_kw(eam_file, n)), jtab.load_eam(eam_file)))
    return x + np.random.default_rng(seed).normal(0.0, sigma, x.shape), v


@pytest.fixture(scope="module")
def lists(eam_file):
    """mdbench_tpu's per-atom lists and halo of a jittered 5^3 box (float64
    numpy), with the engine's sizes."""
    x, v = _jittered(eam_file, 5, 0.15)
    sim = JSim(JParams(**_kw(eam_file, 5)), x=x, v=v)
    st = sim.initial_state()
    assert not bool(st.overflow)
    return dict(x=np.asarray(st.x), nb=np.asarray(st.nlist.neighbors),
                nn=np.asarray(st.nlist.numneigh), bmap=np.asarray(st.halo.border_map),
                nghost=int(st.halo.nghost), nlocal=sim.nlocal,
                npad=sim.caps.nlocal_pad, cutsq=sim.params.cutforce**2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("poly", [False, True], ids=["spline", "poly"])
def test_passes_match_jax(eam_file, lists, dtype, poly):
    """Forces and fp (local and ghost rows) of one evaluation on the same
    lists; fp on the sentinel row stays 0."""
    t = jtab.load_eam(eam_file)
    a = lists
    common = (a["nlocal"], a["npad"], a["cutsq"])
    jdev = jeam.EamDevice.from_tables(t, jnp.dtype(dtype))
    jargs = (jnp.asarray(a["x"], dtype), jnp.asarray(a["nb"]), jnp.asarray(a["nn"]),
             jnp.asarray(a["bmap"]), *common, jdev)
    tdev = team.EamDevice.from_tables(ttab.load_eam(eam_file), "cpu", T_OF[dtype])
    targs = (torch.tensor(a["x"], dtype=T_OF[dtype]), torch.tensor(a["nb"]).long(),
             torch.tensor(a["nn"]).long(), torch.tensor(a["bmap"]).long(), *common, tdev)
    if poly:
        f_j, fp_j = jeam.compute_force_eam_poly(*jargs, jtab.fit_eam_poly(t))
        f_t, fp_t = team.compute_force_eam_poly(*targs, ttab.fit_eam_poly(
            ttab.load_eam(eam_file)))
    else:
        f_j, fp_j = jeam.compute_force_eam(*jargs)
        f_t, fp_t = team.compute_force_eam(*targs)
    assert f_t.dtype == T_OF[dtype] and fp_t.shape == (a["x"].shape[0],)
    for got, want in ((f_t, f_j), (fp_t, fp_j)):
        want = np.asarray(want, np.float64)
        assert np.abs(want).max() > 0
        err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
        assert err <= TOL[dtype], err
    ghosts = slice(a["npad"], a["npad"] + a["nghost"])
    assert bool((fp_t[ghosts] != 0).all()) and fp_t[-1] == 0


@pytest.mark.parametrize("eval_, precision, device, poly", [
    ("auto", "sp", "cuda", True), ("auto", "sp", "cpu", False),
    ("auto", "dp", "cuda", False), ("poly", "dp", "cpu", True),
    ("spline", "sp", "cuda", False),
])
def test_use_poly_eval_rule(eval_, precision, device, poly):
    """"auto" is poly for SP on a CUDA device (mdbench_tpu: on a TPU)."""
    p = TParams(nx=4, ny=4, nz=4, eam_eval=eval_, precision=precision)
    assert team.use_poly_eval(p, torch.device(device)) is poly


@pytest.mark.parametrize("eval_", ["spline", "poly"])
def test_step0_forces_match_jax(eam_file, eval_):
    x, v = _jittered(eam_file, 5, 0.05)
    kw = _kw(eam_file, 5, eam_eval=eval_)
    f_j = JSim(JParams(**kw), x=x, v=v).first_force()
    sim = TSim(TParams(**kw), x=x, v=v, device="cpu")
    assert (sim.eam_poly is not None) == (eval_ == "poly")
    f_t = sim.first_force()
    assert np.abs(f_j).max() > 0.1
    assert np.abs(f_t - f_j).max() / np.abs(f_j).max() < 1e-10


@pytest.mark.parametrize("eval_", ["spline", "poly"])
def test_trajectory_matches_jax(eam_file, eval_):
    """The 4^3 40-step DP run with rebuilds at 20 and 40: temperatures and
    pressures, and the final velocities."""
    kw = _kw(eam_file, ntimes=40, eam_eval=eval_)
    r_j = JSim(JParams(**kw)).run()
    sim = TSim(TParams(**kw), device="cpu")
    r_t = sim.run(repeats=0)
    assert r_t.temps.shape == (40,) and np.isfinite(r_t.temps).all()
    assert r_t.temps[0] == pytest.approx(600.0, rel=0.05)  # initEam's temp
    np.testing.assert_allclose(r_t.temps, r_j.temps, rtol=1e-9)
    np.testing.assert_allclose(r_t.press, r_j.press, rtol=1e-9)
    v_t = sim._snapshot(r_t.state)[1]
    v_j = np.asarray(r_j.state.v[: sim.nlocal])
    assert np.abs(v_t - v_j).max() <= 1e-9 * np.abs(v_j).max()


def test_timers_diff_chain_keeps_the_trajectory(eam_file):
    """_force_reps = 2 chains one extra force a plain step from x + 1e-30 f:
    the trajectory moves by rounding only."""
    kw = _kw(eam_file, ntimes=10, reneigh_every=5)
    ref = TSim(TParams(**kw), device="cpu").run(repeats=0)
    sim = TSim(TParams(**kw), device="cpu")
    sim._force_reps = 2
    np.testing.assert_allclose(sim.run(repeats=0).temps, ref.temps, rtol=1e-12)


def test_refusals_match_jax(eam_file):
    """EAM without a potential file raises ValueError in both packages;
    verlet EAM passes the port's slice check."""
    kw = dict(nx=4, ny=4, nz=4, force_field=FF_EAM)
    with pytest.raises(ValueError, match="eam_file"):
        JSim(JParams(**kw))
    with pytest.raises(ValueError, match="eam_file"):
        TSim(TParams(**kw), device="cpu")
    check_slice(TParams(**_kw(eam_file)))


def test_verlet_eam_imports_no_jax(eam_file):
    code = (
        "import sys\n"
        "from mdbench_tpu_torch.config import FF_EAM, Params\n"
        "from mdbench_tpu_torch.engine import Simulation\n"
        f"p = Params(nx=4, ny=4, nz=4, ntimes=4, reneigh_every=2,"
        f" force_field=FF_EAM, eam_file={eam_file!r}, eam_eval='poly')\n"
        "out = Simulation(p, device='cpu').run(repeats=0)\n"
        "assert out.temps.shape == (4,)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mdbench_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
