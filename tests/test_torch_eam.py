"""The port's cluster-scheme EAM against mdbench_tpu's, on the CPU, with the
stand-in funcfl potential of chip_smoke.py (Cu_u3's grid, analytic
tables): the table pipeline (bit-equal), the two passes and the whole
force against the XLA twin (float64 and float32) and the Pallas kernels in
interpret mode (float32), the engine's forces and trajectory (float64),
the refusals, the wrapper's device rule and argument checks, and that an
EAM run of the port imports no jax.

Tolerances are relative to max |value|: 1e-12 in float64 and 1e-5 in
float32 for one force evaluation (only the summation order differs), 1e-10
for step-0 forces and 1e-9 for a 40-step trajectory (rounding differences
grow along it). The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_standin_funcfl
from mdbench_tpu import thermo as jthermo
from mdbench_tpu.config import FF_EAM
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models import eam_tables as jtab
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops.eam import EamDevice as JEamDevice
from mdbench_tpu.ops.eam_cluster import eam_cluster_force_xla
from mdbench_tpu.ops.pallas.eam_cluster import eam_cluster_force_pallas
from mdbench_tpu_torch import thermo as tthermo
from mdbench_tpu_torch.config import Params as TParams
from mdbench_tpu_torch.convert import (
    clusters_from_numpy,
    eam_from_numpy,
    pairs_from_numpy,
)
from mdbench_tpu_torch.engine_cluster import ClusterSimulation as TSim
from mdbench_tpu_torch.engine_cluster import check_slice
from mdbench_tpu_torch.models import eam_tables as ttab
from mdbench_tpu_torch.ops import eam_cluster as tec
from mdbench_tpu_torch.ops.eam import EamDevice as TEamDevice
from test_torch_cuda import synthetic_eam_case

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
    return dict(nx=n, ny=n, nz=n, scheme="cluster", precision="dp",
                force_field=FF_EAM, eam_file=eam_file, **kw)


def _jittered(eam_file, n, seed=3, sigma=0.05):
    """FCC positions at the EAM lattice constant, jittered by `sigma` A,
    and the lattice's velocities."""
    tables = jtab.load_eam(eam_file)
    x, v, _ = create_fcc_lattice(
        jtab.apply_eam_overrides(JParams(**_kw(eam_file, n)), tables))
    return x + np.random.default_rng(seed).normal(0.0, sigma, x.shape), v


def test_tables_bit_equal(eam_file):
    for a, b in zip(jtab.read_funcfl(eam_file), ttab.read_funcfl(eam_file)):
        np.testing.assert_array_equal(b, a)
    tj, tt = jtab.load_eam(eam_file), ttab.load_eam(eam_file)
    for a, b in zip(tj, tt):
        np.testing.assert_array_equal(b, a)
    pj, pt = jtab.fit_eam_poly(tj), ttab.fit_eam_poly(tt)
    for a, b in zip(pj, pt):
        np.testing.assert_array_equal(b, a)
    assert pt.max_rel_err < 1e-4  # the stand-in is smooth enough to fit
    # initEam's overrides, the EAM thermo scales and dtforce
    qj = jtab.apply_eam_overrides(JParams(**_kw(eam_file)), tj)
    qt = ttab.apply_eam_overrides(TParams(**_kw(eam_file)), tt)
    assert vars(qt) == vars(qj)
    assert (qt.rho, qt.cutforce, qt.mass) == (0.07041125, tt.cut, tt.mass)
    n = qt.natoms_expected
    sj, st = jthermo.setup_thermo(qj, n), tthermo.setup_thermo(qt, n)
    assert tuple(st) == tuple(sj)
    assert tthermo.adjusted_dtforce(qt, st) == jthermo.adjusted_dtforce(qj, sj)
    # the device tables, directly and carried across from mdbench_tpu's
    dev_t = TEamDevice.from_tables(tt, "cpu", torch.float64)
    dev_c, poly_c = eam_from_numpy(
        JEamDevice.from_tables(tj, jnp.float64), pj, "cpu", torch.float64)
    for name in ("rhor", "frho", "z2r"):
        np.testing.assert_array_equal(getattr(dev_t, name).numpy(),
                                      getattr(tt, f"{name}_spline"))
        assert torch.equal(getattr(dev_c, name), getattr(dev_t, name))
    assert dev_c[3:] == dev_t[3:] == (tt.rdr, tt.rdrho, tt.nr, tt.nrho)
    for a, b in zip(poly_c, pt):
        np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _engine_case(eam_file, share):
    """Planes, lists, halo and EAM parameters of a jittered 4^3 EAM box
    built by mdbench_tpu (numpy dicts, float64). The jitter is 0.15 A:
    near the lattice the force is a small difference of large embedding
    and pair terms, and at 0.05 A their float32 rounding alone reaches
    1.5e-5 of max |f| (mdbench_tpu's float32 against its float64)."""
    x, v = _jittered(eam_file, 4, sigma=0.15)
    sim = JSim(JParams(**_kw(eam_file, ishare=share)), x=x, v=v)
    st = sim.initial_state()
    cl = {k: np.asarray(getattr(st.clusters, k)) for k in st.clusters._fields}
    pairs = {k: np.asarray(getattr(st.pairs, k)) for k in
             ("jlist", "nj", "overflow", "ijlist", "nji", "iovf")}
    return (cl, pairs, np.asarray(st.halo.border_map), sim.n_clusters_pad,
            sim.ishare, sim.eam_tables, sim.eam_poly)


def _case(name, share, eam_file):
    if name == "engine":
        return _engine_case(eam_file, share)
    cl, pairs, border_map, _, npad, share = synthetic_eam_case(share, share)
    tables = jtab.load_eam(eam_file)
    return cl, pairs, border_map, npad, share, tables, jtab.fit_eam_poly(tables)


def _identity_eam(np_dtype, n=4096, rd=64.0):
    """An EamDevice whose frho spline is F'(rho) = rho for rho < n/rd, so
    the XLA twin's fp plane reads out its pass-1 density."""
    m = np.arange(n + 1, dtype=np.float64)
    frho = np.zeros((n + 1, 7))
    frho[:, 1] = 1.0 / rd
    frho[:, 2] = (m - 1.0) / rd
    unused = jnp.zeros((2, 7), np_dtype)
    return JEamDevice(rhor=unused, frho=jnp.asarray(frho, np_dtype),
                      z2r=unused, rdr=1.0, rdrho=rd, nr=1, nrho=n)


def _xla(jargs, eam, poly, share):
    """mdbench_tpu's XLA twin on (xc, yc, zc, ijlist, border_map, npad,
    cutforcesq), compiled as one program: run op by op it compiles every
    primitive anew for each case's shapes, several times slower here."""
    *arrays, npad, cut2 = jargs
    return jax.jit(lambda *a: eam_cluster_force_xla(
        *a, npad, cut2, eam, poly, share=share))(*arrays)


def _rel(a, b):
    a = np.stack([np.asarray(t, np.float64) for t in a])
    b = np.stack([np.asarray(t, np.float64) for t in b])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name,share", [
    ("engine", 2), ("engine", 1), ("synthetic", 1), ("synthetic", 2),
])
@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
def test_passes_match_jax(eam_file, name, share, np_dtype):
    cl, pairs, border_map, npad, share, tables, poly = _case(name, share, eam_file)
    tdtype = T_OF[np_dtype]
    cut2 = tables.cut**2
    sentinel16 = cl["xc"].shape[0] // 2 - 1
    assert (pairs["ijlist"] == sentinel16).any()
    real = np.abs(cl["xc"][:npad]) < 1e29
    pad_units = ~real.reshape(-1, share * 8).any(1)
    assert pad_units.any()

    c = clusters_from_numpy(cl, "cpu", tdtype)
    pr = pairs_from_numpy(pairs, "cpu")
    bm = torch.tensor(border_map, dtype=torch.int64)
    eam_t, poly_t = eam_from_numpy(tables, poly, "cpu", tdtype)
    planes = (c.xc, c.yc, c.zc)

    jp = [jnp.asarray(cl[k].astype(np_dtype)) for k in ("xc", "yc", "zc")]
    jargs = (*jp, jnp.asarray(pairs["ijlist"]), jnp.asarray(border_map), npad,
             cut2)
    # pass 1: mdbench_tpu's density, read through an identity frho spline
    *_, rho_j = _xla(jargs, _identity_eam(np_dtype), poly, share)
    rho_t = tec.eam_rho_ilist_ref(*planes, pr.ijlist, npad, cut2, poly_t, share)
    assert float(rho_t.abs().max()) > 0.01
    assert _rel([rho_t], [np.asarray(rho_j)[:npad]]) <= TOL[np_dtype]
    assert (rho_t.reshape(-1, share * 8)[torch.as_tensor(pad_units)] == 0).all()

    # pass 2 on mdbench_tpu's fp plane, and the whole force
    jeam = JEamDevice.from_tables(tables, np_dtype)
    *f_j, fp_j = _xla(jargs, jeam, poly, share)
    fp_plane = torch.tensor(np.asarray(fp_j), dtype=tdtype)
    f_t = tec.eam_force_ilist_ref(*planes, fp_plane, pr.ijlist, npad, cut2,
                                  poly_t, share)
    assert np.abs(np.asarray(f_j[0])).max() > 1e-3  # forces are not trivial
    assert _rel(f_t, f_j) <= TOL[np_dtype]
    *f_w, fp_w = tec.eam_cluster_force_ref(*planes, pr.ijlist, bm, npad, cut2,
                                           eam_t, poly_t, share)
    assert _rel(f_w, f_j) <= TOL[np_dtype]
    assert _rel([fp_w], [fp_j]) <= TOL[np_dtype]
    for f in f_w:
        assert (f.reshape(-1, share * 8)[torch.as_tensor(pad_units)] == 0).all()
    if np_dtype == np.float32:
        *f_p, fp_p = eam_cluster_force_pallas(*jargs, jeam, poly, share=share,
                                              interpret=True)
        assert _rel(f_w, f_p) <= TOL[np_dtype]
        assert _rel([fp_w], [fp_p]) <= TOL[np_dtype]


def test_step0_forces_match_jax(eam_file):
    x, v = _jittered(eam_file, 5)
    f_j = JSim(JParams(**_kw(eam_file, 5)), x=x, v=v).first_force_atoms()
    f_t = TSim(TParams(**_kw(eam_file, 5)), x=x, v=v,
               device="cpu").first_force_atoms()
    assert np.abs(f_j).max() > 0.1
    assert np.abs(f_t - f_j).max() <= 1e-10 * np.abs(f_j).max()


def test_trajectory_matches_jax(eam_file):
    """40 steps with both rebuild kinds: cheap at steps 10 and 30, the
    full re-cluster at 20 and 40."""
    kw = _kw(eam_file, ntimes=40, reneigh_every=10, resort_every=20)
    r_j = JSim(JParams(**kw)).run()
    sim = TSim(TParams(**kw), device="cpu")
    r_t = sim.run()
    assert sim.natoms == 256 and r_t.temps.shape == (40,)
    assert r_t.temps[0] < 600.0 and r_t.temps[-1] < r_t.temps[0]
    np.testing.assert_allclose(r_t.temps, r_j.temps, rtol=1e-9)
    np.testing.assert_allclose(r_t.press, r_j.press, rtol=1e-9)


@pytest.mark.parametrize("kw", [
    {"eam_file": None}, {"half_neigh": 1}, {"eam_eval": "spline"},
])
def test_eam_refusals_match_jax(eam_file, kw):
    check_slice(TParams(**_kw(eam_file)))  # the port runs cluster EAM
    with pytest.raises(ValueError):
        JSim(JParams(**{**_kw(eam_file), **kw}))
    with pytest.raises(ValueError):
        TSim(TParams(**{**_kw(eam_file), **kw}), device="cpu")


def _wrapper_args(eam_file, tdtype=torch.float64):
    cl, pairs, border_map, fp, npad, share = synthetic_eam_case(7, 2)
    c = clusters_from_numpy(cl, "cpu", tdtype)
    pr = pairs_from_numpy(pairs, "cpu")
    tables = ttab.load_eam(eam_file)
    return dict(
        xc=c.xc, yc=c.yc, zc=c.zc, fp_plane=torch.tensor(fp, dtype=tdtype),
        ijlist=pr.ijlist, nji=pr.nji,
        border_map=torch.tensor(border_map, dtype=torch.int64),
        n_clusters_pad=npad, cutforcesq=tables.cut**2,
        eam=TEamDevice.from_tables(tables, "cpu", tdtype),
        poly=ttab.fit_eam_poly(tables), share=share,
    )


def test_wrappers_on_cpu_are_the_plain_versions(eam_file):
    a = _wrapper_args(eam_file)
    planes = (a["xc"], a["yc"], a["zc"])
    common = (a["n_clusters_pad"], a["cutforcesq"], a["poly"])
    before = dict(tec.LAUNCHES)
    got = tec.eam_cluster_force(
        *planes, a["ijlist"], a["nji"], a["border_map"], *common[:2], a["eam"],
        a["poly"], share=a["share"])
    want = tec.eam_cluster_force_ref(
        *planes, a["ijlist"], a["border_map"], *common[:2], a["eam"],
        a["poly"], share=a["share"])
    rho = tec.eam_rho_ilist(*planes, a["ijlist"], a["nji"], *common,
                            share=a["share"])
    f = tec.eam_force_ilist(*planes, a["fp_plane"], a["ijlist"], a["nji"],
                            *common, share=a["share"])
    assert torch.equal(rho, tec.eam_rho_ilist_ref(
        *planes, a["ijlist"], *common, share=a["share"]))
    for x, y in zip(f, tec.eam_force_ilist_ref(
            *planes, a["fp_plane"], a["ijlist"], *common, share=a["share"])):
        assert torch.equal(x, y)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert tec.LAUNCHES == before


def test_wrappers_refuse_other_devices(eam_file):
    a = {k: (v.to("meta") if torch.is_tensor(v) else v)
         for k, v in _wrapper_args(eam_file).items()}
    planes = (a["xc"], a["yc"], a["zc"])
    common = (a["n_clusters_pad"], a["cutforcesq"])
    calls = [
        lambda: tec.eam_cluster_force(
            *planes, a["ijlist"], a["nji"], a["border_map"], *common,
            a["eam"], a["poly"], share=a["share"]),
        lambda: tec.eam_rho_ilist(*planes, a["ijlist"], a["nji"], *common,
                                  a["poly"], share=a["share"]),
        lambda: tec.eam_force_ilist(*planes, a["fp_plane"], a["ijlist"],
                                    a["nji"], *common, a["poly"],
                                    share=a["share"]),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no EAM kernel"):
            call()


def _check(a):
    """The checks the CUDA wrappers make before a launch."""
    tec._check_cuda_args(a["xc"], a["yc"], a["zc"], a["ijlist"], a["nji"],
                         a["n_clusters_pad"], a["share"])
    tec._check_fp_plane(a["fp_plane"], a["xc"])
    tec._coefs(a["poly"], a["cutforcesq"])


@pytest.mark.parametrize("bad,exc", [
    (lambda a: {**a, "fp_plane": a["fp_plane"].float()}, ValueError),
    (lambda a: {**a, "fp_plane": a["fp_plane"][:-2]}, ValueError),
    (lambda a: {**a, "fp_plane": a["fp_plane"].t().contiguous().t()}, ValueError),
    (lambda a: {**a, "xc": a["xc"].half(), "yc": a["yc"].half(),
                "zc": a["zc"].half()}, TypeError),
    (lambda a: {**a, "nji": a["nji"].long()}, TypeError),
    (lambda a: {**a, "share": 3}, ValueError),
    (lambda a: {**a, "n_clusters_pad": a["n_clusters_pad"] + 2}, ValueError),
    (lambda a: {**a, "poly": a["poly"]._replace(g1=a["poly"].g1[:-1])},
     ValueError),
])
def test_kernel_argument_checks_raise(eam_file, bad, exc):
    args = _wrapper_args(eam_file)
    _check(args)  # the good arguments pass
    with pytest.raises(exc):
        _check(bad(args))


def test_kernel_scalar_block(eam_file):
    """The host block the C launcher copies into the kernels' argument:
    [mid, iscale, cutsq, dens, g1, g2], float64, contiguous."""
    poly = ttab.fit_eam_poly(ttab.load_eam(eam_file))
    block = tec._coefs(poly, 24.5)
    assert block.dtype == np.float64 and block.flags["C_CONTIGUOUS"]
    assert block.shape == (3 + 3 * tec.N_COEF,)
    np.testing.assert_array_equal(
        block, np.concatenate([[poly.mid, poly.iscale, 24.5], poly.dens,
                               poly.g1, poly.g2]))


def test_eam_cpu_path_imports_no_jax(eam_file):
    code = (
        "import sys\n"
        "from mdbench_tpu_torch.config import FF_EAM, Params\n"
        "from mdbench_tpu_torch.engine_cluster import ClusterSimulation\n"
        "from mdbench_tpu_torch import convert, bench\n"
        f"p = Params(nx=4, ny=4, nz=4, ntimes=4, reneigh_every=2, scheme='cluster',"
        f" force_field=FF_EAM, eam_file={eam_file!r})\n"
        "out = ClusterSimulation(p, device='cpu').run()\n"
        "assert out.temps.shape == (4,)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mdbench_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")

