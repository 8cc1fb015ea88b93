"""The exact-list kernels' two-sweep design on the CPU: the distance sweep
that marks each lane's pairs inside the cutoff, and the pair math over the
marked pairs only, in list order (csrc/ilist_sweep.cuh, used by
csrc/lj_cluster_ilist.cu and csrc/eam_cluster.cu).

- `ops/lj_cluster.ilist_sweep_counts` (listed and inside pairs, sweep B's
  warp iterations, the lane steps of both sweeps and of the earlier
  branch) equals a brute-force count, flat and over capacity buckets
  (with a truncating bucket and dummy units), share 1, 2 and 4.
- The mirrors of the new per-lane sum (`lj_cluster_force_sweep`,
  `eam_sweep_ref`: only the pairs sweep A marks, added one at a time in
  list order) against mdbench_tpu's Pallas kernels in interpret mode:
  the LJ force untyped and typed, flat and per bucket, and the EAM
  density and force. Tolerances are relative to max |value|: 1e-5 in
  float32, 1e-12 in float64 (only the summation order differs).
- On chip_smoke.boundary_ilist_case (pairs exactly at the cutoff and one
  ulp inside, padding at 1e30, coinciding padding, NaN rows, an empty
  list, a unit with no pair inside, a tile with every pair inside, a unit
  whose pairs inside lie in one chunk) sweep A marks exactly the plain
  twin's pair set, and the mirror's forces equal the plain twin's.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import boundary_ilist_case, hand_plan, random_case, random_tables
from mdbench_tpu.config import FF_EAM
from mdbench_tpu.config import Params as JParams
from mdbench_tpu.engine_cluster import ClusterSimulation as JSim
from mdbench_tpu.models import eam_tables as jtab
from mdbench_tpu.models.lattice import create_fcc_lattice
from mdbench_tpu.ops.eam import EamDevice as JEamDevice
from mdbench_tpu.ops.pallas.eam_cluster import eam_cluster_force_pallas
from mdbench_tpu.ops.pallas.lj_cluster import lj_cluster_force_ilist_pallas
from mdbench_tpu_torch.convert import tables_from_numpy
from mdbench_tpu_torch.ops import eam_cluster as tec
from mdbench_tpu_torch.ops import lj_cluster as tlj
from mdbench_tpu_torch.ops.cluster import bucket_maps_core
from test_torch_eam import _identity_eam

torch.set_num_threads(1)

CUT2, SIG6, EPS = 2.5**2, 1.0, 1.0
TOL = {np.float64: 1e-12, np.float32: 1e-5}
T_OF = {np.float32: torch.float32, np.float64: torch.float64}


def _rel(a, b):
    a = np.stack([np.asarray(t, np.float64) for t in a])
    b = np.stack([np.asarray(t, np.float64) for t in b])
    assert np.isfinite(a).all() and np.isfinite(b).all()
    return np.abs(a - b).max() / np.abs(b).max()


def _brute_counts(planes, ijl, units, n, share, cut, chunk):
    """The sweep counts by loops over rows, lanes and chunks, numpy rsq in
    the planes' dtype in the kernels' order."""
    x, y, z = planes
    tpu = share * 8
    nrow, icap = ijl.shape
    bits = np.zeros((nrow, tpu, -(-icap * 16 // chunk)), np.int64)
    hit = np.zeros((nrow, icap * 16), bool)
    for s in range(nrow):
        u = max(units[s], 0)
        ids = (ijl[s, : n[s]].astype(np.int64)[:, None] * 16 + np.arange(16)).reshape(-1)
        for i in range(tpu):
            a = u * tpu + i
            xi, yi, zi = x.reshape(-1)[a], y.reshape(-1)[a], z.reshape(-1)[a]
            dx, dy, dz = xi - x.reshape(-1)[ids], yi - y.reshape(-1)[ids], zi - z.reshape(-1)[ids]
            with np.errstate(over="ignore", invalid="ignore"):
                rsq = (dx * dx + dy * dy) + dz * dz
            inside = (rsq < x.dtype.type(cut)) & (rsq > 0)
            for e in np.flatnonzero(inside):
                bits[s, i, e // chunk] += 1
                hit[s, e] = True
    per = max(32 // tpu, 1)
    warp_b = warp_a = branch = 0
    for w0 in range(0, nrow, per):
        rows = slice(w0, w0 + per)
        warp_b += int(bits[rows].reshape(-1, bits.shape[2]).max(0).sum())
        warp_a += -(-int(n[rows].max()) * 16 // chunk) * chunk
        branch += int(hit[rows].any(0).sum())
    return dict(listed=n * 16 * tpu, inside=bits.sum((1, 2)),
                sweep_b=bits.max(1).sum(1), warp_sweep_a=warp_a,
                warp_sweep_b=warp_b, warp_branch=branch)


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("form", ["flat", "bucketed"])
@pytest.mark.parametrize("share", [1, 2, 4])
def test_sweep_counts_match_brute_force(share, form, chunk):
    xc, yc, zc, ijl, nji, npad = random_case(torch, share, share, torch.float32, "cpu",
                                             cjn=96, icap=12)
    buckets = None
    if form == "bucketed":
        plan = hand_plan(nji.numpy(), ijl.shape[1], trunc=True)
        ijl, bcrows, _, _ = bucket_maps_core(ijl, nji, npad, share, xc.shape[0], *plan)
        buckets = (plan, bcrows)
    units, n = tlj.ilist_rows(ijl, nji, share, buckets)
    if form == "bucketed":  # a dummy unit and a truncated list are counted
        assert (units < 0).any() and (n < nji[units.clamp(min=0)].clamp(max=12)).any()
    got = tlj.ilist_sweep_counts(xc, yc, zc, ijl, nji, share, CUT2, chunk=chunk,
                                 buckets=buckets)
    want = _brute_counts([p.numpy() for p in (xc, yc, zc)], ijl.numpy(), units.numpy(),
                         n.numpy(), share, CUT2, chunk)
    assert int(got["inside"].sum()) > 0
    for key, val in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), val, err_msg=key)
    assert got["efficiency"] == pytest.approx(
        int(want["inside"].sum()) / (32 * want["warp_sweep_b"]))
    assert 0 < got["efficiency"] <= 1


@functools.lru_cache(maxsize=None)
def _jax_case(ntypes, nx=6):
    """mdbench_tpu's planes and exact lists of a jittered nx^3 box (with
    two random types and non-uniform tables for ntypes=2), numpy, and
    its tables (static and as arrays)."""
    p = JParams(nx=nx, ny=nx, nz=nx, precision="dp", scheme="cluster", ntypes=ntypes)
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    kw = {}
    if ntypes > 1:
        kw = dict(types=np.random.default_rng(6).integers(0, 2, x.shape[0]).astype(np.int32),
                  tables=random_tables(4, 2))
    sim = JSim(p, x=x, v=v, **kw)
    st = jax.jit(sim.initial_state)()
    cl = {k: np.asarray(getattr(st.clusters, k)) for k in ("xc", "yc", "zc")}
    tc = None if ntypes == 1 else np.asarray(st.clusters.tc)
    return (cl, tc, np.asarray(st.pairs.ijlist), np.asarray(st.pairs.nji),
            sim.n_clusters_pad, sim.ishare, getattr(sim, "_tables_static", None),
            getattr(sim, "type_tables", None))


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_lj_mirror_matches_pallas(np_dtype, typed):
    """The mirror against the Pallas kernel in interpret mode, untyped
    and typed."""
    cl, tc, ijl, nji, npad, share, static, tables = _jax_case(2 if typed else 1)
    jp = [jnp.asarray(cl[k].astype(np_dtype)) for k in ("xc", "yc", "zc")]
    tp = [torch.tensor(cl[k].astype(np_dtype)) for k in ("xc", "yc", "zc")]
    kw_j, kw_t = {}, {}
    if typed:
        kw_j = dict(tc=jnp.asarray(tc.astype(np.float32)), tables=static)
        kw_t = dict(tc=torch.tensor(tc.astype(np.int32)),
                    tables=tables_from_numpy(tables, "cpu", torch.float64))
    f_j = lj_cluster_force_ilist_pallas(*jp, jnp.asarray(ijl), npad, CUT2, SIG6, EPS,
                                        share=share, interpret=True, **kw_j)
    f_t = tlj.lj_cluster_force_sweep(*tp, torch.tensor(ijl), torch.tensor(nji), npad,
                                     CUT2, SIG6, EPS, share=share, **kw_t)
    assert np.abs(np.asarray(f_j[0])).max() > 1e-3
    assert _rel(f_t, f_j) <= TOL[np_dtype]


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_lj_mirror_bucketed_matches_pallas_per_bucket(np_dtype):
    """Bucketed (hand plan with a zero tier, dummy units and a truncating
    bucket): the mirror over the bucket maps against the Pallas kernel
    called once per bucket on the permuted i-planes, then the inverse
    gather (mdbench_tpu's _force_buckets)."""
    cl, _, ijl, nji, npad, share, _, _ = _jax_case(1, 8)
    tp = [torch.tensor(cl[k].astype(np_dtype)) for k in ("xc", "yc", "zc")]
    sizes, caps = hand_plan(nji, ijl.shape[1], gran=64)
    plan = sizes, (0, caps[1] - 8, caps[2])  # Pallas takes caps in steps of 8
    bij, bcr, binv, bovf = bucket_maps_core(torch.tensor(ijl), torch.tensor(nji), npad,
                                            share, tp[0].shape[0], *plan)
    assert bool(bovf) and plan[1][0] == 0
    jp = [jnp.asarray(cl[k].astype(np_dtype)) for k in ("xc", "yc", "zc")]
    rows = bcr.numpy()
    parts, off = [], 0
    for n_k, c_k in zip(*plan):
        r0, r1 = off * share, (off + n_k) * share
        lists = jnp.asarray(bij.numpy()[off : off + n_k, :c_k])
        xi = tuple(jnp.asarray(np.asarray(p)[rows[r0:r1]]) for p in jp)
        if c_k == 0:
            parts.append([jnp.zeros((r1 - r0, 8), np_dtype)] * 3)
        else:
            parts.append(lj_cluster_force_ilist_pallas(*jp, lists, r1 - r0, CUT2, SIG6, EPS,
                                                       share=share, interpret=True, xi=xi))
        off += n_k
    inv = binv.numpy()
    f_j = [np.concatenate([np.asarray(f) for f in fs])[inv] for fs in zip(*parts)]
    f_t = tlj.lj_cluster_force_sweep(*tp, bij, torch.tensor(nji), npad, CUT2, SIG6, EPS,
                                     share=share, buckets=(plan, bcr))
    assert np.abs(f_j[0]).max() > 1e-3
    assert _rel(f_t, f_j) <= TOL[np_dtype]


@pytest.fixture(scope="module")
def eam_case(tmp_path_factory):
    from chip_smoke import write_standin_funcfl

    path = str(tmp_path_factory.mktemp("eam") / "standin.eam")
    write_standin_funcfl(path)
    kw = dict(nx=4, ny=4, nz=4, scheme="cluster", precision="dp", force_field=FF_EAM,
              eam_file=path)
    tables = jtab.load_eam(path)
    x, v, _ = create_fcc_lattice(jtab.apply_eam_overrides(JParams(**kw), tables))
    x = x + np.random.default_rng(3).normal(0.0, 0.15, x.shape)
    sim = JSim(JParams(**kw), x=x, v=v)
    st = sim.initial_state()
    cl = {k: np.asarray(getattr(st.clusters, k)) for k in ("xc", "yc", "zc")}
    return (cl, np.asarray(st.pairs.ijlist), np.asarray(st.pairs.nji),
            np.asarray(st.halo.border_map), sim.n_clusters_pad, sim.ishare,
            sim.eam_tables, sim.eam_poly)


def test_eam_mirror_matches_pallas(eam_case):
    """Density and force of the mirror against mdbench_tpu's Pallas EAM
    passes in interpret mode, float32: the density read out through an
    identity frho spline, the force on the Pallas run's own fp plane."""
    cl, ijl, nji, border_map, npad, share, tables, poly = eam_case
    cut2 = tables.cut**2
    jargs = (*[jnp.asarray(cl[k].astype(np.float32)) for k in ("xc", "yc", "zc")],
             jnp.asarray(ijl), jnp.asarray(border_map), npad, cut2)
    tp = [torch.tensor(cl[k].astype(np.float32)) for k in ("xc", "yc", "zc")]
    lists = (torch.tensor(ijl), torch.tensor(nji), npad, cut2, poly)
    *_, rho_j = eam_cluster_force_pallas(*jargs, _identity_eam(np.float32), poly,
                                         share=share, interpret=True)
    (rho_t,) = tec.eam_sweep_ref(*tp, *lists, share=share)
    assert float(rho_t.abs().max()) > 0.01
    assert _rel([rho_t], [np.asarray(rho_j)[:npad]]) <= TOL[np.float32]
    *f_j, fp_j = eam_cluster_force_pallas(*jargs, JEamDevice.from_tables(
        tables, np.float32), poly, share=share, interpret=True)
    f_t = tec.eam_sweep_ref(*tp, *lists, share=share,
                            fp_plane=torch.tensor(np.asarray(fp_j)))
    assert np.abs(np.asarray(f_j[0])).max() > 1e-3
    assert _rel(f_t, f_j) <= TOL[np.float32]


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("share", [1, 2, 4])
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_sweep_edge_cases(np_dtype, share, nan):
    """chip_smoke.boundary_ilist_case: sweep A marks exactly the plain
    twin's pair set (0 < rsq < cutforcesq on rsq in the kernels' order;
    NaN rows mark nothing), the mirror's LJ force and EAM density equal
    the plain twins' on the same rows as padding, and the units without
    a pair inside get exactly 0."""
    planes, ijl, nji, npad = boundary_ilist_case(np_dtype, share, nan)
    ref = boundary_ilist_case(np_dtype, share, nan=False)[0]
    tp = [torch.tensor(q) for q in planes]
    tr = [torch.tensor(q) for q in ref]
    ijl, nji = torch.tensor(ijl), torch.tensor(nji)
    units, n = tlj.ilist_rows(ijl, nji, share)
    sp = tlj.ilist_sweep_pairs(*tp, ijl, units, n, share, CUT2, slice(None))
    rsq = sp.rsq
    with np.errstate(invalid="ignore"):
        want = (rsq < CUT2) & (rsq > 0) & ~torch.isnan(rsq)
    listed = (torch.arange(ijl.shape[1] * 16) < (n * 16)[:, None])[:, None, :]
    assert torch.equal(sp.inside, want & listed)
    if share == 2:
        # unit 0 (rows 0-1): 4 pairs exactly at the cutoff, out; 4 one ulp
        # inside; every pair inside in one chunk
        at_cut = (rsq[0] == CUT2).sum()
        assert int(at_cut) == 4 and not sp.inside[0][rsq[0] == CUT2].any()
        for chunk in (64, tlj.SWEEP_CHUNK):
            chunks = sp.inside[0].reshape(16, -1, chunk).any(2).any(0)
            assert int(chunks.sum()) == 1
        # unit 1 (rows 2-3): its first tile (32 j16) has every pair inside
        assert bool(sp.inside[1, :, : 32 * 16].all())
    f_m = tlj.lj_cluster_force_sweep(*tp, ijl, nji, npad, CUT2, SIG6, EPS, share=share)
    f_r = tlj.lj_cluster_force_ilist_ref(*tr, ijl, npad, CUT2, SIG6, EPS, share=share)
    for rows in (slice(0, 2), slice(0, npad)):  # row 0's small force too
        assert _rel([f[rows] for f in f_m], [f[rows] for f in f_r]) <= TOL[np_dtype]
    for f in f_m:
        assert (f[4:] == 0).all()  # rows 4-7: no pair inside, or no list
    poly = _standin_poly()
    (rho_m,) = tec.eam_sweep_ref(*tp, ijl, nji, npad, CUT2, poly, share=share)
    rho_r = tec.eam_rho_ilist_ref(*tr, ijl, npad, CUT2, poly, share=share)
    assert _rel([rho_m], [rho_r]) <= TOL[np_dtype] and (rho_m[4:] == 0).all()


@functools.lru_cache(maxsize=None)
def _standin_poly():
    import tempfile
    from pathlib import Path

    from chip_smoke import write_standin_funcfl
    from mdbench_tpu_torch.models.eam_tables import fit_eam_poly, load_eam

    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "standin.eam")
        write_standin_funcfl(path)
        return fit_eam_poly(load_eam(path))


def test_design_code_and_probe_import_no_jax():
    """The mirrors, the counts and probes/ilist.py's calls (on a 4^3 CPU
    box with a hand-set plan, LJ and EAM) in a process that never imports
    jax or mdbench_tpu; on the CPU the flat and bucketed calls give the
    same bits."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, tempfile, torch\n"
        "from chip_smoke import hand_plan, write_standin_funcfl\n"
        "from mdbench_tpu_torch.config import FF_EAM, Params\n"
        "from mdbench_tpu_torch.engine_cluster import ClusterSimulation\n"
        "from mdbench_tpu_torch.probes import ilist as probe\n"
        "d = tempfile.mkdtemp()\n"
        "write_standin_funcfl(d + '/s.eam')\n"
        "for kw in ({}, {'force_field': FF_EAM, 'eam_file': d + '/s.eam'}):\n"
        "    p = Params(nx=4, ny=4, nz=4, scheme='cluster', **kw)\n"
        "    sim = ClusterSimulation(p, device='cpu')\n"
        "    sim.buckets = hand_plan(sim.initial_state().pairs.nji.numpy(), sim.icap)\n"
        "    st = sim.initial_state()\n"
        "    calls = (probe.eam_calls if kw else probe.lj_calls)(sim, st, torch.float32)\n"
        "    bits = {k: probe.bits(fn()) for k, fn in calls.items()}\n"
        "    for k in ('K1', 'K2', 'K3'):\n"
        "        assert k not in bits or bits[k] == bits[k + 'b'], bits\n"
        "    assert 'efficiency' in probe.sweep_line('x', sim, st, p.cutforce**2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mdbench_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
