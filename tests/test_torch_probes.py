"""The port's probes (mdbench_tpu_torch/probes: the bf16 force of
tools/r3_bf16.py and the list-driven row fetch of tools/r4_dma.py) and the
approximate reciprocal of the exact-list kernels, on the CPU.

- The bf16 plain twin against the tool's Pallas kernel in interpret mode,
  compiled with XLA's excess precision off, so that every bfloat16
  operation rounds as it does in the twin: within 1e-6 of max |f| (the
  sums run in another order). With XLA's default the CPU keeps excess
  precision between bfloat16 operations, and the two differ by more.
- The bf16 force against the exact float32 force in the tool's metric.
- ceil_bf16, the bf16 kernel's cutoff: over every bfloat16 value it
  selects the pairs of the float32 test; probes.bf16.edge_case, the
  kernel's edge lists on the card, tells a wrong pair set apart.
- The row fetch's plain twin against the XLA row gather t[idx], bit for
  bit, at the tool's shapes.
- approx_rcp: the CPU wrappers equal mdbench_tpu's kernel in interpret
  mode with the flag (which it turns off there, as the twins ignore it),
  within 1e-5 of max |f|; the engine hands Params.approx_rcp to K1, K1t
  and K1b and not to K4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BF16_TOL, bf16_inside, hand_plan, random_tables
from mdbench_tpu.ops.pallas.lj_cluster import lj_cluster_force_ilist_pallas
from mdbench_tpu_torch import engine_cluster
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.convert import clusters_from_numpy, pairs_from_numpy
from mdbench_tpu_torch.engine_cluster import ClusterSimulation
from mdbench_tpu_torch.models.lattice import create_fcc_lattice
from mdbench_tpu_torch.ops import lj_cluster as tlj
from mdbench_tpu_torch.ops import row_fetch as trf
from mdbench_tpu_torch.probes import bf16 as probe
from mdbench_tpu_torch.probes import dma
from test_torch_cuda import synthetic_case
from test_torch_lj_cluster import CUT2, EPS, SIG6, TOL, _engine_case, _rel
from tools.r3_bf16 import make_bf16_kernel

torch.set_num_threads(1)

BF16_JAX_TOL = 1e-6  # the twin against the tool's kernel, of max |f|


@functools.lru_cache(maxsize=None)
def _sp_engine_case():
    """_engine_case (mdbench_tpu's jittered 6^3 box) with float32 planes."""
    cl, pairs, npad, share = _engine_case()
    planes = tuple(cl[k].astype(np.float32) for k in ("xc", "yc", "zc"))
    return planes, pairs["ijlist"], npad, share


@pytest.mark.parametrize("excess_precision", [False, True])
def test_bf16_twin_matches_jax_probe(excess_precision):
    planes, ijl, npad, share = _sp_engine_case()
    f_t = tlj.lj_cluster_force_ilist_bf16_ref(
        *map(torch.tensor, planes), torch.tensor(ijl), npad, CUT2, SIG6, EPS,
        share=share)
    force_bf16 = make_bf16_kernel()

    def f(x, y, z, lists):
        return force_bf16(x, y, z, lists, npad, CUT2, SIG6, EPS, share=share,
                          interpret=True)

    args = [jnp.asarray(p) for p in planes] + [jnp.asarray(ijl)]
    lowered = jax.jit(f).lower(*args)
    if excess_precision:  # XLA's default on the CPU
        compiled = lowered.compile()
    else:
        compiled = lowered.compile(
            compiler_options={"xla_allow_excess_precision": False})
    f_j = compiled(*args)
    assert np.abs(np.asarray(f_j[0])).max() > 1.0  # forces are not trivial
    rel = _rel(f_t, f_j)
    if excess_precision:
        assert rel > BF16_JAX_TOL
    else:
        assert rel <= BF16_JAX_TOL


def _sp_sim(**kw):
    """The port's jittered 6^3 SP box on the CPU (the lattice and jitter of
    _engine_case)."""
    p = Params(nx=6, ny=6, nz=6, precision="sp", scheme="cluster", **kw)
    x, v, _ = create_fcc_lattice(p)
    x = x + np.random.default_rng(5).normal(0.0, 0.05, x.shape)
    return ClusterSimulation(p, x=x, v=v, device="cpu")


def test_bf16_force_error_against_exact():
    """The probe's metric (per-atom error over the median nonzero |f|):
    bfloat16 rounding of each pair term leaves an error of a few percent
    of a typical force on average; a twin that ran in float32 would give
    ~1e-7 and fail the lower limit."""
    sim = _sp_sim()
    mx, mean = probe.force_error(sim, sim.initial_state())
    assert 1e-3 < mean < 1e-1
    assert mean < mx < 10.0


@pytest.mark.parametrize("c", [6.25, 6.3001, 1e-3, 1e30, 6.29])
def test_ceil_bf16_selects_the_pairs_of_the_float32_test(c):
    """The bf16 kernel's sweep A compares rsq, a bfloat16 value, against
    ceil_bf16(cutforcesq) in bfloat16. Over all 65,536 bfloat16 bit
    patterns r (zeros, subnormals, negatives, inf and NaN included), r <
    float32(c) holds exactly where r < ceil_bf16(c), for c representable
    in bfloat16 (6.25) and not (6.3001, cutoff 2.51; 1e-3; 1e30); the
    bound is the smallest bfloat16 value >= c. For c = 6.29 the nearest
    bfloat16 value (6.28125) lies below c and would drop a value."""
    r = (np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)).view(np.float32)
    c32, cb = np.float32(c), np.float32(tlj.ceil_bf16(c))
    assert int(cb.view(np.uint32)) & 0xFFFF == 0 and cb >= c32
    assert not ((r >= c32) & (r < cb)).any()  # no bfloat16 value in [c, cb)
    assert np.array_equal(r < c32, r < cb)
    nearest = np.float32(torch.tensor(c32).to(torch.bfloat16).float().item())
    assert np.array_equal(r < c32, r < nearest) == (nearest >= c32)
    if c == 6.29:
        assert nearest < c32


@pytest.mark.parametrize("share", [1, 2, 4])
def test_bf16_edge_case_tells_the_pair_sets_apart(share):
    """probes.bf16.edge_case, the bf16 kernel's edge lists on the card
    (tests/test_torch_cuda.py, chip_smoke.py phase 25): the all-padding
    unit's rows are 0; lanes hold odd and even inside counts and none; no
    list is a whole number of 128-atom chunks; and the bf16 force moves
    by over 100 BF16_TOL of max |f| when the cutoff drops the pairs at
    rsq 6.28125 (cutforcesq 6.28125) or takes those at 6.3125 (6.3126),
    so a kernel with a wrong pair set on either side of 6.3001 cannot
    meet BF16_TOL."""
    case = probe.edge_case(share, "cpu")
    f = torch.stack(probe.edge_force(case))
    assert (f[:, share:2 * share] == 0).all()
    assert ((case["nji"] * 16) % 128 != 0).all()
    planes = tuple(case[k] for k in ("xc", "yc", "zc"))
    args = (planes, case["ijlist"], case["n_clusters_pad"])

    def inside(cut):
        return bf16_inside(torch, *args, cut, share)

    lanes = inside(case["cutforcesq"])
    assert (lanes % 2 == 1).any() and (lanes % 2 == 0).any() and (lanes == 0).any()
    for cut in (6.28125, 6.3126):
        assert inside(cut).sum() != lanes.sum()  # boundary pairs on both sides
        moved = torch.stack(probe.edge_force(dict(case, cutforcesq=cut))) - f
        assert float(moved.abs().max()) > 100 * BF16_TOL * float(f.abs().max())


def test_bf16_twin_takes_float32_only():
    planes, ijl, npad, share = _sp_engine_case()
    with pytest.raises(TypeError):
        tlj.lj_cluster_force_ilist_bf16_ref(
            *(torch.tensor(p).double() for p in planes), torch.tensor(ijl), npad,
            CUT2, SIG6, EPS, share=share)


def test_bf16_simulation_runs_the_bf16_force():
    """Bf16Simulation plans no buckets and its forces are the bf16 force of
    its own lists; it refuses the group-window path and typed runs."""
    p = Params(nx=6, ny=6, nz=6, precision="sp", scheme="cluster")
    sim = probe.Bf16Simulation(p, device="cpu")
    st = sim.initial_state()
    sim._calibrate_list_cap(st)
    assert sim.buckets is None
    cl, pr = st.clusters, st.pairs
    want = tlj.lj_cluster_force_ilist_bf16_ref(
        cl.xc, cl.yc, cl.zc, pr.ijlist, sim.n_clusters_pad, CUT2, SIG6, EPS,
        share=sim.ishare)
    for a, b in zip((st.fxc, st.fyc, st.fzc), want):
        assert torch.equal(a, b)
    for kw in ({"kernel": "pallas"}, {"ntypes": 2}):
        with pytest.raises(ValueError):
            probe.Bf16Simulation(Params(nx=4, ny=4, nz=4, precision="sp",
                                        scheme="cluster", **kw), device="cpu")


def test_bf16_golden_run_reports_a_failed_gate():
    """A run that misses the golden trace (here a 4^3 box, not the 131k
    workload) is the probe's finding: a FAIL verdict, not an exception."""
    sim, out, passed, verdict = probe.golden_run("cpu", nx=4, ny=4, nz=4, ntimes=20)
    assert not passed and verdict.startswith("FAIL - GOLDEN GATE FAILED at step 20")
    assert out.temps.shape == (20,) and np.isfinite(out.temps).all()
    lines = probe.golden_lines(sim, out, verdict)
    assert lines[0].startswith("bf16 GOLDEN GATE: FAIL") and len(lines) == 2


def test_dma_inputs_are_the_tools():
    """probes.dma draws tools/r4_dma.py's table and ids (default_rng(0),
    in its order)."""
    rng = np.random.default_rng(0)
    table = np.asarray(rng.standard_normal((8192, 128)), np.float32)
    idx = rng.integers(0, 8192, size=(65536,)).astype(np.int32)
    idx8 = rng.integers(0, 1024, size=(8192,)).astype(np.int32)
    got = dma.make_inputs("cpu")
    for a, b in zip(got, (table, idx, idx8)):
        assert a.dtype in (torch.float32, torch.int32)
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("mode", trf.MODES)
@pytest.mark.parametrize("rows_per_id", [1, 8])
def test_row_fetch_matches_xla_gather(rows_per_id, mode):
    """The row fetch (its plain twin on the CPU) against jnp's row gather at
    the tool's shapes, bit for bit. The tool's Pallas kernels dma1/dma8
    are local to its main() and cannot be imported; each writes every
    fetched row or block to one constant output block, so it returns the
    last one: the last row or block of this output."""
    table, idx, idx8 = dma.make_inputs("cpu")
    ids = idx if rows_per_id == 1 else idx8
    got = trf.row_fetch(table, ids, rows_per_id, mode)
    t = jnp.asarray(table.numpy())
    if rows_per_id == 1:
        want = t[jnp.asarray(ids.numpy())]
        last = t[int(ids[-1])][None, :]  # dma1's (1, 128) output
    else:
        want = t.reshape(1024, 8, 128)[jnp.asarray(ids.numpy())].reshape(-1, 128)
        b = int(ids[-1])
        last = t[8 * b : 8 * b + 8]  # dma8's (8, 128) output
    assert got.shape == (65536, 128)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got[-rows_per_id:].numpy(), np.asarray(last))
    assert sum(trf.LAUNCHES.values()) == 0  # no kernel on the CPU


def test_dma_equality_check_names_every_variant():
    """equal_to_index_select (run before the timed launches, so that the
    launch counts hold the timing run alone) gives one verdict per
    variant; on the CPU every variant is index_select."""
    table, idx, idx8 = dma.make_inputs("cpu")
    assert dma.equal_to_index_select(table, idx[:100], idx8[:20]) == {
        name: True for name in trf.LAUNCHES}


@pytest.mark.parametrize("bad,exc", [
    (lambda t, i: (t.double(), i, 1, "cp_async"), TypeError),
    (lambda t, i: (t[:, :64], i, 1, "cp_async"), TypeError),
    (lambda t, i: (t, i.long(), 1, "tma"), TypeError),
    (lambda t, i: (t, i, 4, "tma"), ValueError),
    (lambda t, i: (t, i, 1, "ldg"), ValueError),
    (lambda t, i: (t[:12], i, 8, "tma"), ValueError),
    (lambda t, i: (torch.empty(64 * 128 + 1)[1:].view(64, 128), i, 1, "tma"),
     ValueError),
])
def test_row_fetch_argument_checks(bad, exc):
    table = torch.zeros((64, 128))
    ids = torch.zeros(5, dtype=torch.int32)
    trf.row_fetch(table, ids)  # the good arguments pass
    with pytest.raises(exc):
        trf.row_fetch(*bad(table, ids))


@pytest.mark.parametrize("name", ["engine", "synthetic"])
def test_approx_rcp_on_cpu_matches_interpret_mode(name):
    """On the CPU the flag changes nothing, as in mdbench_tpu's interpret
    mode: both sides divide."""
    cl, pairs, npad, share = _engine_case() if name == "engine" else synthetic_case()
    c = clusters_from_numpy(cl, "cpu", torch.float32)
    pr = pairs_from_numpy(pairs, "cpu")
    f_t = tlj.lj_cluster_force_ilist(c.xc, c.yc, c.zc, pr.ijlist, pr.nji, npad, CUT2,
                                     SIG6, EPS, share=share, approx_rcp=True)
    jp = [jnp.asarray(cl[k].astype(np.float32)) for k in ("xc", "yc", "zc")]
    f_p = lj_cluster_force_ilist_pallas(*jp, jnp.asarray(pairs["ijlist"]), npad, CUT2,
                                        SIG6, EPS, share=share, interpret=True,
                                        approx_rcp=True)
    assert _rel(f_t, f_p) <= TOL[np.float32]
    exact = tlj.lj_cluster_force_ilist(c.xc, c.yc, c.zc, pr.ijlist, pr.nji, npad, CUT2,
                                       SIG6, EPS, share=share)
    assert all(torch.equal(a, b) for a, b in zip(f_t, exact))


@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("path", ["K1", "K1t", "K1b", "K4"])
def test_engine_hands_approx_rcp_to_the_exact_list_kernels(monkeypatch, path, approx):
    """A spy on the engine's force calls: K1, K1t and K1b get
    approx_rcp=Params.approx_rcp, K4 gets no approx_rcp."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, kw))
            return fn(*args, **kw)
        monkeypatch.setattr(engine_cluster, name, wrapped)

    for name in ("lj_cluster_force_ilist", "lj_cluster_force_buckets",
                 "lj_cluster_force_stream"):
        spy(name, getattr(engine_cluster, name))
    p = Params(nx=4, ny=4, nz=4, precision="sp", scheme="cluster", approx_rcp=approx,
               kernel="pallas" if path == "K4" else "auto")
    x, v, _ = create_fcc_lattice(p)
    kw = {}
    if path == "K1t":
        kw = dict(types=np.random.default_rng(6).integers(0, 2, x.shape[0]).astype(
            np.int32), tables=random_tables(4, 2))
    sim = ClusterSimulation(p, x=x, v=v, device="cpu", **kw)
    st = sim.initial_state()
    if path == "K1b":
        sim.buckets = hand_plan(st.pairs.nji.numpy(), sim.icap)
        calls.clear()
        sim.initial_state()
    name, kwargs = calls[-1]
    want = {"K1": "lj_cluster_force_ilist", "K1t": "lj_cluster_force_ilist",
            "K1b": "lj_cluster_force_buckets", "K4": "lj_cluster_force_stream"}[path]
    assert name == want
    assert (kwargs.get("tables") is not None) == (path == "K1t")
    if path == "K4":
        assert "approx_rcp" not in kwargs
    else:
        assert kwargs["approx_rcp"] is approx


def test_eam_verlet_probe_set_up_imports_no_jax():
    """probes/eam_verlet.py's calls on a 4^3 CPU verlet EAM box (the
    wrappers' plain versions on the CPU), float32 and float64, poly and
    spline, in a process that never imports jax or mdbench_tpu: each
    kernel's outputs are its plain version's bits, and the bounds of the
    lists count their listed pairs."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, torch\n"
        "import chip_smoke\n"
        "from mdbench_tpu_torch.probes import eam_verlet as probe\n"
        "sim = probe.eam_sim('cpu', nx=4, ny=4, nz=4, ntimes=4, reneigh_every=2,\n"
        "                    eam_eval='poly')\n"
        "st = sim.run(repeats=0).state\n"
        "for dtype in (torch.float32, torch.float64):\n"
        "    for form in probe.FORMS:\n"
        "        calls = probe.eam_calls(sim, st.x, st.nlist, st.halo.border_map, dtype,\n"
        "                                form)\n"
        "        for kid in probe.NAMES:\n"
        "            assert probe.bits(calls[kid]()) == probe.bits(calls['plain ' + kid]())\n"
        "        b5, b6, _, listed, inside = chip_smoke.eam_verlet_bounds(\n"
        "            torch, sim, st, dtype, form == 'poly')\n"
        "        valid = (torch.arange(st.nlist.neighbors.shape[1])[None, :]\n"
        "                 < st.nlist.numneigh[:, None])\n"
        "        assert listed == int(valid.sum()) > inside > 0\n"
        "        assert b5[1] == b6[1] == 'bytes'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mdbench_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")

