"""The verlet ranges build's candidate stage (ops/verlet._range_candidates)
on the CPU.

Its plain version, `range_candidates_ref`, is held to a numpy oracle, unit
by unit, on the edge cases that the card's kernel (csrc/verlet_ranges.cu)
must match (chip_smoke.ranges_edge_cases): padding atoms and units without
a real atom, columns on the grid's margin, overlapping and duplicate
ranges, more columns than ucol, more ranges than kcap, a ccap that is no
multiple of 32 and one that a unit's union meets exactly or passes by
one, no ghost block, and a NaN coordinate. Also: on a CPU tensor the
wrapper is the plain version (no launch) and on a device other than CUDA
it raises, its operand checks refuse what the kernel does not take, and
the plain stage composed with the exact prune gives
derive_rowlists_from_ranges's rows, stats and overflow flag. The card
tests are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from chip_smoke import ranges_edge_cases, ranges_tensors
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.ops import verlet
from mdbench_tpu_torch.ops.cells import coord_to_bin

torch.set_num_threads(1)

DTYPES = {"float32": np.float32, "float64": np.float64}
CASES = ("random", "ucol", "kcap", "narrow", "gcap0", "nan")


def candidates_oracle(case: dict) -> dict:
    """The candidate stage in numpy, unit by unit, from the bins of
    coord_to_bin: each real atom's column bin // d2 and z bin % d2 (a bin
    at or past COL_BIG is none), the first ucol columns ascending; the
    unit's xy bbox in x's dtype (FBIG / -FBIG without a real atom, NaN
    propagating); per column and stencil offset the clamped stencil
    column, the xy gap test in x's dtype, op by op; the local and ghost
    16-row ranges of its z window; the first kcap by start (stable), the
    union's first ccap ids. Returns cand, total, n_dc, nk, and counts of
    what the case holds: duplicate and overlapping range pairs, stencil
    columns clamped into the grid."""
    grid, xt, nlocal, npad, gcap, cutneigh, ucol, kcap, ccap = ranges_tensors(
        torch, case, "cpu")
    x = case["x"]
    t = x.dtype.type
    bins = coord_to_bin(grid, xt[: npad + gcap]).numpy()
    d0, d1, d2 = grid.dims
    ncols = d0 * d1
    q = np.arange(grid.nbins + 1)
    starts = (np.searchsorted(bins[:nlocal], q), np.searchsorted(bins[npad:], q))
    bs0, bs1, cutsq = t(grid.binsize[0]), t(grid.binsize[1]), t(cutneigh * cutneigh)
    nu, sent16 = npad // 16, x.shape[0] // 16 - 1
    out = dict(cand=np.full((nu, ccap), sent16, np.int64), total=np.zeros(nu, np.int64),
               n_dc=np.zeros(nu, np.int64), nk=np.zeros(nu, np.int64), dup=0, overlap=0,
               clamped=0)

    def gap(b, lo, hi, bs):
        with np.errstate(invalid="ignore", over="ignore"):
            g = np.maximum(t(t(t(b - t(1)) * bs) - hi), t(lo - t(b * bs)))
            return np.maximum(g, t(0))

    for u in range(nu):
        real = np.arange(16 * u, 16 * u + 16) < nlocal
        xs = x[16 * u : 16 * u + 16][real]
        b = bins[16 * u : 16 * u + 16][real]
        b = b[b < verlet.COL_BIG]
        cols = sorted(set((b // d2).tolist()))
        out["n_dc"][u] = len(cols)
        lo = [xs[:, k].min() if len(xs) else t(verlet.FBIG) for k in range(2)]
        hi = [xs[:, k].max() if len(xs) else t(-verlet.FBIG) for k in range(2)]
        ranges = []
        for blk, base in ((0, 0), (1, nu)):
            for c in cols[:ucol]:
                zs = b[b // d2 == c] % d2
                z0, z1 = max(zs.min() - 1, 0), min(zs.max() + 1, d2 - 1)
                for a in range(9):
                    raw = c + (a // 3 - 1) * d1 + (a % 3 - 1)
                    cs = min(max(raw, 0), ncols)
                    out["clamped"] += cs != raw
                    if cs >= ncols:
                        continue
                    gx = gap(t(cs // d1), lo[0], hi[0], bs0)
                    gy = gap(t(cs % d1), lo[1], hi[1], bs1)
                    with np.errstate(invalid="ignore", over="ignore"):
                        if not t(t(gx * gx) + t(gy * gy)) <= cutsq:
                            continue
                    a0, a1 = starts[blk][cs * d2 + z0], starts[blk][cs * d2 + z1 + 1]
                    if a1 > a0:
                        ranges.append((base + (a0 >> 4), base + ((a1 - 1) >> 4) + 1))
        out["nk"][u] = len(ranges)
        for i, r in enumerate(ranges):
            for s in ranges[:i]:
                out["dup"] += r == s
                out["overlap"] += r != s and r[0] < s[1] and s[0] < r[1]
        kept = sorted(ranges, key=lambda r: r[0])[:kcap]
        union = sorted(set().union(*(range(a, b) for a, b in kept)))
        out["total"][u] = len(union)
        out["cand"][u, : min(len(union), ccap)] = union[:ccap]
    return out


def _ref(case: dict) -> dict:
    cand, total, n_dc, nk = verlet.range_candidates_ref(*ranges_tensors(torch, case, "cpu"))
    return dict(cand=cand.numpy(), total=total.numpy(), n_dc=n_dc.numpy(), nk=nk.numpy())


def _assert_matches_oracle(case: dict) -> dict:
    got, want = _ref(case), candidates_oracle(case)
    for name in ("n_dc", "nk"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # past kcap the ranges kept among equal starts are free
    sure = want["nk"] <= case["kcap"]
    np.testing.assert_array_equal(got["total"][sure], want["total"][sure])
    np.testing.assert_array_equal(got["cand"][sure], want["cand"][sure])
    return want


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_range_candidates_ref_matches_oracle(name, dtype):
    """range_candidates_ref against the oracle on every edge case, and
    each case holds what it is named for."""
    case = ranges_edge_cases(DTYPES[dtype])[name]
    want = _assert_matches_oracle(case)
    real_units = -(-case["nlocal"] // 16)
    assert case["nlocal"] % 16 and real_units < case["nlocal_pad"] // 16
    assert not want["nk"][real_units:].any() and not want["n_dc"][real_units:].any()
    ovf = {"ucol": want["n_dc"].max() > case["ucol"], "kcap": want["nk"].max() > case["kcap"],
           "ccap": want["total"].max() > case["ccap"]}
    assert ovf == {"ucol": name == "ucol", "kcap": name == "kcap", "ccap": name == "narrow"}
    if name == "random":
        assert want["dup"] > 0 and want["overlap"] > 0 and want["clamped"] > 0
    if name == "narrow":
        assert case["ccap"] % 32
    if name == "gcap0":
        sent16 = case["x"].shape[0] // 16 - 1
        assert case["gcap"] == 0
        assert ((want["cand"] < case["nlocal_pad"] // 16) | (want["cand"] == sent16)).all()
    if name == "nan":
        assert want["nk"][40] == 0 and want["n_dc"][40] > 0


@pytest.mark.parametrize("past", [0, 1])
def test_range_candidates_ref_total_at_ccap(past):
    """ccap exactly a unit's union, and one below it: the unit's total is
    ccap (its candidates fill every slot) or ccap + 1 (one cut off)."""
    case = ranges_edge_cases(np.float32)["random"]
    top = int(candidates_oracle(case)["total"].max())
    case = dict(case, ccap=top - past)
    want = _assert_matches_oracle(case)
    u = int(np.argmax(want["total"]))
    assert want["total"][u] == case["ccap"] + past
    assert (want["cand"][u] != case["x"].shape[0] // 16 - 1).all()


def test_range_candidates_cpu_is_ref():
    """On a CPU tensor _range_candidates is range_candidates_ref (no
    launch) with stats [max total, max n_dc, max nk, 0]."""
    case = ranges_edge_cases(np.float64)["random"]
    args = ranges_tensors(torch, case, "cpu")
    before = verlet.RANGES_LAUNCHES
    cand, total, n_dc, nk, stats = verlet._range_candidates(*args)
    assert verlet.RANGES_LAUNCHES == before
    want = verlet.range_candidates_ref(*args)
    for a, b in zip((cand, total, n_dc, nk), want):
        assert a.dtype == torch.int64 and torch.equal(a, b)
    assert stats.tolist() == [int(total.max()), int(n_dc.max()), int(nk.max()), 0]


def test_range_candidates_other_device_raises():
    args = ranges_tensors(torch, ranges_edge_cases(np.float32)["random"], "meta")
    with pytest.raises(ValueError, match="no ranges kernel"):
        verlet._range_candidates(*args)


def _operands(dtype=np.float32) -> dict:
    """The kernel's operands of the random case, as _range_candidates
    forms them on the card."""
    grid, x, nlocal, npad, gcap, _, ucol, kcap, ccap = ranges_tensors(
        torch, ranges_edge_cases(dtype)["random"], "cpu")
    bins = coord_to_bin(grid, x[: npad + gcap])
    q = torch.arange(grid.nbins + 1)
    return dict(x=x, bins=bins[:npad], starts_l=torch.searchsorted(bins[:nlocal], q),
                starts_g=torch.searchsorted(bins[npad:], q), nlocal=nlocal,
                nlocal_pad=npad, dims=grid.dims, ucol=ucol, kcap=kcap, ccap=ccap)


def _bad(args: dict, name: str) -> dict:
    """The random case's operands with one of them made unacceptable."""
    a = dict(args)
    if name == "x float16":
        a["x"] = a["x"].half()
    elif name == "x not (n, 3)":
        a["x"] = a["x"].reshape(-1, 6)
    elif name == "x strided":
        a["x"] = torch.cat([a["x"], a["x"]], 1)[:, ::2]
    elif name == "bins int32":
        a["bins"] = a["bins"].int()
    elif name == "bins shape":
        a["bins"] = a["bins"][:-16]
    elif name == "bins strided":
        a["bins"] = torch.stack([a["bins"], a["bins"]], 1)[:, 0]
    elif name == "starts_l float":
        a["starts_l"] = a["starts_l"].double()
    elif name == "starts_g shape":
        a["starts_g"] = a["starts_g"][1:]
    elif name == "starts_g device":
        a["starts_g"] = a["starts_g"].to("meta")
    elif name == "nlocal past nlocal_pad":
        a["nlocal"] = a["nlocal_pad"] + 1
    elif name == "nlocal_pad not of 16":
        a["nlocal_pad"] -= 8
    elif name == "kcap 0":
        a["kcap"] = 0
    elif name == "ccap negative":
        a["ccap"] = -8
    return a


@pytest.mark.parametrize("name", [
    "x float16", "x not (n, 3)", "x strided", "bins int32", "bins shape", "bins strided",
    "starts_l float", "starts_g shape", "starts_g device", "nlocal past nlocal_pad",
    "nlocal_pad not of 16", "kcap 0", "ccap negative"])
def test_ranges_checks_refuse(name):
    good = _operands()
    verlet._check_ranges_args(**good)
    verlet._check_ranges_args(**_operands(np.float64))
    with pytest.raises((TypeError, ValueError)):
        verlet._check_ranges_args(**_bad(good, name))


@pytest.fixture(scope="module")
def engine_state():
    """A jittered 6^3 SP rowlist box's t = 0 state on the CPU, with its
    engine (sorted atoms: the ranges build)."""
    p = Params(nx=6, ny=6, nz=6, precision="sp")
    sim = Simulation(p, device="cpu")
    x = sim.x0.clone()
    x[: sim.nlocal] += torch.from_numpy(
        np.random.default_rng(3).normal(0.0, 0.05, (sim.nlocal, 3))).to(x.dtype)
    x, _, halo, _, _ = sim._reneighbor(x, sim.types0)
    assert sim._rowbuild_ranges
    return sim, x


# caps with room over the state below (observed: 187 candidates, 4
# columns, 50 ranges, 138 rows a unit at most)
ROOM = {"ucol": 5, "kcap": 64, "ccap": 256, "rcap": 144}


@pytest.mark.parametrize("caps", [{}, {"rcap": 16}, {"ccap": 24}, {"ucol": 1},
                                  {"kcap": 8}])
def test_split_stage_gives_derive_rowlists_from_ranges(engine_state, caps):
    """The plain candidate stage, then the exact prune, with the overflow
    flag from the per-unit counts as the chunk loop formed it, gives
    derive_rowlists_from_ranges's rows, counts, stats and flag: with room
    over this state's need and with each cap below it."""
    sim, x = engine_state
    c = sim.caps
    kw = {**ROOM, **caps}
    rcap = kw.pop("rcap")
    rows, numrows, stats, ovf = verlet.derive_rowlists_from_ranges(
        sim.grid, x, sim.nlocal, c.nlocal_pad, c.ghost, rcap, sim.params.cutneigh, **kw)
    cand, total, n_dc, nk = verlet.range_candidates_ref(
        sim.grid, x, sim.nlocal, c.nlocal_pad, c.ghost, sim.params.cutneigh, **kw)
    validu = (torch.arange(c.nlocal_pad) < sim.nlocal).reshape(-1, 16)
    want_rows, want_n = verlet.exact_prune_ref(x, cand, c.nlocal_pad, validu,
                                               sim.params.cutneigh**2, rcap,
                                               x.shape[0] // 16 - 1)
    want_ovf = ((n_dc > kw["ucol"]).any() | (total > kw["ccap"]).any()
                | (nk > kw["kcap"]).any() | (want_n > rcap).any())
    assert torch.equal(rows, want_rows.to(torch.int32))
    assert torch.equal(numrows, want_n.to(torch.int32))
    assert stats.tolist() == [int(total.max()), int(n_dc.max()), int(nk.max()), 0]
    assert bool(ovf) == bool(want_ovf) == bool(caps)
