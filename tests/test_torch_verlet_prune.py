"""The verlet row lists' exact prune (ops/verlet._exact_prune) on the CPU.

Its plain version, `exact_prune_ref`, is held to a numpy oracle on the
edge cases that the card's kernel (csrc/verlet_prune.cu) must match bit
for bit (chip_smoke.prune_edge_cases): a pair at rsq == cutsq in each
dtype and one ulp either side, sentinel ids mid-list, padding and
all-padding units, NaN and inf coordinates, more kept rows than rcap
(with the full count), and lists wider than a warp's rounds. Also: the
wrapper takes the plain version on a CPU tensor and raises on any other
device but CUDA, its operand checks refuse what the kernel does not
take, and every caller (both row-list builds, the slab engine) hands it
operands that pass them. The card tests are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from chip_smoke import PRUNE_CUTSQ, prune_edge_cases, prune_tensors
from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.ops import verlet
from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation

torch.set_num_threads(1)

DTYPES = {"float32": np.float32, "float64": np.float64}
CASES = ("random", "overflow", "nan", "boundary", "wide")


def prune_oracle(case: dict) -> tuple:
    """The prune in numpy, unit by unit and candidate by candidate: rsq in
    x's dtype as (dx*dx + dy*dy) + dz*dz with d = x_i - x_j, padding
    i-atoms at FBIG, np.min (NaN if any is NaN), kept iff <= cutsq in x's
    dtype and not the sentinel id. Returns (rows, numrows) int64."""
    x, cand, validu = case["x"], case["cand"], case["validu"]
    t = x.dtype.type
    rcap, sent16 = case["rcap"], case["sent16"]
    blocks = x.reshape(-1, 16, 3)
    nu = cand.shape[0]
    rows = np.full((nu, rcap), sent16, np.int64)
    numrows = np.zeros(nu, np.int64)
    with np.errstate(invalid="ignore", over="ignore"):
        for u in range(nu):
            kept = []
            for c in cand[u]:
                if c == sent16:
                    continue
                d = blocks[u][:, None, :] - blocks[c][None, :, :]
                rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
                rsq = np.where(validu[u][:, None], rsq, t(verlet.FBIG))
                if np.min(rsq) <= t(case["cutsq"]):
                    kept.append(c)
            numrows[u] = len(kept)
            rows[u, : min(len(kept), rcap)] = kept[:rcap]
    return rows, numrows


def _ref(case: dict) -> tuple:
    return verlet.exact_prune_ref(*prune_tensors(torch, case, "cpu"))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prune_ref_matches_oracle(name, dtype):
    case = prune_edge_cases(DTYPES[dtype])[name]
    rows, numrows = _ref(case)
    want_rows, want_n = prune_oracle(case)
    assert rows.dtype == torch.int64 and numrows.dtype == torch.int64
    assert rows.shape == (case["cand"].shape[0], case["rcap"])
    np.testing.assert_array_equal(numrows.numpy(), want_n)
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    # every case keeps some rows and drops some
    assert 0 < int(numrows.sum()) < int((case["cand"] != case["sent16"]).sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_prune_boundary_verdicts(dtype):
    """rsq == cutsq (rounded to x's dtype) keeps the row, along x and y or
    y and z; one ulp longer drops it, one ulp shorter keeps it. In float32
    the rounded cutoff lies above the float64 one, so the pair at it is
    kept only because the comparison runs in x's dtype, as torch's does."""
    case = prune_edge_cases(DTYPES[dtype])["boundary"]
    rows, numrows = _ref(case)
    assert numrows.tolist() == [5, 1]
    assert rows[0, :5].tolist() == [0, 2, 4, 5, 2]
    assert rows[1, :1].tolist() == [1]
    assert (rows[:, 5:] == case["sent16"]).all() and (rows[1, 1:] == case["sent16"]).all()
    if dtype == "float32":
        assert float(np.float32(PRUNE_CUTSQ)) > PRUNE_CUTSQ


@pytest.mark.parametrize("dtype", DTYPES)
def test_prune_nan_drops_rows(dtype):
    """A NaN in a real atom of a unit drops every row of that unit; a NaN
    in an atom of a block drops that block from every unit's rows (its
    padding slots count as j atoms); a NaN padding atom of a unit does
    not change that unit's verdicts as an i-atom; inf - inf is NaN."""
    case = prune_edge_cases(DTYPES[dtype])["nan"]
    rows, numrows = _ref(case)
    kept = [set(r[: int(n)].tolist()) for r, n in zip(rows, numrows)]
    assert numrows[2] == 0
    assert all(3 not in k and 40 not in k for k in kept)
    assert numrows[3] > 0
    assert 4 not in kept[4] and 41 not in kept[4]
    assert any(41 in k for k in kept)  # a finite atom against inf is rsq inf, no NaN


@pytest.mark.parametrize("dtype", DTYPES)
def test_prune_overflow_full_count(dtype):
    """More kept rows than rcap: the first rcap kept, in candidate order;
    numrows the full count, so the caller's overflow flag sees it."""
    case = prune_edge_cases(DTYPES[dtype])["overflow"]
    rows, numrows = _ref(case)
    assert (numrows > case["rcap"]).any()
    assert (rows != case["sent16"]).sum(1).tolist() == numrows.clamp(max=case["rcap"]).tolist()


def test_exact_prune_cpu_is_ref(monkeypatch):
    """On a CPU tensor _exact_prune is exact_prune_ref (no launch), and its
    chunks of units (MAX_ELEMS) do not change a bit."""
    case = prune_edge_cases(np.float32)["wide"]
    args = prune_tensors(torch, case, "cpu")
    before = verlet.PRUNE_LAUNCHES
    got = verlet._exact_prune(*args)
    assert verlet.PRUNE_LAUNCHES == before
    want = verlet.exact_prune_ref(*args)
    monkeypatch.setattr(verlet, "MAX_ELEMS", 1 << 12)
    small = verlet.exact_prune_ref(*args)
    for a, b, c in zip(got, want, small):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_exact_prune_other_device_raises():
    args = prune_tensors(torch, prune_edge_cases(np.float32)["random"], "meta")
    with pytest.raises(ValueError, match="no prune kernel"):
        verlet._exact_prune(*args)


def _bad(args: dict, name: str) -> dict:
    """The random case's operands with one of them made unacceptable."""
    a = dict(args)
    if name == "x float16":
        a["x"] = a["x"].half()
    elif name == "x not (n, 3)":
        a["x"] = a["x"].reshape(-1, 6)
    elif name == "x strided":
        a["x"] = torch.cat([a["x"], a["x"]], 1)[:, ::2]
    elif name == "x unaligned":
        a["x"] = torch.cat([a["x"].new_zeros(1), a["x"].reshape(-1)])[1:].view(-1, 3)
    elif name == "cand int32":
        a["cand"] = a["cand"].int()
    elif name == "cand units":
        a["cand"] = a["cand"][1:]
    elif name == "cand strided":
        a["cand"] = a["cand"].t().contiguous().t()
    elif name == "validu uint8":
        a["validu"] = a["validu"].to(torch.uint8)
    elif name == "validu shape":
        a["validu"] = a["validu"][:, :8]
    elif name == "nlocal_pad past x":
        a["nlocal_pad"] = a["x"].shape[0] + 16
    elif name == "sent16 past x":
        a["sent16"] = a["x"].shape[0] // 16
    elif name == "rcap negative":
        a["rcap"] = -8
    return a


@pytest.mark.parametrize("name", [
    "x float16", "x not (n, 3)", "x strided", "x unaligned", "cand int32", "cand units",
    "cand strided", "validu uint8", "validu shape", "nlocal_pad past x",
    "sent16 past x", "rcap negative"])
def test_prune_checks_refuse(name):
    x, cand, npad, validu, _, rcap, sent16 = prune_tensors(
        torch, prune_edge_cases(np.float32)["random"], "cpu")
    good = dict(x=x, cand=cand, nlocal_pad=npad, validu=validu, rcap=rcap,
                sent16=sent16)
    verlet._check_prune_args(**good)
    with pytest.raises((TypeError, ValueError)):
        verlet._check_prune_args(**_bad(good, name))


def _spied_operands(monkeypatch, fn) -> list:
    """The operands of every _exact_prune call that fn() makes."""
    real, seen = verlet._exact_prune, []

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(verlet, "_exact_prune", spy)
    fn()
    monkeypatch.setattr(verlet, "_exact_prune", real)
    return seen


@pytest.mark.parametrize("caller", ["ranges", "cells", "slabs"])
@pytest.mark.parametrize("precision", ["sp", "dp"])
def test_callers_operands_meet_the_kernel_checks(monkeypatch, caller, precision):
    """The engine's two row-list builds (sort_atoms on: ranges; off: the
    cell table) and the slab engine's per-domain build hand _exact_prune
    operands that its kernel takes, so on the card none of them raises."""
    kw = dict(nx=6, ny=6, nz=6, precision=precision, sort_atoms=caller != "cells")
    if caller == "slabs":
        dom = DomainSimulation(Params(**kw, kernel="rowlist"), ndev=2, device="cpu")
        seen = _spied_operands(monkeypatch, lambda: dom._reneighbor(
            [x.clone() for x in dom.x0], dom.v0, dom.n0))
        assert len(seen) == 2
    else:
        sim = Simulation(Params(**kw), device="cpu")
        assert sim._rowbuild_ranges == (caller == "ranges")
        seen = _spied_operands(monkeypatch, lambda: sim._reneighbor(sim.x0, sim.types0))
        assert len(seen) == 1
    for x, cand, npad, validu, cutsq, rcap, sent16 in seen:
        verlet._check_prune_args(x, cand, npad, validu, rcap, sent16)
        assert x.dtype == Params(**kw).dtype and cutsq == Params(**kw).cutneigh ** 2
        assert sent16 == x.shape[0] // 16 - 1
