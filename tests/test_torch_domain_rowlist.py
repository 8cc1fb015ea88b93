"""The port's slab engine on its row-list path (per-domain resort,
cell-sorted ghosts, row lists from the cell table, the exact-list force;
on the CPU the plain K1 twin) on the in-process mesh, in float64 on the
CPU: the trajectory against the port's single-device engine for 2 and 4
slabs (rel 1e-6: the row partitions differ, so the sums round in another
order; tests/test_parallel.py:265-284), and run_chunked's replay of a
chunk that overflows, against the same engine run uninterrupted (rel
1e-9, as :352-395)."""

import numpy as np
import pytest
import torch

from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.engine import Simulation
from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rowlist_single():
    kw = dict(nx=16, ny=4, nz=4, ntimes=30, reneigh_every=10, kernel="rowlist")
    return kw, Simulation(Params(**kw), device="cpu").run(repeats=0).temps


@pytest.mark.parametrize("ndev", [2, 4])
def test_rowlist_matches_single_device(rowlist_single, ndev):
    kw, temps = rowlist_single
    dom = DomainSimulation(Params(**kw), ndev=ndev, device="cpu")
    assert dom._rowlist
    out = dom.run(repeats=0)
    assert dom._calibrated and dom.rbuckets is None  # no bucket plan off the card
    assert sum(int(n) for n in out.state.nlocal) == dom.natoms
    np.testing.assert_allclose(out.temps, temps, rtol=1e-6, atol=1e-10)


def test_run_chunked_overflow_replay():
    """rcap pinned at the cold lattice's maximum: the hot melt overflows it
    at a later rebuild, and the chunk replays from its boundary under grown
    caps (never from t = 0). Capacity padding contributes exact zeros, so
    the replay meets the uninterrupted run to rounding; the single-device
    engine (other row partitions) to a chaos-widened tolerance."""
    def mk():
        return Params(nx=16, ny=4, nz=4, ntimes=30, reneigh_every=10,
                      kernel="rowlist", temp=9.0)

    oracle = DomainSimulation(mk(), ndev=2, device="cpu").run(repeats=0)
    oracle_s = Simulation(mk(), device="cpu").run(repeats=0)

    dom = DomainSimulation(mk(), ndev=2, device="cpu")
    dom._calibrated = True  # the pinning below replaces the melt probe
    _, obs = dom._reneighbor([x.clone() for x in dom.x0], dom.v0, dom.n0,
                             with_stats=True)
    cold = max(int(o[0].max()) for o in obs)
    dom.rcap = (cold + 7) // 8 * 8  # fits t = 0, overflows once melted
    rcap0 = dom.rcap
    dom._fix_row_layout()
    dom._init_host_state(*dom._xv_init)

    out = dom.run_chunked(10, 3)
    assert dom.rcap > rcap0, "recovery never fired: overflow not forced"
    assert out.temps.shape == (30,)
    np.testing.assert_allclose(out.temps, oracle.temps, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(out.temps, oracle_s.temps, rtol=1e-4)
    with pytest.raises(ValueError, match="multiple of reneigh_every"):
        dom.run_chunked(15, 2)


def test_hand_set_bucket_plan_matches_flat(rowlist_single):
    """The bucketed row-list force (the card's K1b after the melt plan; on
    the CPU its plain twin) over a hand-set plan with a zero tier and dummy
    units, on both slabs: the trajectory of the flat force."""
    from chip_smoke import hand_plan

    kw, temps = rowlist_single
    dom = DomainSimulation(Params(**kw), ndev=2, device="cpu")
    flat = dom.run(repeats=0)
    # one plan for both slabs: the rank-wise maximum of their sorted lengths
    nr = np.sort(np.stack([n.numpy() for n in flat.state.numneigh]), axis=1).max(0)
    dom.rbuckets = hand_plan(nr, dom.rcap)
    out = dom._run_raw(30)
    assert dom.rbuckets is not None  # no overflow dropped the plan
    np.testing.assert_allclose(out.temps, flat.temps, rtol=1e-12)
    np.testing.assert_allclose(out.temps, temps, rtol=1e-6, atol=1e-10)
