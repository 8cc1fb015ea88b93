"""The reference's pair lists and pair counts against brute force."""

import itertools

import numpy as np
import pytest
import torch

from portbench.reference import judge, md
from portbench.reference.lattice import box_lengths, fcc_atoms


def brute_counts(x, box, radii):
    d = x[:, None, :] - x[None, :, :]
    d -= box * np.round(d / box)
    r2 = (d * d).sum(-1)
    np.fill_diagonal(r2, np.inf)
    return [int((r2 < r * r).sum()) for r in radii]


@pytest.mark.parametrize("n,jitter", [(4, 0.0), (4, 0.3), (8, 0.3)])
def test_pair_counts_against_brute_force(n, jitter):
    cfg = dict(nx=n, ny=n, nz=n, rho=0.8442, temp=1.44, mass=1.0)
    x, _ = fcc_atoms(cfg, 0)
    box = box_lengths(cfg)
    x = x + np.random.default_rng(n).uniform(-jitter, jitter, x.shape)
    got = md.pair_counts(torch.tensor(x), torch.tensor(box), 2.8, 2.5)
    assert list(got) == brute_counts(x, box, (2.8, 2.5))
    if jitter == 0.0:  # the perfect lattice: 78 and 54 neighbours an atom
        assert got == (78 * x.shape[0], 54 * x.shape[0])


def test_cell_lists_hold_every_pair():
    cfg = dict(nx=8, ny=8, nz=8, rho=0.8442, temp=1.44, mass=1.0)
    x, _ = fcc_atoms(cfg, 0)
    box = box_lengths(cfg)
    x = x + np.random.default_rng(3).uniform(-0.4, 0.4, x.shape)
    lists = md.build_lists(torch.tensor(x), torch.tensor(box), 3.1, block=300)
    got = set()
    for s, nbr, ok in lists:
        for i, j in zip(*np.nonzero(ok.numpy())):
            got.add((s + int(i), int(nbr[i, j])))
    d = x[:, None, :] - x[None, :, :]
    d -= box * np.round(d / box)
    r2 = (d * d).sum(-1)
    want = {(i, j) for i, j in itertools.product(range(len(x)), repeat=2)
            if i != j and r2[i, j] < 3.1 * 3.1}
    assert got == want


def test_forces_against_a_loop():
    cfg = dict(nx=4, ny=4, nz=4, rho=0.8442, temp=1.44, mass=1.0, cutforce=2.5,
               sigma=1.0, epsilon=1.0)
    x, _ = fcc_atoms(cfg, 0)
    box = box_lengths(cfg)
    x = x + np.random.default_rng(5).uniform(-0.2, 0.2, x.shape)
    f, band = md.forces_at(torch.tensor(x), torch.tensor(box), cfg)
    f = f.numpy()
    assert int(band.n.max()) == 0  # no pair this close to the cutoff
    want = np.zeros_like(x)
    for i in range(len(x)):
        for j in range(len(x)):
            d = x[i] - x[j]
            d -= box * np.round(d / box)
            r2 = d @ d
            if i != j and r2 < 2.5 * 2.5:
                sr2 = 1.0 / r2
                sr6 = sr2 ** 3
                want[i] += d * 48.0 * sr6 * (sr6 - 0.5) * sr2
    assert np.abs(f - want).max() < 1e-10 * np.abs(want).max()


def test_pairs_at_the_cutoff_count_either_way():
    cfg = dict(cutforce=2.5, sigma=1.0, epsilon=1.0)
    box = torch.tensor([20.0, 20.0, 20.0], dtype=torch.float64)
    x = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 3.5 - 1e-6], [5.0, 5.0, 5.0],
                      [5.0, 5.0, 6.2]], dtype=torch.float64)
    f, band = md.forces_at(x, box, cfg)
    assert float(f[0].norm()) == 0.0 and float(f[1].norm()) == 0.0
    assert float(band.mag[0]) == pytest.approx(0.0390, abs=1e-4) and float(band.mag[2]) == 0.0
    assert band.n.tolist() == [1, 1, 0, 0]
    assert band.vec[0].tolist() == pytest.approx([0.0, 0.0, 0.0390], abs=1e-4)  # toward atom 1
    assert float(f[2].norm()) > 0.1


def test_a_lost_pair_beside_a_pair_at_the_cutoff_fails():
    """Atom 0 has a pair within the band (to atom 1) and one just inside
    the cutoff (to atom 2), of the same strength; atoms 3 and 4 sit close
    and set the largest force. The program may count the band pair or not,
    but losing the other pair fails at the limit of force_rel."""
    cfg = dict(cutforce=2.5, sigma=1.0, epsilon=1.0)
    box = torch.tensor([20.0, 20.0, 20.0], dtype=torch.float64)
    x = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 3.5 - 1e-6], [3.498, 1.0, 1.0],
                      [10.0, 10.0, 10.0], [10.0, 10.0, 11.05]], dtype=torch.float64)
    fr, band = md.forces_at(x, box, cfg)
    lost = md.lj_forces(x[[0, 2]], md.build_lists(x[[0, 2]], box, 2.6), box, cfg)[0]
    limit = 1e-4

    def gap(f):
        return judge.force_gap(judge.Outputs(x, x, f, None), box, cfg)

    assert gap(fr) == 0.0 and gap(fr + band.vec) == pytest.approx(0.0, abs=1e-15)
    for counted in (fr, fr + band.vec):
        f = counted.clone()
        f[0] -= lost
        assert gap(f) > 10 * limit
