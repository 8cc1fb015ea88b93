"""The seeded t=0 atoms of an FCC LJ box: a frozen copy of MD-Bench's
lattice generator (reference src/verletlist/atom.c:67-187), its
Park-Miller velocity streams (src/common/util.c:24-33) and the initial
velocity adjustment (src/common/thermo.c:82-122).

Each lattice site draws its velocity from a Park-Miller stream, and the
velocities then lose their centre-of-mass drift and are rescaled to the
configuration's temperature. Seed 0 gives the reference's atoms: a site's
stream is seeded by its linear index + 1. Another seed shifts every
site's stream by seed x 8 nx ny nz (the range of the linear index),
modulo the generator's period,
so it gives the same lattice, in the same order, with other velocities at
the same temperature (what `velocity all create T seed` is in LAMMPS).
NumPy, float64, host.
"""

from __future__ import annotations

import numpy as np

IA, IM, IQ, IR = 16807, 2147483647, 127773, 2836
AM = 1.0 / IM
SUBBOX = 8  # reference atom.c:114


def park_miller_step(seed: np.ndarray):
    """One step of `myrandom` on an int64 array: (new seed, uniform)."""
    k = seed // IQ
    seed = IA * (seed - k * IQ) - IR * k
    seed = np.where(seed < 0, seed + IM, seed)
    return seed, AM * seed.astype(np.float64)


def box_lengths(cfg: dict) -> np.ndarray:
    """(xprd, yprd, zprd) of an nx x ny x nz FCC box at density rho."""
    alat = (4.0 / cfg["rho"]) ** (1.0 / 3.0)
    return np.array([cfg["nx"], cfg["ny"], cfg["nz"]], np.float64) * alat


def fcc_atoms(cfg: dict, seed: int):
    """(x, v) float64 (N, 3) in the reference's atom order, v adjusted to
    cfg["temp"] with zero total momentum (LJ units, mass cfg["mass"]); the
    reference's velocities for seed 0, the seed's streams otherwise."""
    alat = (4.0 / cfg["rho"]) ** (1.0 / 3.0)
    nx, ny, nz = cfg["nx"], cfg["ny"], cfg["nz"]
    prd = box_lengths(cfg)
    his = [min(int(prd[d] / (0.5 * alat) + 1), 2 * n - 1)
           for d, n in enumerate((nx, ny, nz))]
    i, j, k = np.meshgrid(*(np.arange(h + 1) for h in his), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    xs = 0.5 * alat * np.stack([i, j, k], axis=1)
    keep = ((i + j + k) % 2 == 0) & np.all(xs < prd, axis=1)
    i, j, k, xs = i[keep], j[keep], k[keep], xs[keep]
    order = np.lexsort((i % SUBBOX, j % SUBBOX, k % SUBBOX,
                        i // SUBBOX, j // SUBBOX, k // SUBBOX))
    i, j, k, xs = i[order], j[order], k[order], xs[order]
    lin = (k.astype(np.int64) * (2 * ny) * (2 * nx)
           + j.astype(np.int64) * (2 * nx) + i.astype(np.int64))
    shift = (seed % (IM - 1)) * (2 * nx * 2 * ny * 2 * nz) % (IM - 1)
    s = (lin + shift) % (IM - 1) + 1  # in [1, IM - 1]; lin + 1 for seed 0
    draws = []
    for d in range(1, 19):  # draws 6, 12, 18 are vx, vy, vz
        s, u = park_miller_step(s)
        if d % 6 == 0:
            draws.append(u)
    return xs, adjust_velocities(cfg, np.stack(draws, axis=1))


def adjust_velocities(cfg: dict, v: np.ndarray) -> np.ndarray:
    """Zero the mean velocity, then rescale to cfg["temp"] (LJ units)."""
    n = v.shape[0]
    v = v - v.sum(axis=0) / n
    t = (v * v).sum() * cfg["mass"] * (1.0 / float(3 * n - 3))
    return v * np.sqrt(cfg["temp"] / t)
