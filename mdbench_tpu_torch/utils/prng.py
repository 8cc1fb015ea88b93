"""Park-Miller minimal-standard RNG, bit-exact with the reference.

The reference seeds per-atom velocities from a Park-Miller LCG driven by a
deterministic per-lattice-site seed (reference: src/common/util.c:24-71,
src/verletlist/atom.c:132-147). We reproduce the integer recurrence exactly
(Schrage's algorithm never overflows 32-bit signed ints, so plain int64
NumPy arithmetic is bit-exact), but vectorized over a whole array of seeds
— host-side setup code, NumPy only.
"""

from __future__ import annotations

import numpy as np

IA = 16807
IM = 2147483647
AM = 1.0 / IM
IQ = 127773
IR = 2836


def park_miller_step(seed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One LCG step on an int64 array of seeds.

    Returns (new_seed, uniform in (0,1)). Matches `myrandom`
    (reference: util.c:24-33) elementwise.
    """
    seed = np.asarray(seed, dtype=np.int64)
    k = seed // IQ
    seed = IA * (seed - k * IQ) - IR * k
    seed = np.where(seed < 0, seed + IM, seed)
    return seed, AM * seed.astype(np.float64)


def park_miller_nth(seed: np.ndarray, n: int) -> np.ndarray:
    """The n-th uniform drawn from each seed (n >= 1)."""
    s = np.asarray(seed, dtype=np.int64)
    out = None
    for _ in range(n):
        s, out = park_miller_step(s)
    return out


def random_reset_seed(ibase: int, coord) -> int:
    """Jenkins one-at-a-time hash over (int ibase, double coord[3]) bytes,
    masked to 27 bits, then 5 warm-up draws — the `random_reset` seeding
    scheme (reference: util.c:35-71). Used by readers that must synthesize
    velocities from positions.
    """
    mask32 = 0xFFFFFFFF
    h = 0

    def mix(h: int, b: int) -> int:
        # C adds a (signed on x86) char to an unsigned int; emulate the
        # wraparound explicitly.
        h = (h + (b & mask32)) & mask32
        h = (h + ((h << 10) & mask32)) & mask32
        h ^= h >> 6
        return h

    for b in np.frombuffer(np.int32(ibase).tobytes(), dtype=np.int8):
        h = mix(h, int(b))
    coord_bytes = np.frombuffer(
        np.asarray(coord, dtype=np.float64)[:3].tobytes(), dtype=np.int8
    )
    for b in coord_bytes:
        h = mix(h, int(b))
    h = (h + ((h << 3) & mask32)) & mask32
    h ^= h >> 11
    h = (h + ((h << 15) & mask32)) & mask32

    seed = h & 0x7FFFFFF
    if seed == 0:
        seed = 1
    s = np.array([seed], dtype=np.int64)
    for _ in range(5):  # warm-up (reference: util.c:68-69)
        s, _ = park_miller_step(s)
    return int(s[0])
