"""FCC lattice generation, bit-compatible with the reference's `createAtom`.

The reference walks lattice sites in 8^3-subbox order, placing an atom at
every even-parity half-lattice site inside the box, and draws its velocity
from a Park-Miller stream seeded by the site's linear index
(reference: src/verletlist/atom.c:67-187; identical generator in
src/clusterpair/atom.c). We vectorize: enumerate all candidate sites with
NumPy, filter by the same predicates, order by the subbox traversal key,
and batch the 18 LCG draws per site (draws 6/12/18 are vx/vy/vz).

Atom types: the reference assigns `rand() % ntypes` from C's unseeded
libc rand() (atom.c:159). For the default ntypes=1 this is always 0, which
we reproduce exactly. For ntypes>1 we use a deterministic glibc-compatible
TYPE_3 rand() so multi-type lattices also match a glibc-built reference.
"""

from __future__ import annotations

import numpy as np

from mdbench_tpu_torch.config import Params
from mdbench_tpu_torch.utils.prng import park_miller_step

SUBBOX = 8  # reference: atom.c:114


def _glibc_rand(n: int, seed: int = 1) -> np.ndarray:
    """glibc TYPE_3 additive-feedback rand(), first `n` outputs.

    Matches glibc's default random() state machine (r[i] = r[i-3] + r[i-31],
    output = r[i] >> 1) so `type = rand() % ntypes` agrees with the
    reference binary when built with glibc (atom.c:159).
    """
    r = np.zeros(34 + n, dtype=np.uint64)
    r[0] = np.uint64(seed)
    for i in range(1, 31):
        # r[i] = (16807 * r[i-1]) % 2147483647 using signed-safe arithmetic
        hi, lo = divmod(int(r[i - 1]), 127773)
        word = 16807 * lo - 2836 * hi
        if word < 0:
            word += 2147483647
        r[i] = np.uint64(word)
    for i in range(31, 34):
        r[i] = r[i - 31]
    out = np.empty(n, dtype=np.int64)
    for i in range(34, 34 + n):
        r[i] = (r[i - 3] + r[i - 31]) & np.uint64(0xFFFFFFFF)
        out[i - 34] = int(r[i] >> np.uint64(1))
    return out


def create_fcc_lattice(params: Params):
    """Build the initial system.

    Returns (x, v, types) as NumPy float64 (N,3) / (N,3) / int32 (N,)
    arrays in the reference's atom order.
    """
    alat = (4.0 / params.rho) ** (1.0 / 3.0)
    xhi, yhi, zhi = params.xprd, params.yprd, params.zprd

    # Index bounds (reference: atom.c:91-104); lo clamps to 0 since box
    # starts at 0.
    ihi = min(int(xhi / (0.5 * alat) + 1), 2 * params.nx - 1)
    jhi = min(int(yhi / (0.5 * alat) + 1), 2 * params.ny - 1)
    khi = min(int(zhi / (0.5 * alat) + 1), 2 * params.nz - 1)

    i = np.arange(0, ihi + 1)
    j = np.arange(0, jhi + 1)
    k = np.arange(0, khi + 1)
    I, J, K = np.meshgrid(i, j, k, indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()

    parity = (I + J + K) % 2 == 0
    X = 0.5 * alat * I
    Y = 0.5 * alat * J
    Z = 0.5 * alat * K
    inside = (X < xhi) & (Y < yhi) & (Z < zhi)  # lo bounds are 0 <= coord
    keep = parity & inside
    I, J, K = I[keep], J[keep], K[keep]
    X, Y, Z = X[keep], Y[keep], Z[keep]

    # Subbox traversal order: oz,oy,ox outer; sz,sy,sx inner
    # (reference: atom.c:116-186). Most-significant key last in lexsort.
    order = np.lexsort(
        (I % SUBBOX, J % SUBBOX, K % SUBBOX, I // SUBBOX, J // SUBBOX, K // SUBBOX)
    )
    I, J, K = I[order], J[order], K[order]
    X, Y, Z = X[order], Y[order], Z[order]

    # Velocity streams (reference: atom.c:132-147): seed = linear site
    # index + 1; draws 6, 12, 18 are vx, vy, vz.
    seeds = (
        K.astype(np.int64) * (2 * params.ny) * (2 * params.nx)
        + J.astype(np.int64) * (2 * params.nx)
        + I.astype(np.int64)
        + 1
    )
    s = seeds
    draws = {}
    for d in range(1, 19):
        s, u = park_miller_step(s)
        if d in (6, 12, 18):
            draws[d] = u
    v = np.stack([draws[6], draws[12], draws[18]], axis=1)

    x = np.stack([X, Y, Z], axis=1)
    n = x.shape[0]
    if params.ntypes <= 1:
        types = np.zeros(n, dtype=np.int32)
    else:
        types = (_glibc_rand(n) % params.ntypes).astype(np.int32)
    return x, v, types
