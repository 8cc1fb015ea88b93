"""Dry run of the domain engines on tiny shapes (the port of mdbench_tpu's
``__graft_entry__.dryrun_multichip``: its verlet and cluster slab legs,
and its pencil and brick legs):

    python -m mdbench_tpu_torch.parallel.dryrun [N_DOMAINS] [--device cpu]

An in-process mesh of N_DOMAINS slabs (default 4) of an 8x2x2 box (longer
in x for more than 4 slabs) runs the verlet slab engine's planar and
row-list LJ paths and the cluster slab engine's default exact-list path
(the kernel on the card) for 4 SP steps, a rebuild every 2. With 4 or
more domains (an even number) the pencil engine runs on a (N / 2, 2)
mesh of a (max(2 N / 2, 4))x4x2 box, and with 8 or more the brick engine
on a (2, 2, 2) mesh of a 4^3 box, each on its default path (the row
lists; the kernel on the card), as __graft_entry__.py:128-160 has them.
Every atom must be on some domain at the end, and the temperatures must
meet the single-device engine's (engine.Simulation, engine_cluster.
ClusterSimulation, the same path) within SP noise (rel 2e-5, abs 1e-7,
as mdbench_tpu's dry run).
"""

from __future__ import annotations

import sys

import numpy as np


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The dry run on `device` (module docstring); raises AssertionError on
    a mismatch."""
    from mdbench_tpu_torch.config import Params
    from mdbench_tpu_torch.engine import Simulation
    from mdbench_tpu_torch.engine_cluster import ClusterSimulation
    from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation
    from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation
    from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation
    from mdbench_tpu_torch.parallel.verlet_domain3d import Domain3DSimulation

    # a box long in x, so that each slab is wider than cutneigh
    nx = max(2 * n_devices, 8)
    for kernel in ("xla", "rowlist"):
        def mk():
            return Params(nx=nx, ny=2, nz=2, ntimes=4, reneigh_every=2,
                          precision="sp", kernel=kernel)

        dom = DomainSimulation(mk(), ndev=n_devices, device=device)
        out = dom.run(repeats=0)
        assert np.isfinite(out.temps).all()
        assert sum(int(n) for n in out.state.nlocal) == dom.natoms
        single = Simulation(mk(), device=device).run(repeats=0)
        np.testing.assert_allclose(out.temps, single.temps, rtol=2e-5, atol=1e-7)

    # the main path's scheme over the mesh
    def mkc():
        return Params(nx=nx, ny=2, nz=2, ntimes=4, reneigh_every=2, precision="sp",
                      scheme="cluster")

    dom = ClusterDomainSimulation(mkc(), ndev=n_devices, device=device)
    out = dom.run(repeats=0)
    assert np.isfinite(out.temps).all()
    assert int(out.nlocal.sum()) == dom.natoms
    single = ClusterSimulation(mkc(), device=device).run(repeats=0)
    np.testing.assert_allclose(out.temps, single.temps, rtol=2e-5, atol=1e-7)

    # the pencils (staged x/y halo exchange, corners included) and the
    # bricks (three staged hops)
    legs = []
    if n_devices >= 4 and n_devices % 2 == 0:
        px = n_devices // 2
        legs.append((Domain2DSimulation, (px, 2),
                     dict(nx=max(2 * px, 4), ny=4, nz=2)))
    if n_devices >= 8:
        legs.append((Domain3DSimulation, (2, 2, 2), dict(nx=4, ny=4, nz=4)))
    for engine, dims, box in legs:
        def mkm():
            return Params(**box, ntimes=4, reneigh_every=2, precision="sp")

        p = mkm()
        prd = (p.xprd, p.yprd, p.zprd)
        if any(prd[d] / n < p.cutneigh for d, n in enumerate(dims)):
            continue
        dom = engine(mkm(), *dims, device=device)
        out = dom.run(repeats=0)
        assert np.isfinite(out.temps).all()
        assert sum(int(n) for n in out.state.nlocal) == dom.natoms
        single = Simulation(mkm(), device=device).run(repeats=0)
        np.testing.assert_allclose(out.temps, single.temps, rtol=2e-5, atol=1e-7)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    n = int(argv[0]) if argv else 4
    dryrun_multichip(n, device=device)
    print(f"dryrun_multichip({n}) on {device}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
