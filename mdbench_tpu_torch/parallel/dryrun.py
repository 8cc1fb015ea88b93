"""Dry run of the slab engines on tiny shapes (the port's analogue of
mdbench_tpu's ``__graft_entry__.dryrun_multichip``, its verlet and
cluster slab legs; the 2-D and 3-D legs come with their engines):

    python -m mdbench_tpu_torch.parallel.dryrun [N_DOMAINS] [--device cpu]

An in-process mesh of N_DOMAINS slabs (default 4) of an 8x2x2 box (longer
in x for more than 4 slabs) runs the verlet slab engine's planar and
row-list LJ paths and the cluster slab engine's default exact-list path
(the kernel on the card) for 4 SP steps, a rebuild every 2; every atom
must be on some domain at the end, and the temperatures must meet the
single-device engine's (engine.Simulation, engine_cluster.
ClusterSimulation, the same path) within SP noise (rel 2e-5, abs 1e-7, as
mdbench_tpu's dry run).
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
