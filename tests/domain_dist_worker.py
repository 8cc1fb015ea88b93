"""One rank of a gloo run of a domain engine (tests/test_torch_exchange.py
starts two of them for a slab engine, four for the pencil and brick
engines):

    python tests/domain_dist_worker.py RANK WORLD PORT OUT.npz [SCHEME]

Joins a gloo group at tcp://localhost:PORT, checks DistExchange's shift
(along every axis of the scheme's mesh), psum and all_gather on
rank-tagged buffers, runs a DP domain engine (10 steps, a rebuild every
5) with one domain on this rank, and writes the temperatures and the
domain's final state to OUT.npz. SCHEME "verlet" (the default) runs the
verlet slab engine on its planar path (8x4x4); "cluster" the cluster slab
engine on its exact-list plain path (8x4x4; its calibration gathers the
melt's maxima over the group); "pencil" the pencil engine on a (2, 2)
mesh, planar (8x8x4); "brick" the brick engine on a (2, 1, 2) mesh, whose
y axis of size 1 sends to itself, on the row lists (4^3; calibrated over
the group).
"""

import sys
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mdbench_tpu_torch.config import Params  # noqa: E402
from mdbench_tpu_torch.parallel.cluster_domain import ClusterDomainSimulation  # noqa: E402
from mdbench_tpu_torch.parallel.exchange import DistExchange  # noqa: E402
from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation  # noqa: E402
from mdbench_tpu_torch.parallel.verlet_domain2d import Domain2DSimulation  # noqa: E402
from mdbench_tpu_torch.parallel.verlet_domain3d import Domain3DSimulation  # noqa: E402

DOMAIN_KW = dict(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5, kernel="xla",
                 precision="dp")
CLUSTER_KW = dict(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5, kernel="ilist",
                  precision="dp", scheme="cluster")
# the pencil and brick schemes: (engine, mesh shape, Params keywords)
MESH_RUNS = {
    "pencil": (Domain2DSimulation, (2, 2),
               dict(nx=8, ny=8, nz=4, ntimes=10, reneigh_every=5, kernel="xla",
                    precision="dp")),
    "brick": (Domain3DSimulation, (2, 1, 2),
              dict(nx=4, ny=4, nz=4, ntimes=10, reneigh_every=5, kernel="rowlist",
                   precision="dp")),
}


def final_state(scheme: str, res, i: int = 0) -> dict:
    """The arrays of the final state of the i-th held domain that the test
    compares."""
    if scheme != "cluster":
        s = res.state
        return dict(x=s.x[i].numpy(), v=s.v[i].numpy(), f=s.f[i].numpy(),
                    nlocal=s.nlocal[i].numpy())
    d = res.state[i]
    return dict(xc=d.cl.xc.numpy(), vxc=d.vxc.numpy(), fxc=d.fxc.numpy(),
                fzc=d.fzc.numpy(), nlocal=d.nloc.numpy())


def main(rank: int, world: int, port: int, out: str, scheme: str = "verlet") -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        shape = MESH_RUNS[scheme][1] if scheme in MESH_RUNS else None
        ex = DistExchange(shape=shape)
        assert ex.domains == (rank,) and ex.ndev == world
        tag = torch.full((3, 2), float(rank))
        got = {f"shift{step:+d}": ex.shift([tag], step)[0].numpy() for step in (1, -1)}
        for axis in range(len(ex.shape)):
            for step in (1, -1):
                got[f"shift{step:+d}@{axis}"] = ex.shift([tag], step, axis)[0].numpy()
        got["psum"] = ex.psum([torch.tensor(rank + 1.0)])[0].numpy()
        got["gather"] = torch.stack(ex.all_gather([torch.tensor([rank, 2 * rank])])).numpy()
        if scheme == "verlet":
            dom = DomainSimulation(Params(**DOMAIN_KW), ndev=world, device="cpu",
                                   exchange=ex)
        elif scheme in MESH_RUNS:
            engine, shape, kw = MESH_RUNS[scheme]
            dom = engine(Params(**kw), *shape, device="cpu", exchange=ex)
        else:
            dom = ClusterDomainSimulation(Params(**CLUSTER_KW), ndev=world, device="cpu",
                                          exchange=ex)
        res = dom.run(repeats=0)
        np.savez(out, temps=res.temps, **final_state(scheme, res), **got)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], *sys.argv[5:])
