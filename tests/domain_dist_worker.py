"""One rank of a gloo run of the slab engine (tests/test_torch_exchange.py
starts two of them):

    python tests/domain_dist_worker.py RANK WORLD PORT OUT.npz

Joins a gloo group at tcp://localhost:PORT, checks DistExchange's shift,
psum and all_gather on rank-tagged buffers, runs the planar DP slab
engine (8x4x4, 10 steps, a rebuild every 5) with one domain on this rank,
and writes the temperatures and the domain's final state to OUT.npz.
"""

import sys
from datetime import timedelta
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mdbench_tpu_torch.config import Params  # noqa: E402
from mdbench_tpu_torch.parallel.exchange import DistExchange  # noqa: E402
from mdbench_tpu_torch.parallel.verlet_domain import DomainSimulation  # noqa: E402

DOMAIN_KW = dict(nx=8, ny=4, nz=4, ntimes=10, reneigh_every=5, kernel="xla",
                 precision="dp")


def main(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        ex = DistExchange()
        assert ex.domains == (rank,) and ex.ndev == world
        tag = torch.full((3, 2), float(rank))
        got = {f"shift{step:+d}": ex.shift([tag], step)[0].numpy() for step in (1, -1)}
        got["psum"] = ex.psum([torch.tensor(rank + 1.0)])[0].numpy()
        got["gather"] = torch.stack(ex.all_gather([torch.tensor([rank, 2 * rank])])).numpy()
        dom = DomainSimulation(Params(**DOMAIN_KW), ndev=world, device="cpu", exchange=ex)
        res = dom.run(repeats=0)
        s = res.state
        np.savez(out, temps=res.temps, x=s.x[0].numpy(), v=s.v[0].numpy(),
                 f=s.f[0].numpy(), nlocal=s.nlocal[0].numpy(), **got)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
