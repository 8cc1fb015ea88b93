"""The exchange layer of the domain engines: what replaces mdbench_tpu's
`lax.ppermute` and `lax.psum` over the mesh axis (the port has no
`shard_map`; a domain engine runs each phase for every domain it holds,
then the exchange, then the next phase).

Every backend holds some of the `ndev` domains of a 1-D periodic mesh
(`domains`: their ids, ascending) and takes and returns per-domain
values as lists in that order:

- `shift(bufs, step)`: domain i's buffer goes to domain (i + step) %
  ndev; returns what each held domain receives. step = +1 / -1 is
  mdbench_tpu's `perm_r` / `perm_l` (verlet_domain.py:307-310). With one
  domain it sends to itself: a slab's own border rows come back to it,
  which is how the periodic x seam wraps.
- `psum(vals)`: the sum of the 0-d values of all domains, given to every
  held domain.
- `all_gather(vals)`: the values of all ndev domains in domain order
  (host-side reads only: calibration maxima, overflow flags, chunk
  boundaries), each domain's of one shape.

Two backends:

- `InProcessMesh(ndev, device)`: every domain in this process, on one
  device (the analogue of tests/conftest.py's virtual CPU mesh, and the
  only way to run ndev > 1 on one card: NCCL puts no two ranks on one
  GPU). `shift` is a list rotation: the received tensors are the sent
  ones (the engines send fresh gathers and only read what they receive).
  `psum` adds in domain order.
- `DistExchange(group)`: one domain per rank of a `torch.distributed`
  group (gloo on the CPU, NCCL across cards): `shift` by
  `batch_isend_irecv`, `psum` by `all_reduce`, `all_gather` by
  `all_gather`. The caller initialises the process group.
"""

from __future__ import annotations

import torch


class InProcessMesh:
    """All `ndev` domains in this process, on `device`."""

    def __init__(self, ndev: int, device="cuda"):
        if ndev < 1:
            raise ValueError(f"ndev must be at least 1, got {ndev}")
        self.ndev = ndev
        self.device = torch.device(device)
        self.domains = tuple(range(ndev))

    def shift(self, bufs: list, step: int) -> list:
        n = self.ndev
        return [bufs[(j - step) % n] for j in range(n)]

    def psum(self, vals: list) -> list:
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        return [total] * self.ndev

    def all_gather(self, vals: list) -> list:
        return list(vals)


class DistExchange:
    """One domain per rank of `group` (None: the default group), which the
    caller has initialised; domain id = the rank in the group."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.ndev = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.domains = (self.rank,)

    def _peer(self, r: int) -> int:
        r %= self.ndev
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def shift(self, bufs: list, step: int) -> list:
        (buf,) = bufs
        if self.ndev == 1:
            return [buf]
        dist = self._dist
        buf = buf.contiguous()
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, self._peer(self.rank + step), self.group),
               dist.P2POp(dist.irecv, recv, self._peer(self.rank - step), self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [recv]

    def psum(self, vals: list) -> list:
        (v,) = vals
        total = v.clone()
        self._dist.all_reduce(total, group=self.group)
        return [total]

    def all_gather(self, vals: list) -> list:
        (v,) = vals
        v = v.contiguous()
        out = [torch.empty_like(v) for _ in range(self.ndev)]
        self._dist.all_gather(out, v, group=self.group)
        return out
