"""The exchange layer of the domain engines: what replaces mdbench_tpu's
`lax.ppermute` and `lax.psum` over the mesh axes (the port has no
`shard_map`; a domain engine runs each phase for every domain it holds,
then the exchange, then the next phase).

Every backend holds some of the `ndev` domains of a periodic mesh of
`shape` (an int: a 1-D mesh of that many domains; a tuple (px, py) or
(px, py, pz): one mesh axis a box axis). Domain ids run in row-major
order over the mesh coordinates, as mdbench_tpu's
`np.array(jax.devices()[:px * py]).reshape(px, py)` lays out its mesh
(verlet_domain2d.py:155, verlet_domain3d.py:144). Every backend takes
and returns per-domain values as lists in the order of the domains it
holds (`domains`: their ids, ascending):

- `shift(bufs, step, axis=0)`: the buffer of the domain at coordinate c
  along `axis` goes to the domain at (c + step) % shape[axis], the other
  coordinates the same; returns what each held domain receives. step =
  +1 / -1 is mdbench_tpu's `perm_r` / `perm_l` over that axis
  (verlet_domain.py:307-310). Along an axis of size 1 a domain sends to
  itself: its own border rows come back to it, which is how a periodic
  seam wraps when that axis is not cut (mdbench_tpu's self-ppermute,
  test_parallel.py:228-231).
- `psum(vals)`: the sum of the 0-d values of all domains, given to every
  held domain (mdbench_tpu's `lax.psum` over all mesh axes).
- `all_gather(vals)`: the values of all ndev domains in domain order
  (host-side reads only: calibration maxima, overflow flags, chunk
  boundaries), each domain's of one shape.

Two backends:

- `InProcessMesh(shape, device)`: every domain in this process, on one
  device (the analogue of tests/conftest.py's virtual CPU mesh, and the
  only way to run ndev > 1 on one card: NCCL puts no two ranks on one
  GPU). `shift` is a rotation of the list along the axis: the received
  tensors are the sent ones (the engines send fresh gathers and only
  read what they receive). `psum` adds in domain order.
- `DistExchange(group, shape)`: one domain per rank of a
  `torch.distributed` group (gloo on the CPU, NCCL across cards), the
  domain id the rank: `shift` by `batch_isend_irecv` with the peers
  along the axis from the rank's row-major coordinates (one send and one
  receive a call, finished before it returns; along an axis of size 1
  the rank's own buffer), `psum` by `all_gather` and a sum in domain
  order (InProcessMesh's order: the same bits on any number of ranks,
  where an all-reduce adds in an order of its own), `all_gather` by
  `all_gather`. The caller initialises the process group.
"""

from __future__ import annotations

import math

import torch


def mesh_shape(shape) -> tuple:
    """A mesh shape as a tuple of sizes (an int: a 1-D mesh); raises
    ValueError on an axis under 1."""
    shape = (shape,) if isinstance(shape, int) else tuple(int(s) for s in shape)
    if not shape or min(shape) < 1:
        raise ValueError(f"every mesh axis needs at least 1 domain, got {shape}")
    return shape


def neighbour(shape: tuple, dom: int, step: int, axis: int) -> int:
    """The id of the domain `step` places from domain `dom` along `axis`
    (periodic), in the row-major order of `shape`."""
    stride = math.prod(shape[axis + 1 :])
    c = dom // stride % shape[axis]
    return dom + ((c + step) % shape[axis] - c) * stride


class InProcessMesh:
    """All domains of a mesh of `shape` in this process, on `device`."""

    def __init__(self, shape, device="cuda"):
        self.shape = mesh_shape(shape)
        self.ndev = math.prod(self.shape)
        self.device = torch.device(device)
        self.domains = tuple(range(self.ndev))

    def shift(self, bufs: list, step: int, axis: int = 0) -> list:
        return [bufs[neighbour(self.shape, j, -step, axis)] for j in range(self.ndev)]

    def psum(self, vals: list) -> list:
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        return [total] * self.ndev

    def all_gather(self, vals: list) -> list:
        return list(vals)


class DistExchange:
    """One domain per rank of `group` (None: the default group), which the
    caller has initialised; domain id = the rank in the group. `shape`
    (None: a 1-D mesh of the group's size) must hold as many domains as
    the group has ranks."""

    def __init__(self, group=None, shape=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.ndev = dist.get_world_size(group)
        self.shape = mesh_shape(self.ndev if shape is None else shape)
        if math.prod(self.shape) != self.ndev:
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{math.prod(self.shape)} ranks, the group has {self.ndev}")
        self.rank = dist.get_rank(group)
        self.domains = (self.rank,)

    def _peer(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def shift(self, bufs: list, step: int, axis: int = 0) -> list:
        (buf,) = bufs
        if self.shape[axis] == 1:
            return [buf]
        dist = self._dist
        buf = buf.contiguous()
        recv = torch.empty_like(buf)
        to = neighbour(self.shape, self.rank, step, axis)
        frm = neighbour(self.shape, self.rank, -step, axis)
        ops = [dist.P2POp(dist.isend, buf, self._peer(to), self.group),
               dist.P2POp(dist.irecv, recv, self._peer(frm), self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [recv]

    def psum(self, vals: list) -> list:
        (v,) = vals
        parts = self.all_gather([v.reshape(1)])
        total = parts[0]
        for q in parts[1:]:
            total = total + q
        return [total.reshape(v.shape)]

    def all_gather(self, vals: list) -> list:
        (v,) = vals
        v = v.contiguous()
        out = [torch.empty_like(v) for _ in range(self.ndev)]
        self._dist.all_gather(out, v, group=self.group)
        return out
