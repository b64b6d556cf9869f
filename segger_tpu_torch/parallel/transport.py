"""Moving halo rows between the shards of a mesh, inside a process and
across processes: the port's ``jax.lax.ppermute``, and the all-reduces
of the whole-slide train step (``jax.lax.psum``).

A stage of an exchange is a set of routes, each a partial permutation of
the shards (``(src, dst)`` pairs, as ``ppermute`` takes them), with one
send buffer per shard and route.  :func:`exchange` runs one stage for all
of this rank's shards: a pair inside the rank moves with ``.to()``, as in
one process; the pairs across ranks move with ``dist.batch_isend_irecv``
in one autograd node; and a shard that no pair reaches receives zeros, as
``ppermute`` gives.  Every shard's buffer on a route has one shape (the
padded send tables are stacked), so a receiver allocates its buffer as
its own send buffer's and no size message is needed.  The ranks post
their transfers in one global order (route by route, pair by pair), so
that between two ranks the sends and receives pair up in order, and
gloo's tags name each transfer.

The node's backward is the reverse exchange of the cotangents, since the
VJP of ``ppermute`` is the reverse permutation.  A stage being one node
per rank, every rank's backward reaches the exchanges in one order, the
reverse of the forward's: layer ``i + 1``, exchange ``i + 1``, layer
``i``.  A rank's node is in the graph only if it receives: the strips'
and the grid's stages hold every pair's reverse, so a rank that sends
also receives.

Gloo moves host memory: under it a CUDA tensor goes through the host,
each send buffer copied to the host and each received buffer back to its
shard's device, and the all-reduces stage the same way.  The backend is
read by name from the process group.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

Route = Sequence[Tuple[int, int]]


def _through_host() -> bool:
    """The group's backend moves host memory only."""
    return dist.get_backend() == "gloo"


def shard_ids(n: int, mesh: Optional[Mesh]) -> Sequence[int]:
    """The shards this process drives: ``mesh.local``, or all ``n``
    without a mesh."""
    return range(n) if mesh is None else mesh.local


@dataclass(frozen=True)
class _Plan:
    """One stage's pairs across ranks, seen from ``rank``: slot
    ``i * L + j`` is the ``j``-th local shard's buffer on route ``i`` (``L``
    local shards), in and out."""

    routes: Tuple[Tuple[Tuple[int, int], ...], ...]
    owners: Tuple[int, ...]
    rank: int
    local: Tuple[int, ...]
    host: bool                   # stage CUDA buffers through the host

    def reversed(self) -> "_Plan":
        return dataclasses.replace(self, routes=tuple(
            tuple((dst, src) for src, dst in route)
            for route in self.routes))

    def _across(self):
        """``(tag, slot, src, dst)`` of every pair across ranks that
        starts or ends on this rank, in the global order."""
        slot = {d: j for j, d in enumerate(self.local)}
        for i, route in enumerate(self.routes):
            for src, dst in route:
                if (self.owners[src] != self.owners[dst]
                        and self.rank in (self.owners[src],
                                          self.owners[dst])):
                    mine = src if self.owners[src] == self.rank else dst
                    yield (i * len(self.owners) + src,
                           i * len(self.local) + slot[mine], src, dst)

    def receives(self) -> List[int]:
        """The slots that receive across ranks, in the global order."""
        return [k for _, k, _, dst in self._across()
                if self.owners[dst] == self.rank]

    def move(self, sends: Sequence[Optional[torch.Tensor]],
             like: Sequence[tuple]) -> List[torch.Tensor]:
        """Send ``sends[k]`` of every sending slot and receive into
        buffers of ``like[k]``'s ``(shape, dtype, device)``: the received
        buffers, in :meth:`receives`' order."""
        ops, landed = [], []
        for tag, k, src, dst in self._across():
            if self.owners[src] == self.rank:
                t = sends[k].contiguous()
                ops.append(dist.P2POp(dist.isend, t.cpu() if self.host
                                      else t, self.owners[dst], tag=tag))
            else:
                shape, dtype, device = like[k]
                buf = torch.empty(shape, dtype=dtype, device="cpu"
                                  if self.host else device)
                ops.append(dist.P2POp(dist.irecv, buf, self.owners[src],
                                      tag=tag))
                landed.append((buf, device))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [buf.to(device) for buf, device in landed]


class _Stage(torch.autograd.Function):
    """The pairs across ranks of one exchange stage, for this rank's
    shards: takes every local send buffer, returns the buffers received
    across ranks; its backward is the reverse stage of the cotangents."""

    @staticmethod
    def forward(ctx, plan: _Plan, *sends):
        ctx.plan = plan
        ctx.like = [(t.shape, t.dtype, t.device) for t in sends]
        return tuple(plan.move(sends, ctx.like))

    @staticmethod
    def backward(ctx, *grads):
        cot: List[Optional[torch.Tensor]] = [None] * len(ctx.like)
        for k, g in zip(ctx.plan.receives(), grads):
            cot[k] = g
        back = ctx.plan.reversed()
        grad: List[Optional[torch.Tensor]] = [None] * len(ctx.like)
        for k, g in zip(back.receives(), back.move(cot, ctx.like)):
            grad[k] = g
        return (None, *grad)


def exchange(routes: Sequence[Route],
             sends: Sequence[Sequence[Optional[torch.Tensor]]],
             mesh: Optional[Mesh] = None) -> List[list]:
    """One exchange stage.  ``sends[i][d]`` is shard ``d``'s buffer on
    route ``i`` (``None`` for the other ranks' shards); returns
    ``recv[i][d]``, for this rank's shards: what ``d``'s partner on route
    ``i`` sent, zeros where no pair of the route reaches ``d``, on
    ``d``'s device.  Without a mesh every shard is this process's."""
    n = len(sends[0])
    local = tuple(shard_ids(n, mesh))
    out: List[list] = [[None] * n for _ in routes]
    for i, route in enumerate(routes):
        for src, dst in route:
            if src in local and dst in local:
                out[i][dst] = sends[i][src].to(sends[i][dst].device)
    if mesh is not None and mesh.spans_ranks:
        plan = _Plan(routes=tuple(tuple(route) for route in routes),
                     owners=mesh.owners, rank=mesh.rank, local=local,
                     host=_through_host())
        got = _Stage.apply(plan, *(sends[i][d] for i in range(len(routes))
                                   for d in local))
        for k, t in zip(plan.receives(), got):
            i, j = divmod(k, len(local))
            out[i][local[j]] = t
    for i in range(len(routes)):
        for d in local:
            if out[i][d] is None:
                out[i][d] = torch.zeros_like(sends[i][d])
    return out


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank, in place (through the host under
    gloo for a CUDA tensor)."""
    if _through_host() and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def all_reduce_gradients(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over every rank with one all-reduce
    of one flat buffer (JAX's ``psum(grads)``).  A parameter has a
    gradient afterwards where any rank's had one, as a one-process
    backward over every shard gives it; the gradients become views of the
    buffer."""
    params = [p for p in params if p.requires_grad]
    dev = params[0].device
    parts = [torch.zeros(p.numel(), dtype=torch.float32, device=dev)
             if p.grad is None else p.grad.reshape(-1).float()
             for p in params]
    had = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=dev)
    flat = all_reduce_(torch.cat(parts + [had]))
    off = 0
    for p, any_rank in zip(params, flat[-len(params):].tolist()):
        g = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
        p.grad = g.to(p.dtype) if any_rank else None
