"""Device meshes: tile data parallelism and the halo-exchange whole-slide
paths.

The port's counterpart of ``segger_tpu/parallel/mesh.py``.  A
:class:`Mesh` is a list of devices, one per shard, the rank that drives
each, and the axis shape: ``("data",)`` for strips and for the tile axis
of a batch, ``("x", "y")`` for the grid.  A device may appear more than
once: several shards then share it, the counterpart of the JAX package's
forced host devices.

Tile data parallelism (``SeggerTrainer(mesh=)`` for ``fit`` and
``predict``): :func:`shard_tile_batch` splits a stacked batch's tile axis
into one equal group per shard, as ``PartitionSpec("data")`` does, and
:class:`Replicas` keeps one copy of the model per shard, its parameters
views of one flat buffer, so that writing the updated parameters to a
replica is one copy, and :func:`reduce_gradients` sums the shards' flat
gradients on the model's device (XLA's gradient all-reduce).

Whole slide: shards move between devices with explicit tensor indexing
and ``.to()``, and between processes with point-to-point sends
(``parallel/transport.py``); in each process the parameters live once,
on the model's device, which also holds the loss; :func:`replicate`
makes the per-device copies inside the autograd graph, so the gradient
of a loss summed over the process's shards is the sum of their
gradients, and the processes sum theirs with an all-reduce, as JAX's
``psum`` forms it.

Several processes (``jax.distributed``'s counterpart):
:func:`initialize_multihost` joins this process to a
``torch.distributed`` group, one rank a card (NCCL) or CPU ranks (gloo),
and records every rank's shard devices.  After it, :func:`make_mesh` and
:func:`make_grid_mesh` build the global mesh in rank order, as
``jax.devices()`` spans every host: ``Mesh.owners[d]`` is the rank that
drives shard ``d`` and ``Mesh.local`` this rank's shards.
:func:`put_sharded` places only this rank's shards, :func:`fetch_global`
gathers every shard's outputs to every rank.  Every rank builds the full
host graph, as in the JAX package.  Tile data parallelism stays in one
process (the JAX package's places its batches with a plain
``device_put``, which does not cross hosts).
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.padded_csr import as_tensor

# how long a rank waits for the others at the rendezvous and in a
# collective before it raises
RENDEZVOUS_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """Shard ``d`` runs on ``devices[d]`` in the process of rank
    ``owners[d]``; ``axis_names`` and ``dims`` give the layout (shard id
    ``gx * dy + gy`` on a grid).  ``rank`` is this process's; without
    ``owners`` every shard is this process's."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]
    owners: Tuple[int, ...] = ()
    rank: int = 0

    def __post_init__(self):
        if not self.owners:
            object.__setattr__(self, "owners",
                               (self.rank,) * len(self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> its length, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> Tuple[int, ...]:
        """The shards this process drives, in shard order."""
        return tuple(d for d, r in enumerate(self.owners) if r == self.rank)

    @property
    def spans_ranks(self) -> bool:
        """Several processes drive the shards."""
        return len(set(self.owners)) > 1


@dataclass(frozen=True)
class World:
    """This process's place in the group :func:`initialize_multihost`
    made: its rank and every rank's shard devices, by rank."""

    rank: int
    devices: Tuple[Tuple[torch.device, ...], ...]


# the group's layout lives as long as torch.distributed's default group,
# which is process state too
_WORLD: Optional[World] = None


def world() -> Optional[World]:
    """The group :func:`initialize_multihost` made, while it lasts."""
    return _WORLD if _WORLD is not None and dist.is_initialized() else None


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device: pass devices= (e.g. [torch.device('cpu')] "
            "* n) to shard on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def _indexed(device) -> torch.device:
    """``device`` with an index on a CUDA device, as a tensor's has."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _devices(n: int, devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        devices = cuda_devices()
    devices = [_indexed(d) for d in devices]
    if n > len(devices):
        raise ValueError(f"{n} shards need {n} devices; {len(devices)} "
                         "given or visible")
    return devices[:n]


def _placement(n: Optional[int], devices: Optional[Sequence]) -> dict:
    """The devices, owners and rank of an ``n``-shard mesh (``n=None``:
    every device).  Without ``devices``, after
    :func:`initialize_multihost`, the shards are every rank's devices in
    rank order, and each rank must drive one at least; otherwise they
    are this process's."""
    w = world()
    if devices is None and w is not None:
        every = [(r, dev) for r, devs in enumerate(w.devices)
                 for dev in devs]
        n = len(every) if n is None else n
        if n > len(every):
            raise ValueError(f"{n} shards need {n} devices; the "
                             f"{len(w.devices)} ranks have {len(every)}")
        owners = tuple(r for r, _ in every[:n])
        idle = sorted(set(range(len(w.devices))) - set(owners))
        if idle:
            raise ValueError(f"rank(s) {idle} would drive no shard of a "
                             f"{n}-shard mesh")
        return {"devices": tuple(dev for _, dev in every[:n]),
                "owners": owners, "rank": w.rank}
    if n is None:
        n = len(cuda_devices()) if devices is None else len(devices)
    return {"devices": tuple(_devices(n, devices)),
            "rank": 0 if w is None else w.rank}


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default:
    every rank's devices after :func:`initialize_multihost`, else every
    visible CUDA device)."""
    placed = _placement(n_devices, devices)
    return Mesh(axis_names=(axis,), dims=(len(placed["devices"]),),
                **placed)


def make_grid_mesh(dx: int, dy: int, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """``(dx, dy)`` mesh with axes ``("x", "y")`` over the first
    ``dx * dy`` of ``devices`` (default: as :func:`make_mesh`)."""
    return Mesh(axis_names=("x", "y"), dims=(dx, dy),
                **_placement(dx * dy, devices))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None,
                         devices: Optional[Sequence] = None) -> None:
    """Join this process to a ``torch.distributed`` group, the
    counterpart of ``jax.distributed.initialize``.

    ``coordinator_address`` (``host:port``, where rank 0 serves the
    ``tcp://`` rendezvous), ``num_processes`` and ``process_id`` default
    to torchrun's ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``.  ``devices`` are this rank's shard devices, by default
    ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaults to the rank: one host);
    the CPU tests pass ``["cpu"] * k``.  ``backend=None`` takes NCCL for
    CUDA devices and gloo for the CPU; gloo with CUDA devices, which
    stages every transfer through the host, runs only when asked for by
    name.  An NCCL rank drives one card, and two NCCL ranks on one card
    raise before any collective (NCCL would refuse them).

    After it, :func:`make_mesh` and :func:`make_grid_mesh` build the
    global mesh from every rank's devices, in rank order.  Every rank
    builds the full host graph, as in the JAX package."""
    global _WORLD
    env = os.environ
    need = [k for k, arg in (("MASTER_ADDR", coordinator_address),
                             ("MASTER_PORT", coordinator_address),
                             ("WORLD_SIZE", num_processes),
                             ("RANK", process_id))
            if arg is None and k not in env]
    if need:
        raise ValueError(f"initialize_multihost: {', '.join(need)} unset; "
                         "pass coordinator_address, num_processes and "
                         "process_id, or start the ranks with torchrun")
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    size = (int(env["WORLD_SIZE"]) if num_processes is None
            else int(num_processes))
    if devices is None:
        devices = [torch.device("cuda", int(env.get("LOCAL_RANK", rank)))]
    devices = [_indexed(d) for d in devices]
    cuda = [d for d in devices if d.type == "cuda"]
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl" and (len(cuda) < len(devices)
                              or len(set(devices)) != 1):
        raise ValueError(f"an NCCL rank drives one card, got {devices}; "
                         "pass backend='gloo' for CPU or shared devices")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    store, rank, size = next(dist.rendezvous(
        f"tcp://{coordinator_address}", rank, size,
        timeout=RENDEZVOUS_TIMEOUT))
    if backend == "nccl":
        _one_rank_a_card(dist.PrefixStore("segger_tpu_torch/cards", store),
                         rank, size, devices[0])
    if cuda:
        torch.cuda.set_device(cuda[0])
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=size,
        timeout=RENDEZVOUS_TIMEOUT,
        **({"device_id": devices[0]} if backend == "nccl" else {}))
    every: list = [None] * size
    dist.all_gather_object(every, [str(d) for d in devices])
    _WORLD = World(rank, tuple(
        tuple(torch.device(d) for d in devs) for devs in every))


def _one_rank_a_card(store, rank: int, size: int,
                     device: torch.device) -> None:
    """Raises on every rank when two ranks name one card, through the
    rendezvous store, before any collective.  A card is its host and its
    entry in ``CUDA_VISIBLE_DEVICES`` (its index when that is unset)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else []
    index = ids[device.index] if device.index < len(ids) else device.index
    card = f"{socket.gethostname()}/{index}"
    store.set(f"card/{rank}", card)
    cards = [store.get(f"card/{r}").decode() for r in range(size)]
    store.set(f"read/{rank}", "1")
    if rank == 0:
        # rank 0 serves the store: it stays until every rank has read
        store.wait([f"read/{r}" for r in range(size)])
    shared = [r for r in range(size) if cards[r] == card]
    if len(shared) > 1:
        raise RuntimeError(
            f"NCCL cannot run two ranks on one card: ranks {shared} share "
            f"card {card}; pass backend='gloo' to run them through the host")


def shutdown_multihost() -> None:
    """Leave the group :func:`initialize_multihost` made."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def replicate(module: torch.nn.Module, mesh: Mesh
              ) -> Dict[torch.device, Dict[str, torch.Tensor]]:
    """The module's parameters on every device of this process's shards,
    by device: the parameters themselves on their own device,
    differentiable ``.to()`` copies elsewhere (call it inside the step, so
    that the copies' gradients reach the parameters)."""
    params = dict(module.named_parameters())
    out = {}
    for d in mesh.local:
        dev = mesh.devices[d]
        if dev not in out:
            out[dev] = {name: p.to(dev) for name, p in params.items()}
    return out


def check_replicated(module: torch.nn.Module, mesh: Mesh) -> None:
    """On a mesh that spans ranks, raises unless every rank holds the
    same parameters: an all-gather of a digest of them.  Nothing is
    broadcast, so a rank that loaded other weights is an error, as the
    JAX package's replicated parameters must be equal."""
    if not mesh.spans_ranks:
        return
    flat = flat_parameters(module).float().cpu().numpy()
    every: list = [None] * dist.get_world_size()
    dist.all_gather_object(every, hashlib.sha256(flat.tobytes()).hexdigest())
    differ = [r for r, h in enumerate(every) if h != every[0]]
    if differ:
        raise RuntimeError(f"parameter checksums differ across ranks: "
                           f"rank(s) {differ} hold other parameters than "
                           "rank 0")


class ArrayFields:
    """A dataclass of arrays: :meth:`map_arrays` applies a function to
    every field, as ``TileGraph.map_arrays`` does."""

    def map_arrays(self, fn):
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def put_sharded(stacked, mesh: Mesh) -> list:
    """Shard ``d`` of a stacked host object (a ``TileGraph`` or halo
    spec with leading shard axis) as tensors on ``mesh.devices[d]``, for
    this process's shards; ``None`` for the other ranks' (the JAX
    package's ``make_array_from_callback``)."""
    return [stacked.map_arrays(
        lambda a, d=d: as_tensor(np.asarray(a)[d], mesh.devices[d]))
        if d in mesh.local else None for d in range(mesh.size)]


def fetch_global(per_shard: Sequence[Optional[Sequence[torch.Tensor]]],
                 mesh: Mesh) -> Tuple[np.ndarray, ...]:
    """Per-shard output tuples (``None`` for the other ranks' shards) ->
    one NumPy array per output with the shard axis leading, the same on
    every rank: on a mesh that spans ranks every rank's shards are
    gathered to all (``process_allgather(tiled=True)``)."""
    mine = {d: tuple(t.detach().cpu().numpy() for t in per_shard[d])
            for d in mesh.local}
    if mesh.spans_ranks:
        every: list = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        mine = {d: outs for part in every for d, outs in part.items()}
    return tuple(np.stack(col)
                 for col in zip(*(mine[d] for d in range(mesh.size))))


def shard_tile_batch(batch, mesh: Mesh) -> list:
    """Group ``d`` of a stacked NumPy ``TileGraph``'s leading tile axis,
    split into ``mesh.size`` equal groups, as tensors on
    ``mesh.devices[d]`` (the JAX package's ``PartitionSpec("data")`` on
    the tile axis)."""
    n = batch.tx_gene.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} tiles do not split into {mesh.size} equal "
                         "groups")
    g = n // mesh.size
    return [batch.map_arrays(
        lambda a, d=d, dev=dev: as_tensor(np.asarray(a)[d * g:(d + 1) * g],
                                          dev))
        for d, dev in enumerate(mesh.devices)]


def flat_parameters(module: torch.nn.Module) -> torch.Tensor:
    """Every parameter of ``module``, flattened and concatenated in
    ``parameters()`` order (a new tensor, outside autograd)."""
    with torch.no_grad():
        return torch.cat([p.reshape(-1) for p in module.parameters()])


class Replicas:
    """One copy of ``module`` per shard of ``mesh``, on the shard's
    device, for tile data parallelism.  Shards that share a device get
    copies of their own, so that no shard's graph reads another's
    parameters.  Each copy's parameters are views of one flat float32
    buffer (``flats[d]``), so :meth:`pull` writes a module's parameters
    to a copy in one copy."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh):
        self.modules: List[torch.nn.Module] = []
        self.flats: List[torch.Tensor] = []
        flat = flat_parameters(module)
        for dev in mesh.devices:
            rep = copy.deepcopy(module).to(dev)
            buf = flat.to(dev, copy=True)
            off = 0
            for p in rep.parameters():
                if p.dtype != torch.float32:
                    raise TypeError(f"parameter of {p.dtype}: the replicas "
                                    "hold float32 parameters")
                p.grad = None
                p.data = buf[off:off + p.numel()].view_as(p)
                off += p.numel()
            self.modules.append(rep)
            self.flats.append(buf)

    def pull(self, module: torch.nn.Module) -> None:
        """Write ``module``'s parameters to every copy."""
        flat = flat_parameters(module)
        for buf in self.flats:
            buf.copy_(flat, non_blocking=True)


def reduce_gradients(flat_grads: Sequence[torch.Tensor],
                     out: torch.Tensor) -> torch.Tensor:
    """The sum of the shards' flat gradients into ``out`` on the model's
    device (XLA's gradient all-reduce over the ``"data"`` axis), added
    from the last shard to the first: the order in which autograd adds a
    parameter's gradients from the tiles of a one-device step, last tile
    first, so that with one tile a shard the sum is the one-device
    gradient's, bit for bit where each tile's gradient is."""
    out.copy_(flat_grads[-1])
    for g in reversed(flat_grads[:-1]):
        out.add_(g.to(out.device))
    return out
