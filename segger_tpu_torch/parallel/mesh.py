"""Device meshes: tile data parallelism and the halo-exchange whole-slide
paths.

The port's counterpart of ``segger_tpu/parallel/mesh.py`` for one
process driving every shard, as ``jax.shard_map`` and a sharded
``jax.jit`` over a single-host mesh do.  A :class:`Mesh` is a list of
devices, one per shard, and the axis shape: ``("data",)`` for strips and
for the tile axis of a batch, ``("x", "y")`` for the grid.  A device may
appear more than once: several shards then share it, the counterpart of
the JAX package's forced host devices.

Tile data parallelism (``SeggerTrainer(mesh=)`` for ``fit`` and
``predict``): :func:`shard_tile_batch` splits a stacked batch's tile axis
into one equal group per shard, as ``PartitionSpec("data")`` does, and
:class:`Replicas` keeps one copy of the model per shard, its parameters
views of one flat buffer, so that writing the updated parameters to a
replica is one copy, and :func:`reduce_gradients` sums the shards' flat
gradients on the model's device (XLA's gradient all-reduce).

Whole slide: shards move between devices with explicit tensor indexing
and ``.to()`` (``parallel/halo.py``, ``parallel/grid.py``), and the
parameters live once, on the model's device, which also holds the loss;
:func:`replicate` makes the per-device copies inside the autograd graph,
so the gradient of a loss summed over shards is the sum of their
gradients, as JAX's ``psum`` forms it.  Several processes over
``torch.distributed`` are not ported: ROADMAP.md Queue 1 item 9.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.padded_csr import as_tensor

UNPORTED = ("ROADMAP.md Queue 1 item 9 (several processes over "
            "torch.distributed)")


@dataclass(frozen=True)
class Mesh:
    """Shard ``d`` runs on ``devices[d]``; ``axis_names`` and ``dims``
    give the layout (shard id ``gx * dy + gy`` on a grid)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> its length, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device: pass devices= (e.g. [torch.device('cpu')] "
            "* n) to shard on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def _devices(n: int, devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        devices = cuda_devices()
    devices = [torch.device(d) for d in devices]
    # an index on every CUDA device, as a tensor's device has
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if n > len(devices):
        raise ValueError(f"{n} shards need {n} devices; {len(devices)} "
                         "given or visible")
    return devices[:n]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default:
    every visible CUDA device)."""
    if n_devices is None:
        n_devices = len(cuda_devices()) if devices is None else len(devices)
    return Mesh(tuple(_devices(n_devices, devices)), (axis,), (n_devices,))


def make_grid_mesh(dx: int, dy: int, devices: Optional[Sequence] = None
                   ) -> Mesh:
    """``(dx, dy)`` mesh with axes ``("x", "y")`` over the first
    ``dx * dy`` of ``devices`` (default: every visible CUDA device)."""
    return Mesh(tuple(_devices(dx * dy, devices)), ("x", "y"), (dx, dy))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Several processes over ``torch.distributed`` are not ported: one
    process drives every shard of a :class:`Mesh`, for tile data
    parallelism and the whole-slide paths alike."""
    raise NotImplementedError(
        f"initialize_multihost is not ported to segger_tpu_torch yet: "
        f"{UNPORTED}; one process drives every shard of a Mesh")


def replicate(module: torch.nn.Module, mesh: Mesh
              ) -> Dict[torch.device, Dict[str, torch.Tensor]]:
    """The module's parameters on every device of the mesh, by device:
    the parameters themselves on their own device, differentiable
    ``.to()`` copies elsewhere (call it inside the step, so that the
    copies' gradients reach the parameters)."""
    params = dict(module.named_parameters())
    out = {}
    for dev in mesh.devices:
        if dev not in out:
            out[dev] = {name: p.to(dev) for name, p in params.items()}
    return out


class ArrayFields:
    """A dataclass of arrays: :meth:`map_arrays` applies a function to
    every field, as ``TileGraph.map_arrays`` does."""

    def map_arrays(self, fn):
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def put_sharded(stacked, mesh: Mesh) -> list:
    """Shard ``d`` of a stacked host object (a ``TileGraph`` or halo
    spec with leading shard axis) as tensors on ``mesh.devices[d]``."""
    return [stacked.map_arrays(
        lambda a, d=d, dev=dev: as_tensor(np.asarray(a)[d], dev))
        for d, dev in enumerate(mesh.devices)]


def fetch_global(per_shard: Sequence[Sequence[torch.Tensor]]
                 ) -> Tuple[np.ndarray, ...]:
    """Per-shard output tuples -> one NumPy array per output with the
    shard axis leading (one process: every shard is addressable)."""
    return tuple(np.stack([t.detach().cpu().numpy() for t in outs])
                 for outs in zip(*per_shard))


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
