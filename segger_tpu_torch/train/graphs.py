"""Compiled steps: the port of what ``jax.jit`` does for the JAX trainer's
train, eval and predict steps.

JAX traces each step once per input shape and replays the compiled
program.  Here a step body reads only tensors at fixed addresses, its
:class:`StepInputs`, so on CUDA it is captured once per input signature as
a ``torch.cuda.CUDAGraph`` and replayed for every later batch of that
signature.  Before each replay the host writes the batch, the dropout
seed words and the loss uniforms into a pinned staging copy of the
inputs (two, used in turn, so that the host fills one while the device
still reads the other), and one copy moves it to the device: each
:class:`StepInputs` lies in one byte buffer.  On the CPU the same body
runs eagerly on the same inputs.

- Before its capture the body runs once on a side stream, as PyTorch's
  whole-network capture does (lazy initialisation, the optimizer's
  state).  That warm-up launches real kernels and counts them; whatever
  state it changes, the ``snapshot`` given to the step puts back.
- A capture launches nothing: the kernel wrappers' launch counters are
  put back after it, and every replay adds the launches recorded there.
- Every step of a trainer captures into one memory pool.  The steps run
  one at a time on one stream, and each keeps its output alive, so any
  order of replays is safe.

Tile data parallelism (``SeggerTrainer(mesh=)``) cannot be one graph: a
CUDA graph lives on one device, and the joint masked means of a step
need the loss counts of every shard before any shard's backward.  A
shard's train step is a :class:`SplitStep`, the pattern of
``torch.cuda.make_graphed_callables``: a captured forward that returns
the shard's ``(sum, count)`` loss statistics, and a captured backward
that takes their gradient (the scales ``w_k / max(sum_d count_k, 1)``,
formed once every shard has reported) and writes the shard's flat
parameter gradient.  Each shard's graphs capture into a memory pool of
their own, which no other shard's graphs use, and none of them replays
between a forward and its backward, so the forward's saved tensors
survive the other shards' replays until the backward reads them.  The
reduction of the gradients, the copy of the parameters to the replicas
and the loss row run eagerly between the graphs; the optimizer step is a
:class:`CapturedCall`.  Every step enters its own device, so shards on
several cards queue their work on each card's current stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from ..data.graph import TileGraph
from ..ops.banded import banded_edge_stage
from ..ops.gatv2_attn import gatv2_attention
from ..ops.padded_csr import PaddedCSR
from ..ops.postgather import edge_stage_bwd, edge_stage_fwd
from ..ops.score import score_max
from ..utils_profiling import substage

# the kernel wrappers whose ``launches`` count (an int, or a dict by mode)
_COUNTED = (edge_stage_fwd, edge_stage_bwd, score_max, gatv2_attention,
            banded_edge_stage)


def launch_counts() -> list:
    """A copy of every kernel wrapper's launch counter."""
    return [dict(f.launches) if isinstance(f.launches, dict) else f.launches
            for f in _COUNTED]


def set_launch_counts(counts: list) -> None:
    for f, c in zip(_COUNTED, counts):
        f.launches = dict(c) if isinstance(c, dict) else c


def add_launches(delta: list) -> None:
    for f, d in zip(_COUNTED, delta):
        if isinstance(d, dict):
            for mode, n in d.items():
                f.launches[mode] += n
        else:
            f.launches += d


def _launch_delta(after: list, before: list) -> list:
    return [{m: a[m] - b[m] for m in a} if isinstance(a, dict) else a - b
            for a, b in zip(after, before)]


def tile_arrays(tile: TileGraph) -> list:
    """The arrays of a TileGraph in field order (a CSR table's idx, then
    its mask)."""
    out = []
    for f in dataclasses.fields(tile):
        v = getattr(tile, f.name)
        if isinstance(v, PaddedCSR):
            out += [v.idx, v.mask]
        elif v is not None and not isinstance(v, (bool, int)):
            out.append(v)
    return out


def signature(tile: TileGraph) -> tuple:
    """What a compiled step is keyed by, as ``jax.jit`` keys a trace:
    each array's shape and dtype and the static fields (degree-segment
    bounds, absent tables)."""
    sig = []
    for f in dataclasses.fields(tile):
        v = getattr(tile, f.name)
        if isinstance(v, PaddedCSR):
            sig.append((v.idx.shape, str(v.idx.dtype), v.mask.shape))
        elif v is None or isinstance(v, (bool, int)):
            sig.append(v)
        else:
            sig.append((v.shape, str(v.dtype)))
    return tuple(sig)


@dataclass
class StepInputs:
    """Everything a step reads: the ``(B, ...)`` batch; the dropout seed
    words of each edge-stage launch, ``(n, 2)`` int32 in launch order,
    tile by tile; each tile's loss uniforms, ``(B, 4, n_tx)`` and
    ``(B, 4, n_bd)`` float32 and ``(B, e_sg)`` float64, laid out as
    ``losses.draw_loss_uniforms`` draws them; and the ``(3,)`` float32
    loss weights.  A predict step's seeds, uniforms and weights are
    empty.  Every tensor is a view into ``flat``, one byte buffer, at a
    16-byte aligned offset."""

    batch: TileGraph
    seeds: torch.Tensor
    tx_u: torch.Tensor
    bd_u: torch.Tensor
    sg_u: torch.Tensor
    weights: torch.Tensor
    flat: torch.Tensor

    @classmethod
    def like(cls, batch: TileGraph, n_seeds: int, device,
             losses: bool = True, pin: bool = False) -> "StepInputs":
        """Uninitialised inputs for a NumPy ``batch`` and ``n_seeds``
        seed pairs, on ``device`` (in pinned host memory with ``pin``);
        ``losses=False`` leaves the uniforms and weights empty."""
        b, n_tx = batch.tx_valid.shape
        n_bd, e_sg, n_w = batch.bd_valid.shape[1], batch.sg_src.shape[1], 3
        if not losses:
            b = n_tx = n_bd = e_sg = n_w = 0
        specs = [(a.shape, torch.from_numpy(a[:0]).dtype)
                 for a in tile_arrays(batch)] + [
            ((n_seeds, 2), torch.int32), ((b, 4, n_tx), torch.float32),
            ((b, 4, n_bd), torch.float32), ((b, e_sg), torch.float64),
            ((n_w,), torch.float32)]
        sizes = [math.prod(shape) * dtype.itemsize for shape, dtype in specs]
        starts = [0]
        for n in sizes:
            starts.append(starts[-1] + -(-n // 16) * 16)
        flat = torch.empty(starts[-1], dtype=torch.uint8, device=device,
                           pin_memory=pin)
        views = iter([flat[o:o + n].view(dtype).view(shape) for o, n,
                      (shape, dtype) in zip(starts, sizes, specs)])
        return cls(batch.map_arrays(lambda a: next(views)), *views,
                   flat=flat)

    def tensors(self) -> List[torch.Tensor]:
        return tile_arrays(self.batch) + [self.seeds, self.tx_u, self.bd_u,
                                          self.sg_u, self.weights]


def _on_device(device: torch.device):
    """A context with ``device`` current when it is a CUDA device."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _warm_up(fn: Callable[[], object],
             snapshot: Optional[Callable[[], Callable[[], None]]]) -> None:
    """Run ``fn`` once on a side stream, as PyTorch's whole-network
    capture does, then put back what ``snapshot`` saved."""
    restore = snapshot() if snapshot is not None else None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    if restore is not None:
        restore()


def _record(fn: Callable[[], object], pool) -> Tuple[torch.cuda.CUDAGraph,
                                                     object, list]:
    """Capture ``fn()`` into a graph on the current device: the graph, its
    static output and the launches a replay makes (the counters are put
    back).  The capture stream is made on the current device: PyTorch's
    default one belongs to the device of the process's first capture."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=torch.cuda.Stream()):
        out = fn()
    launches = _launch_delta(launch_counts(), before)
    set_launch_counts(before)
    return graph, out, launches


class CompiledStep:
    """A step ``body(inputs) -> tensor`` at one input signature.

    On CUDA: the device inputs, two pinned staging copies, and the graph
    captured at the first :meth:`run`; ``snapshot()``, when given, is
    called before the warm-up and returns the function that puts back
    what the warm-up changed.  On the CPU the body runs eagerly on the
    inputs, which are also what the host fills.  Every method runs with
    the inputs' device current."""

    def __init__(self, body: Callable[[StepInputs], torch.Tensor],
                 inputs: StepInputs, pool=None,
                 snapshot: Optional[Callable[[], Callable[[], None]]] = None,
                 staging: Optional[List[StepInputs]] = None):
        self.body = body
        self.inputs = inputs
        self.pool = pool
        self.snapshot = snapshot
        self.device = inputs.flat.device
        self.cuda = self.device.type == "cuda"
        self.slots = [(s, torch.cuda.Event()) for s in staging or []]
        self._slot = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Optional[list] = None   # a replay's, from capture
        self.replays = 0
        self._host: Optional[torch.Tensor] = None

    def staging(self) -> StepInputs:
        """The inputs for the host to fill next: on CUDA the next pinned
        slot, once its last copy to the device has been read; on the
        CPU the step's own inputs."""
        if not self.cuda:
            return self.inputs
        slot, done = self.slots[self._slot]
        with substage("device.wait"):
            done.synchronize()
        return slot

    def upload(self) -> None:
        """Queue the copy of the slot :meth:`staging` gave into the
        device inputs, on the current stream: one copy of its buffer."""
        if not self.cuda:
            return
        slot, done = self.slots[self._slot]
        with _on_device(self.device):
            self.inputs.flat.copy_(slot.flat, non_blocking=True)
            done.record()
        self._slot ^= 1

    def run(self) -> torch.Tensor:
        """The body's output on the inputs as they stand: the body run
        eagerly (CPU), or the graph replayed (CUDA), captured first at
        the step's first run.  The CUDA output is the graph's static
        tensor, overwritten by the next replay."""
        if not self.cuda:
            return self.body(self.inputs)
        with _on_device(self.device):
            if self.graph is None:
                self._capture()
            self.graph.replay()
        add_launches(self.launches)
        self.replays += 1
        return self.out

    def _capture(self) -> None:
        _warm_up(lambda: self.body(self.inputs), self.snapshot)
        self.graph, self.out, self.launches = _record(
            lambda: self.body(self.inputs), self.pool)

    def fetch(self, out: torch.Tensor) -> torch.Tensor:
        """``out`` on the host: on CUDA copied into the step's pinned
        buffer (overwritten by the next fetch) and waited for."""
        if not self.cuda:
            return out
        if self._host is None:
            self._host = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
        with _on_device(self.device):
            self._host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        with substage("device.wait"):
            done.synchronize()
        return self._host


class SplitStep(CompiledStep):
    """One shard's train step, split at its loss statistics.

    :meth:`run` gives ``body(inputs)``, the shard's ``(sum, count)``
    statistics (detached); :meth:`backward` takes their gradient and
    gives the flat gradient of ``params`` (the ones the statistics reach,
    in order: ``used`` marks them, the same on every shard).  On CUDA the
    forward and the backward are two graphs in the step's own pool,
    captured at the first :meth:`run` after one warm-up of both; the
    gradient of the statistics is a static input the host fills before
    the backward's replay.  On the CPU both run eagerly."""

    def __init__(self, body: Callable[[StepInputs], torch.Tensor],
                 inputs: StepInputs, params: List[torch.Tensor], n_stats: int,
                 pool=None, staging: Optional[List[StepInputs]] = None):
        super().__init__(body, inputs, pool, staging=staging)
        self.params = list(params)
        self.grad_out = torch.zeros(n_stats, device=self.device)
        self.used: Optional[List[bool]] = None
        self.bwd_graph: Optional[torch.cuda.CUDAGraph] = None
        self.flat_grad: Optional[torch.Tensor] = None
        self.bwd_launches: Optional[list] = None
        self._stats: Optional[torch.Tensor] = None    # the CPU's, live

    def _backward(self, stats: torch.Tensor) -> torch.Tensor:
        grads = torch.autograd.grad(stats, self.params, self.grad_out,
                                    allow_unused=True)
        used = [g is not None for g in grads]
        if self.used is None:
            self.used = used
        elif used != self.used:
            raise RuntimeError("the statistics reach other parameters than "
                               "at the step's first run")
        return torch.cat([g.reshape(-1) for g in grads if g is not None])

    def run(self) -> torch.Tensor:
        out = super().run()
        if not self.cuda:
            self._stats = out
        return out.detach()

    def _capture(self) -> None:
        _warm_up(lambda: self._backward(self.body(self.inputs)), None)
        self.graph, self.out, self.launches = _record(
            lambda: self.body(self.inputs), self.pool)
        self.bwd_graph, self.flat_grad, self.bwd_launches = _record(
            lambda: self._backward(self.out), self.pool)

    def backward(self, grad: torch.Tensor) -> torch.Tensor:
        """The flat gradient of the used parameters for the statistics'
        gradient ``grad`` (any device), after the latest :meth:`run`.  The
        CUDA result is the backward graph's static tensor."""
        if not self.cuda:
            self.grad_out.copy_(grad)
            stats, self._stats = self._stats, None
            return self._backward(stats)
        with _on_device(self.device):
            self.grad_out.copy_(grad, non_blocking=True)
            self.bwd_graph.replay()
        add_launches(self.bwd_launches)
        return self.flat_grad


class CapturedCall:
    """``fn()`` with no inputs but the tensors it closes over: on CUDA a
    graph captured at the first call on ``device`` (after a warm-up whose
    changes ``snapshot`` puts back) and replayed after; on the CPU ``fn``
    run eagerly."""

    def __init__(self, fn: Callable[[], object], device: torch.device,
                 pool=None,
                 snapshot: Optional[Callable[[], Callable[[], None]]] = None):
        self.fn = fn
        self.device = device
        self.pool = pool
        self.snapshot = snapshot
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Optional[list] = None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
            return
        with _on_device(self.device):
            if self.graph is None:
                _warm_up(self.fn, self.snapshot)
                self.graph, _, self.launches = _record(self.fn, self.pool)
            self.graph.replay()
        add_launches(self.launches)
