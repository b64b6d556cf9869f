"""Every hook the benchmark puts on the program's trainer, in one place.

The benchmark reads the trainer's work through four of its methods,
shadowed on the instance and taken away again: ``_build_batch`` (each
batch a unit builds), ``_batch_plans`` (each epoch's or pass's
planning), ``_stage`` (a step's host staging, and the inputs of the
compared training steps) and ``_run`` (a step, by its kind).  A method
that the trainer's class no longer has stops the run with an error that
names it, rather than leave a metric or a comparison silent.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List, Optional

from tracing import EXTRACT, STEP, sync_fn

METHODS = ("_build_batch", "_batch_plans", "_stage", "_run")


class HookError(RuntimeError):
    """The trainer lacks a method the benchmark hooks, or a hook never
    fired."""


def _method(trainer, name: str) -> Callable:
    """The class's method ``name`` bound to ``trainer``."""
    fn = getattr(type(trainer), name, None)
    if not callable(fn):
        raise HookError(f"{type(trainer).__name__} has no method {name!r}, "
                        f"which the benchmark hooks ({', '.join(METHODS)})")
    return fn.__get__(trainer)


def _shadow(trainer, shadows: Dict[str, Callable]):
    for k, f in shadows.items():
        _method(trainer, k)
        setattr(trainer, k, f)


def _unshadow(trainer, names):
    for k in names:
        vars(trainer).pop(k, None)


def _label(name: str, fn: Callable) -> Callable:
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return wrapped


@contextlib.contextmanager
def labelled(trainer, on_batch: Callable):
    """Label the trainer's host work for the trace, and hand every batch
    it builds to ``on_batch(plan, batch)``."""
    build = _method(trainer, "_build_batch")
    run = _method(trainer, "_run")

    def build_batch(plan, cache=True):
        batch = build(plan, cache)
        on_batch(plan, batch)
        return batch

    def run_step(kind, step):
        from torch.profiler import record_function
        with record_function(STEP + kind):
            return run(kind, step)

    shadows = {"_build_batch": _label(EXTRACT, build_batch),
               "_batch_plans": _label("bench.plan",
                                      _method(trainer, "_batch_plans")),
               "_stage": _label("bench.stage", _method(trainer, "_stage")),
               "_run": run_step}
    _shadow(trainer, shadows)
    try:
        yield
    finally:
        _unshadow(trainer, shadows)


class StepRecorder:
    """Records the first ``n`` training steps' inputs as the trainer
    stages them (batch, seed words, loss uniforms, weights), the
    optimizer's first moments after the first step and the parameters
    after the ``n``-th.  It shadows ``_stage`` on the instance and takes
    itself away after the ``n``-th step, or at :meth:`close`.

    On a mesh a step is one step per shard, shard ``d`` holding the
    ``d``-th equal group of the batch's tiles: the shards' seed words and
    uniforms are recorded concatenated, in global tile order.  The model
    and its optimizer live on the trainer's device, so the first moments
    are of the joint gradient."""

    def __init__(self, trainer, n: int):
        self.trainer, self.n = trainer, n
        self.steps: List[dict] = []
        self.grad1: Optional[Dict[str, object]] = None
        self.params_after: Optional[Dict[str, object]] = None
        self._stage_fn = _method(trainer, "_stage")
        _shadow(trainer, {"_stage": self._stage})

    def _named(self, fn):
        return {name: fn(p).detach().cpu().clone()
                for name, p in self.trainer.model.named_parameters()}

    def take_after(self):
        """The parameters now, as the state after the recorded steps."""
        sync_fn([self.trainer.device])()
        self.params_after = self._named(lambda p: p)

    def close(self):
        """Stop recording; the parameters now are the state after the
        steps if the ``n``-th step never came."""
        if self.params_after is None:
            self.take_after()
        _unshadow(self.trainer, ["_stage"])
        if len(self.steps) < self.n:
            raise HookError(f"the set-up fit staged {len(self.steps)} "
                            f"training steps, fewer than the {self.n} "
                            f"compared")

    def _stage(self, steps, batch, gen=None, weights=None):
        import torch

        tr = self.trainer
        shards = steps if isinstance(steps, list) else [steps]
        train = shards[0].inputs.seeds.shape[0] > 0
        k = len(self.steps)
        if train and k == 1 and self.grad1 is None:
            sync_fn([tr.device])()
            b1 = tr.optimizer.param_groups[0]["betas"][0]
            state = tr.optimizer.state
            # a parameter the step did not update has no moment: zero
            self.grad1 = self._named(
                lambda p: state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / (1 - b1))
        if train and k == self.n:
            self.take_after()
            _unshadow(tr, ["_stage"])
        self._stage_fn(steps, batch, gen, weights)
        if train and k < self.n:
            sync_fn([s.device for s in shards])()
            inps = [s.inputs for s in shards]

            def joined(key):
                return torch.cat([getattr(i, key).detach().cpu()
                                  for i in inps])

            self.steps.append({
                "batch": batch, "seeds": joined("seeds"),
                "tx_u": joined("tx_u"), "bd_u": joined("bd_u"),
                "sg_u": joined("sg_u"),
                "weights": inps[0].weights.detach().cpu().clone()})
