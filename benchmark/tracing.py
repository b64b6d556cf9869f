"""The traced run: a torch.profiler trace of whole units (epochs or
passes) of the window, reduced to what the per-layer readers read.

The trace opens with spin kernels (``torch.cuda._sleep``): the profiler
drops the first device records of a trace, more of them the longer the
process has idled, and the spins take that loss (the remedy of
``chip_smoke.py::kernel_trace`` when the benchmark was defined).  Kernel
records are then held against the port's launch counters; a kernel
whose records miss more than 1 % of its launches gives no roofline.

The program's host work carries ``record_function`` spans
(``bench.extract``, ``bench.plan``, ``bench.stage``,
``bench.step.<kind>``, ``bench.write``; ``hooks.labelled`` puts them on),
so that each idle gap of the device is named by the host work that ran
during it, and each forward record by the kind of step it ran in.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

LEAD = 64
SPIN = "spin_kernel"
WINDOW = "bench.window"
EXTRACT = "bench.extract"                   # the prefetch thread's label
STEP = "bench.step."                       # + the step's kind
LABELS = (EXTRACT, "bench.plan", "bench.stage", STEP + "train",
          STEP + "eval", STEP + "predict", "bench.write")
KERNELS = {"fwd": "edge_stage_fwd_kernel", "bwd": "edge_stage_bwd_kernel",
           "score": "score_max_kernel"}
TOP = 10


@dataclass
class TraceView:
    """What the per-layer readers read from one traced run."""

    kind: str
    units: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]     # (name, start us, dur us)
    steps: List[Tuple[float, str]]              # (start us, kind) a step
    launches: Dict[str, int]                    # K1, K2, K3, K5 deltas
    least_s: Dict[str, float]                   # by kernel, all units
    flops: float                                # model FLOPs, all units
    stages: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    write_s: float = 0.0
    rows_written: int = 0

    def _records(self, key: str) -> List[float]:
        return [d for n, _, d in self.kernels if KERNELS[key] in n]

    def kernel_seconds(self, k: str) -> Optional[float]:
        """Summed device seconds of kernel ``k``'s launches: its records
        (K1 and K2 told apart by the kind of the step whose label last
        opened before the record, training steps running K2), scaled by
        launches over records where the trace lost a few; None where it
        lost more than 1 %."""
        if k in ("K1", "K2"):
            starts = [t for t, _ in self.steps]
            recs = [d for n, t, d in self.kernels if KERNELS["fwd"] in n
                    and (self.steps[bisect.bisect_right(starts, t) - 1][1]
                         == "train" if starts and t >= starts[0]
                         else False) == (k == "K2")]
        else:
            recs = self._records("bwd" if k == "K3" else "score")
        n = self.launches[k]
        if not recs or not n or abs(len(recs) - n) > 0.01 * n:
            return None
        return sum(recs) / 1e6 * n / len(recs)

    def roofline(self, k: str) -> Optional[float]:
        """The least time of kernel ``k``'s launches over their device
        time, in percent."""
        t = self.kernel_seconds(k)
        least = self.least_s.get(k, 0.0)
        if not t or not least:
            return None
        return 100.0 * least / t


def profile(fn: Callable[[], object]):
    """``fn()`` under torch.profiler after the spin lead: its result and
    the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function

    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        cuda = torch.cuda.is_available()
        for _ in range(LEAD if cuda else 0):
            torch.cuda._sleep(1)
        if cuda:
            torch.cuda.synchronize()
        with record_function(WINDOW):
            out = fn()
        if cuda:
            torch.cuda.synchronize()
    return out, prof.events()


def reduce(events) -> dict:
    """The window's span, its device records (spins left out), the union
    of their intervals, the longest idle gaps named by the host label
    that covers them, and the device operations that took most time."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == WINDOW
           and e.device_type != DeviceType.CUDA]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    device, labels, spins = [], [], 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            if SPIN in e.name:
                spins += 1
                continue
            s, t = e.time_range.start, e.time_range.end
            if t > w0 and s < w1:
                device.append((e.name, s, t - s))
        elif e.name in LABELS:
            labels.append((e.name, e.time_range.start, e.time_range.end))
    device.sort(key=lambda r: r[1])
    busy, gaps, cur = 0.0, [], w0
    for _, s, d in device:
        s, t = max(s, w0), min(s + d, w1)
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if w1 > cur:
        gaps.append((cur, w1))

    def name_of(a, b):
        """The main thread's label that overlaps the gap most; else the
        prefetch thread's extraction, which the main thread waited for."""
        for group in ([x for x in labels if x[0] != EXTRACT],
                      [x for x in labels if x[0] == EXTRACT]):
            best = max(((min(b, t) - max(a, s), n) for n, s, t in group),
                       default=(0.0, None))
            if best[0] > 0:
                return best[1]
        return "host, unlabelled"

    gaps.sort(key=lambda g: g[0] - g[1])
    by_op: Dict[str, float] = {}
    for n, _, d in device:
        by_op[n[:160]] = by_op.get(n[:160], 0.0) + d / 1e6
    steps = sorted((s, n[len(STEP):]) for n, s, _ in labels
                   if n.startswith(STEP))
    return {
        "window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
        "kernels": device, "spins": spins, "steps": steps,
        "breakdown": {
            "device_ops": sorted(([n, s] for n, s in by_op.items()),
                                 key=lambda r: -r[1])[:TOP],
            "idle_gaps": [[name_of(a, b), (b - a) / 1e6]
                          for a, b in gaps[:TOP]]}}
