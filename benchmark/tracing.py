"""The traced run: a torch.profiler trace of whole units (epochs or
passes) of the window, reduced to what the per-layer readers read.

The trace opens with spin kernels (``torch.cuda._sleep``) on each card:
the profiler drops the first device records of a trace, more of them
the longer the process has idled, and the spins take that loss (the
remedy of ``chip_smoke.py::kernel_trace`` when the benchmark was
defined).  Kernel records are then held against the port's launch
counters; a kernel whose records miss more than 1 % of its launches
gives no roofline.

The program's host work carries ``record_function`` spans
(``bench.extract``, ``bench.plan``, ``bench.stage``,
``bench.step.<kind>``, ``bench.write``; ``hooks.labelled`` puts them on),
so that each idle gap of a card is named by the host work that ran
during it, and each forward record by the kind of step whose host call
launched it (the profiler's correlation of a device record with its
runtime launch, ``cudaGraphLaunch`` for a replayed graph).

A cell may span several cards: every device record keeps its card, the
busy time is each card's own union of records, averaged over the cell's
cards, and the idle gaps are each card's.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

LEAD = 64
SPIN = "spin_kernel"
WINDOW = "bench.window"
EXTRACT = "bench.extract"                   # the prefetch thread's label
STEP = "bench.step."                       # + the step's kind
LABELS = (EXTRACT, "bench.plan", "bench.stage", STEP + "train",
          STEP + "eval", STEP + "predict", "bench.write")
KERNELS = {"fwd": "edge_stage_fwd_kernel", "bwd": "edge_stage_bwd_kernel",
           "score": "score_max_kernel"}
PEER_COPY = "PtoP"             # the profiler's name of a copy between cards
TOP = 10


class Record(NamedTuple):
    """One device record of the window: a kernel, a copy or a set."""

    name: str
    start: float                   # us, on the profiler's clock
    dur: float                     # us
    card: int = 0                  # the device's index
    launch: Optional[float] = None  # us: the start of the host call that
                                    # enqueued it, where the trace links it


@dataclass
class TraceView:
    """What the per-layer readers read from one traced run."""

    kind: str
    units: int
    window_s: float
    busy_s: float                               # a card's, the cards' mean
    kernels: List[Record]                       # every device record
    steps: List[Tuple[float, float, str]]       # (start, end us, kind)
    launches: Dict[str, int]                    # K1, K2, K3, K5 deltas
    least_s: Dict[str, float]                   # by kernel, all units
    flops: float                                # model FLOPs, all units
    stages: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    write_s: float = 0.0
    rows_written: int = 0
    cards: int = 1

    def __post_init__(self):
        self.kernels = [Record(*r) for r in self.kernels]
        self._train = sorted((s, e) for s, e, kind in self.steps
                             if kind == "train")

    def _records(self, key: str) -> List[float]:
        return [r.dur for r in self.kernels if KERNELS[key] in r.name]

    def _in_train_step(self, r: Record) -> Optional[bool]:
        """Whether the host call that launched ``r`` lies inside a
        training step's label; None where the trace does not link ``r``
        to its launch.  With no training step every forward is K1."""
        if not self._train:
            return False
        if r.launch is None:
            return None
        i = bisect.bisect_right(self._train, (r.launch, float("inf"))) - 1
        return i >= 0 and r.launch <= self._train[i][1]

    def kernel_seconds(self, k: str) -> Optional[float]:
        """Summed device seconds of kernel ``k``'s launches, on every card:
        its records (K1 and K2 told apart by the step that launched them,
        training steps running K2), scaled by launches over records where
        the trace lost a few; None where it lost more than 1 %."""
        if k in ("K1", "K2"):
            recs = [r.dur for r in self.kernels if KERNELS["fwd"] in r.name
                    and self._in_train_step(r) is (k == "K2")]
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

    def peer_copy_seconds(self) -> float:
        """Summed device seconds of the window's copies between cards."""
        return sum(r.dur for r in self.kernels if PEER_COPY in r.name) / 1e6


def sync_fn(devices) -> Callable[[], None]:
    """A function that waits for the work queued on ``devices``."""
    import torch
    cuda = [d for d in devices if d.type == "cuda"]

    def sync():
        for d in cuda:
            torch.cuda.synchronize(d)
    return sync


def profile(fn: Callable[[], object], devices=()):
    """``fn()`` under torch.profiler after the spin lead on each CUDA
    device of ``devices``: its result and the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function

    cuda = [d for d in devices if d.type == "cuda"]
    sync = sync_fn(cuda)
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for d in cuda:
            with torch.cuda.device(d):
                for _ in range(LEAD):
                    torch.cuda._sleep(1)
        sync()
        with record_function(WINDOW):
            out = fn()
        sync()
    return out, prof.events()


def _is_launch(name: str) -> bool:
    """A CUDA API call that enqueues kernels: ``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ``cuLaunchKernel`` and their kin."""
    return name.startswith("cu") and "Launch" in name


def _union(records: List[Record], w0: float, w1: float):
    """The busy microseconds of ``records`` (sorted by start) within the
    window and the idle gaps between them."""
    busy, gaps, cur = 0.0, [], w0
    for r in records:
        s, t = max(r.start, w0), min(r.start + r.dur, w1)
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def reduce(events, cards: int = 1) -> dict:
    """The window's span, its device records (spins left out) with their
    cards and the host times of their launches, each card's union of
    their intervals (``busy_s`` their mean over ``cards``), the longest
    idle gaps named by the host label that covers them, and the device
    operations that took most time, summed over the cards."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == WINDOW
           and e.device_type != DeviceType.CUDA]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    device, labels, launched, spins = [], [], {}, 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            if SPIN in e.name:
                spins += 1
                continue
            s, t = e.time_range.start, e.time_range.end
            if t > w0 and s < w1:
                device.append((e.name, s, t - s,
                               getattr(e, "device_index", 0) or 0, e.id))
        elif e.name in LABELS:
            labels.append((e.name, e.time_range.start, e.time_range.end))
        elif _is_launch(e.name):
            # a device record shares its launch's correlation id
            launched[e.id] = e.time_range.start
    records = sorted((Record(n, s, d, c, launched.get(i))
                      for n, s, d, c, i in device), key=lambda r: r.start)
    # on one card, every record is that card's, as the union always was
    by_card: Dict[int, List[Record]] = {c: [] for c in range(cards)}
    for r in records:
        by_card.setdefault(r.card if cards > 1 else 0, []).append(r)
    busy, gaps = {}, []
    for card, recs in sorted(by_card.items()):
        busy[card], g = _union(recs, w0, w1)
        gaps += [(a, b, card) for a, b in g]

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
    for r in records:
        by_op[r.name[:160]] = by_op.get(r.name[:160], 0.0) + r.dur / 1e6
    steps = sorted((s, t, n[len(STEP):]) for n, s, t in labels
                   if n.startswith(STEP))
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(busy.values()) / 1e6 / len(busy),
        "busy_by_card": {c: b / 1e6 for c, b in busy.items()},
        "kernels": records, "spins": spins, "steps": steps,
        "breakdown": {
            "device_ops": sorted(([n, s] for n, s in by_op.items()),
                                 key=lambda r: -r[1])[:TOP],
            "idle_gaps": [[name_of(a, b) + (f", card {c}" if len(busy) > 1
                                            else ""), (b - a) / 1e6]
                          for a, b, c in gaps[:TOP]]}}
