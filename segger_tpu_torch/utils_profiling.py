"""Profiling hooks: trace capture, stage walls and memory high-water marks.

The port's copy of ``segger_tpu.utils_profiling``:

  - :func:`trace`: a context manager around ``torch.profiler`` that
    writes a Chrome trace (open it in Perfetto or ``chrome://tracing``)
  - :class:`StageTimer`: wall-clock per-stage counters with derived
    rates (edges/s, transcripts/s)
  - :func:`substage` / :func:`count` / :func:`set_substage_timer`: host
    spans and counters inside the library (the graph build's kNN and
    candidate join, the PhenoGraph kNN / Jaccard / Louvain, tile planning
    and extraction, the step loop's waits and staging, the tile cache's
    hits, the writer's parts) report into one process-wide timer when a
    caller installs one; a span is also a ``record_function`` on the
    ``torch.profiler`` timeline whenever a profiler records
  - :class:`AnonRSSSampler`: the high-water mark of anonymous resident
    memory, the number that counts on a memmapped graph plane
  - :func:`device_memory_stats`: ``torch.cuda.memory_stats`` of the
    current device, once CUDA is initialized
"""
from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir, name: str = "trace.json"):
    """Profile a code block on the host and, when CUDA is available, on
    the device; the Chrome trace goes to ``log_dir/name``.

    Example::

        with trace("runs/trace"):
            trainer.fit(tiles, max_epochs=1)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / name))


class StageTimer:
    """Accumulates wall-clock + work counters per pipeline stage."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.items: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        # spans come from the main thread and the prefetch thread at once
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, items)

    def add(self, name: str, seconds: float, items: float = 0.0):
        with self._lock:
            self.seconds[name] += seconds
            self.items[name] += items
            self.calls[name] += 1

    def count(self, name: str, n: int = 1):
        """A counter: ``n`` more calls of ``name`` at no seconds."""
        with self._lock:
            self.seconds[name] += 0.0
            self.calls[name] += n

    def rates(self) -> Dict[str, float]:
        """items/second per stage (0 when no items recorded)."""
        return {
            k: (self.items[k] / s if s > 0 else 0.0)
            for k, s in self.seconds.items()
        }

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "seconds": round(self.seconds[k], 4),
                "calls": self.calls[k],
                "items": self.items[k],
                "rate": round(
                    self.items[k] / self.seconds[k], 2
                ) if self.seconds[k] > 0 else 0.0,
            }
            for k in self.seconds
        }

    def dump(self, path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))


# the process-wide sub-stage timer: whole-slide drivers install one to
# split "features" and "graph" by library stage without threading a timer
# through every signature
_SUBSTAGES: Optional[StageTimer] = None


def set_substage_timer(timer: Optional[StageTimer]) -> Optional[StageTimer]:
    """Install (or clear, with None) the process-wide sub-stage timer.
    Returns the previous one so callers can restore it."""
    global _SUBSTAGES
    prev = _SUBSTAGES
    _SUBSTAGES = timer
    return prev


@contextlib.contextmanager
def substage(name: str, items: float = 0.0):
    """Record a library-internal stage into the installed sub-stage
    timer, and as a ``record_function`` span whenever a ``torch.profiler``
    records; with neither, a no-op beyond one global read and the
    profiler's flag."""
    t = _SUBSTAGES
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        if t is None:
            yield
        else:
            with t.stage(name, items=items):
                yield
        return
    with prof.record_function(name), (
            t.stage(name, items=items) if t is not None
            else contextlib.nullcontext()):
        yield


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the installed sub-stage timer's counter ``name``; a
    no-op beyond one global read when none is installed."""
    t = _SUBSTAGES
    if t is not None:
        t.count(name, n)


def _status_gb(key: str) -> Optional[float]:
    """The ``key`` line of /proc/self/status in GB, or None where the
    kernel does not report it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) / 1024.0 / 1024.0
    except OSError:
        pass
    return None


class AnonRSSSampler:
    """Samples RssAnon (anonymous resident memory) and VmRSS (all resident
    memory) from /proc/self/status on a daemon thread and keeps the
    high-water marks.

    ``VmHWM`` counts mapped file pages too: on a memmapped graph plane
    those are reclaimable page cache, so the anonymous high-water mark is
    the memory the process needs.  Linux keeps no high-water mark of
    RssAnon, hence the sampler.  A kernel that does not report RssAnon
    (a sandboxed one may report VmRSS alone) leaves ``peak_gb`` None:
    not measured, never VmRSS under its name.
    """

    def __init__(self, interval: float = 0.25):
        self.interval = interval
        self.peak_gb: Optional[float] = None
        self.peak_rss_gb: Optional[float] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def read_gb() -> Optional[float]:
        """RssAnon now, in GB (None where it is not reported)."""
        return _status_gb("RssAnon")

    def _sample(self):
        for attr, key in (("peak_gb", "RssAnon"), ("peak_rss_gb", "VmRSS")):
            v = _status_gb(key)
            if v is not None:
                prev = getattr(self, attr)
                setattr(self, attr, v if prev is None else max(prev, v))

    def _run(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.interval)

    def start(self) -> "AnonRSSSampler":
        self._sample()
        self._thread.start()
        return self

    def stop(self) -> Optional[float]:
        """Stop sampling; returns the RssAnon high-water mark (GB)."""
        self._stop.set()
        self._thread.join(timeout=5)
        self._sample()
        return self.peak_gb


def device_memory_stats() -> Optional[dict]:
    """``torch.cuda.memory_stats()`` of the current device, or None
    before CUDA is initialized (the check never initializes it)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return dict(torch.cuda.memory_stats())
