"""Host-side batch prefetching: overlap tile extraction with device
compute.

Tile extraction is NumPy slicing and padding; a background thread
producing into a bounded queue overlaps it with the device work of the
previous batch.  The producer never touches torch device state: the
consumer moves each batch to the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

from ..utils_profiling import substage

_SENTINEL = object()


class PrefetchIterator:
    """Iterate ``fn(item)`` over ``items`` with ``depth`` results built
    ahead on a background thread.

    Single-use: a second ``iter()`` raises.  The producer watches a stop
    flag with bounded-timeout puts, so abandoning iteration early
    releases the thread and its pending batches via ``close()`` (also a
    context manager).
    """

    def __init__(self, items: Iterable, fn: Callable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._items = list(items)
        self._fn = fn
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._consumed = False
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for it in self._items:
                if self._stop.is_set():
                    return
                out = self._fn(it)
                while not self._stop.is_set():
                    try:
                        self._q.put(out, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                else:
                    return
        except BaseException as e:  # handed to the consumer, re-raised there
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def close(self):
        """Release the producer thread and any pending batches."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self) -> Iterator:
        if self._consumed:
            raise RuntimeError(
                "PrefetchIterator is single-use and already consumed"
            )
        self._consumed = True
        try:
            while True:
                # the consumer's wait for the next result
                with substage("prefetch.wait"):
                    out = self._q.get()
                if out is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield out
        finally:
            self.close()

    def __len__(self):
        return len(self._items)
