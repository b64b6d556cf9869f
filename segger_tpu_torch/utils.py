"""Logging setup with live memory annotation.

Analogue of the reference's ``setup_logging`` + ``MemFilter``
(reference: src/segger/utils.py:6-41): every log record carries live
memory usage, host RSS and, once CUDA is initialized, the free device
memory.  The port's copy of ``segger_tpu.utils``, which also has
``enable_compilation_cache``: that points JAX at XLA's persistent
compilation cache and has no counterpart here (the port's kernels are
built once per checkout by ``ops/_build.py``).
"""
from __future__ import annotations

import logging
import sys


def free_mem_str() -> str:
    """Short human-readable memory usage string: host RSS, and the free
    and total device memory of the current CUDA device when CUDA is
    initialized (the check never initializes it)."""
    out = "?"
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    kb = int(line.split()[1])
                    out = f"{kb / 1e6:.2f}G RSS"
                    break
    except OSError:
        pass
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        free, total = torch.cuda.mem_get_info()
        out += f", {free / 1e9:.2f}/{total / 1e9:.2f}G GPU free"
    return out


def print_free_mem() -> None:
    print(free_mem_str())


def peak_rss_gb() -> float:
    """Process high-water-mark RSS in GB: VmHWM, or where the kernel does
    not report it (a sandboxed one may not), ``getrusage``'s
    ``ru_maxrss``, the same high-water mark."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class MemFilter(logging.Filter):
    """Injects live memory usage into every record
    (reference: utils.py:6-13)."""

    def filter(self, record):
        record.mem = free_mem_str()
        return True


def setup_logging(level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger("segger_tpu_torch")
    logger.setLevel(level.upper())
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.addFilter(MemFilter())
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s [%(mem)s] %(name)s: %(message)s"
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
    return logger
