"""Build the package's CUDA kernels at first use and load them by ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``build/kernels/`` at
the root of the checkout.  The file name carries a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
is rebuilt and an unchanged one is reused within a checkout.  A missing ``nvcc`` or a failed build raises; nothing
falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("edge_stage_fwd", "edge_stage_bwd", "score", "attn_fwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of segger_tpu_torch cannot be built"
        )
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    process per source, all started together.  Returns, per kernel, the
    seconds its build took (0 when it was already built) and the
    compiler's ``-Xptxas=-v`` report.  Raises on the first failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        so = library_path(name)
        if so.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_suffix(f".tmp.{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), tmp, so)
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, so)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
