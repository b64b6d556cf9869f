"""The native spatial core: ``csrc/spatial.cpp``, compiled at first use
and bound by ctypes.

The reference delegates its spatial hot paths to cuSpatial/cuML; the
host equivalents live in ``csrc/spatial.cpp`` (the port's copy of the
JAX package's, same C ABI, ``sgt_version() == 3``): a uniform-grid hash
join of points against (buffered) polygons and against boxes, the
fixed-radius kNN, Morton codes and edge-wise common-neighbor counts.

The library is built by ``g++ -O3 -march=native -fopenmp -shared -fPIC``
into ``build/native/`` at the root of the checkout.  Its file name
carries a hash of the source, the flags and the host CPU (``-march=native``
code may not run on another CPU), so an edited source or another host
rebuilds.  Concurrent processes each compile to their own temporary file
and move it into place.  A failed build or load raises with the
compiler's or the loader's message; nothing falls back to another
implementation.  The KDTree and NumPy versions of these functions stay
beside their callers as plain versions (``kdtree_neighbors(backend=
"kdtree")``, ``geometry.query.points_in_polygons_kdtree``,
``QuadTree.expanded_label_multi_plain``, ``morton_codes_plain``,
``data.clustering.common_neighbor_counts``) for the tests to compare.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "spatial.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
VERSION = 3

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}

_f64 = ctypes.POINTER(ctypes.c_double)
_i64 = ctypes.POINTER(ctypes.c_int64)
_u64 = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "sgt_points_in_polygons": (ctypes.c_int64, [
        _f64, ctypes.c_int64, _f64, _i64, ctypes.c_int64, _f64, _i64, _i64,
        ctypes.c_int64]),
    "sgt_grid_knn": (None, [
        _f64, ctypes.c_int64, _f64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_double, _i64, _f64]),
    "sgt_morton_codes": (None, [_f64, ctypes.c_int64, _u64]),
    "sgt_points_in_boxes": (ctypes.c_int64, [
        _f64, ctypes.c_int64, _f64, ctypes.c_int64, ctypes.c_double, _i64,
        _i64, ctypes.c_int64]),
    "sgt_common_neighbor_counts": (ctypes.c_int64, [
        _i64, _i64, _i64, _i64, ctypes.c_int64, _i64]),
    "sgt_version": (ctypes.c_int, []),
}


def _host_cpu() -> bytes:
    """The host CPU's model name and instruction-set flags, which decide
    what ``-march=native`` emits."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and key not in (
                        k for k, _ in keep):
                    keep.append((key, line.strip()))
                if len(keep) == 2:
                    break
    except OSError:
        pass
    return "\n".join(v for _, v in keep).encode()


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu())
    return Path(build_dir) / f"spatial_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` unless its library exists; returns the
    library's path.  Raises with the compiler's output on failure."""
    so = library_path(source, build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp.{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, str(source), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native spatial core failed ({' '.join(cmd)}):"
            f"\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library, built first if needed, its functions typed."""
    with _lock:
        so = library_path(source, build_dir)
        lib = _libs.get(so)
        if lib is not None:
            return lib
        build(source, build_dir)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            # a truncated library would fail every later process: drop it
            so.unlink(missing_ok=True)
            raise RuntimeError(
                f"loading the native spatial core {so} failed: {e}") from e
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        if lib.sgt_version() != VERSION:
            raise RuntimeError(
                f"{so}: sgt_version() {lib.sgt_version()} != {VERSION}")
        _libs[so] = lib
        return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _points(a) -> np.ndarray:
    pts = np.ascontiguousarray(a, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"points must be (n, 2), got {pts.shape}")
    return pts


def points_in_polygons(
    points: np.ndarray,
    polygons: Sequence[np.ndarray],
    distances: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Grid-hash join of points against polygons buffered outward by
    ``distances``: ``(point_idx, polygon_idx)`` int64, in the order the
    threads finish (callers sort)."""
    lib = load()
    pts = _points(points)
    n_polys = len(polygons)
    counts = np.fromiter((len(p) for p in polygons), np.int64, count=n_polys)
    offsets = np.concatenate([np.zeros(1, np.int64), np.cumsum(counts)])
    verts = (np.ascontiguousarray(np.concatenate(
        [np.asarray(p, np.float64).reshape(-1, 2) for p in polygons]))
        if n_polys else np.zeros((0, 2)))
    dists = (np.ascontiguousarray(distances, dtype=np.float64)
             if distances is not None else np.zeros(n_polys))
    if dists.shape != (n_polys,):
        raise ValueError(f"distances {dists.shape} for {n_polys} polygons")
    capacity = max(len(pts) * 2, 1024)
    while True:
        out_pt = np.empty(capacity, dtype=np.int64)
        out_poly = np.empty(capacity, dtype=np.int64)
        count = lib.sgt_points_in_polygons(
            _ptr(pts, ctypes.c_double), len(pts),
            _ptr(verts, ctypes.c_double), _ptr(offsets, ctypes.c_int64),
            n_polys, _ptr(dists, ctypes.c_double),
            _ptr(out_pt, ctypes.c_int64), _ptr(out_poly, ctypes.c_int64),
            capacity)
        if count <= capacity:
            return out_pt[:count].copy(), out_poly[:count].copy()
        capacity = count + 1024


def grid_knn(
    points: np.ndarray,
    max_k: int,
    max_dist: float = np.inf,
    query: Optional[np.ndarray] = None,
    return_dist: bool = False,
):
    """Fixed-radius kNN: the ``(nq, max_k)`` int64 table of each query's
    nearest points within ``max_dist``, nearest first (ties by index),
    -1 padded; with ``return_dist`` also their distances."""
    if max_k <= 0:
        raise ValueError(f"max_k must be positive, got {max_k}")
    lib = load()
    pts = _points(points)
    q = pts if query is None else _points(query)
    # pre-filled: the C side returns early for empty inputs
    out = np.full((len(q), max_k), -1, dtype=np.int64)
    dist = (np.full((len(q), max_k), np.inf, dtype=np.float64)
            if return_dist else None)
    lib.sgt_grid_knn(
        _ptr(pts, ctypes.c_double), len(pts), _ptr(q, ctypes.c_double),
        len(q), max_k, float(max_dist), _ptr(out, ctypes.c_int64),
        _ptr(dist, ctypes.c_double) if return_dist else None)
    return (out, dist) if return_dist else out


def points_in_boxes(
    points: np.ndarray,
    boxes: np.ndarray,
    margin: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-membership join of points against half-open ``(x0, y0, x1,
    y1)`` boxes expanded by ``margin``: ``(point_idx, box_idx)`` int64,
    in the order the threads finish."""
    lib = load()
    pts = _points(points)
    bx = np.ascontiguousarray(boxes, dtype=np.float64).reshape(-1, 4)
    capacity = max(len(pts) * 2, 1024)
    while True:
        out_pt = np.empty(capacity, dtype=np.int64)
        out_box = np.empty(capacity, dtype=np.int64)
        count = lib.sgt_points_in_boxes(
            _ptr(pts, ctypes.c_double), len(pts), _ptr(bx, ctypes.c_double),
            len(bx), float(margin), _ptr(out_pt, ctypes.c_int64),
            _ptr(out_box, ctypes.c_int64), capacity)
        if count <= capacity:
            return out_pt[:count].copy(), out_box[:count].copy()
        capacity = count + 1024


def common_neighbor_counts(
    indptr: np.ndarray,
    indices: np.ndarray,
    eu: np.ndarray,
    ev: np.ndarray,
) -> np.ndarray:
    """Per-edge common-neighbor counts |N(u) & N(v)| of an undirected
    simple graph in CSR form with sorted rows: an OpenMP sorted merge per
    edge, O(E k)."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    eu = np.ascontiguousarray(eu, dtype=np.int64)
    ev = np.ascontiguousarray(ev, dtype=np.int64)
    if eu.shape != ev.shape:
        raise ValueError(f"edge ends {eu.shape} and {ev.shape} differ")
    n = len(indptr) - 1
    if eu.size and (min(eu.min(), ev.min()) < 0
                    or max(eu.max(), ev.max()) >= n):
        raise ValueError(f"edge end out of range for {n} rows")
    out = np.zeros(len(eu), dtype=np.int64)
    if len(eu) == 0:
        return out
    load().sgt_common_neighbor_counts(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
        _ptr(eu, ctypes.c_int64), _ptr(ev, ctypes.c_int64), len(eu),
        _ptr(out, ctypes.c_int64))
    return out


def morton_codes(points: np.ndarray) -> np.ndarray:
    """Z-order codes (uint64) of points scaled to a 2^31 grid over their
    bounding box, for spatial-locality sorting."""
    lib = load()
    pts = _points(points)
    out = np.empty(len(pts), dtype=np.uint64)
    lib.sgt_morton_codes(_ptr(pts, ctypes.c_double), len(pts),
                         _ptr(out, ctypes.c_uint64))
    return out


def morton_codes_plain(points: np.ndarray) -> np.ndarray:
    """:func:`morton_codes` in NumPy (the plain version)."""
    pts = np.asarray(points, dtype=np.float64)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    with np.errstate(divide="ignore"):
        scale = np.where(hi > lo, (2**31 - 1) / (hi - lo), 0)
    g = ((pts - lo) * scale).astype(np.uint64)

    def spread(v):
        v &= np.uint64(0xFFFFFFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
        v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
        return v

    return spread(g[:, 0]) | (spread(g[:, 1]) << np.uint64(1))


def morton_decode(codes: np.ndarray) -> np.ndarray:
    """Z-order codes -> (N, 2) int64 grid coordinates (the analogue of
    the reference's ``keys_to_coordinates``,
    reference: src/segger/geometry/quadtree.py:56-94)."""
    v = np.asarray(codes, dtype=np.uint64)

    def compact(x):
        x &= np.uint64(0x5555555555555555)
        x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
        x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
        return x

    gx = compact(v.copy())
    gy = compact(v >> np.uint64(1))
    return np.stack([gx, gy], axis=1).astype(np.int64)
