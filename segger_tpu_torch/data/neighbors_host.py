"""Host-side spatial graph construction: chunked KDTree kNN and the three
edge types of the heterogeneous graph
(reference: src/segger/data/utils/neighbors.py:122-238).

  - the transcript kNN includes the query point itself (the tx graph
    carries self loops), as ``(src=query_row, dst=neighbor)`` pairs;
    neighbors beyond ``max_dist`` are dropped
  - supervision edges come straight off the vendor cell-id column for
    compartment-masked transcripts (neighbors.py:183-197)
  - prediction candidates: 'uniform' = k nearest transcripts per cell
    centroid; 'cell'/'nucleus' = containment in polygons buffered outward
    by sqrt(area/pi)*buffer_ratio (neighbors.py:200-238), oriented
    ``(tx, bd)`` in every mode

A bounded-radius kNN runs the native core's uniform-grid kNN
(``csrc/spatial.cpp``); the chunked KDTree (``backend="kdtree"``) is its
plain version and the search for an unbounded radius.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import KDTree


def kdtree_neighbors(
    points: np.ndarray,
    max_k: int,
    max_dist: float = np.inf,
    chunk_size: int = 2_000_000,
    query: Optional[np.ndarray] = None,
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked kNN: COO ``(rows, cols)`` int32 with rows = query index and
    cols = neighbor index into ``points``, each row's neighbors nearest
    first (reference: neighbors.py:122-163).

    ``backend="native"``, or ``"auto"`` with a finite ``max_dist``, runs
    the native uniform-grid kNN (ties by index); ``"kdtree"``, or
    ``"auto"`` with an unbounded radius, the chunked KDTree (ties in the
    tree's order: the same neighbor sets)."""
    if backend not in ("auto", "native", "kdtree"):
        raise ValueError(f"unknown kNN backend {backend!r}")
    if backend == "native" or (backend == "auto" and np.isfinite(max_dist)):
        from .. import native

        idx = native.grid_knn(points, max_k=max_k, max_dist=max_dist,
                              query=query)
        valid = idx >= 0
        # int32 and no (nq, k) row matrix: at whole-slide sizes int64 rows
        # alone are multi-GB transients
        rows = np.repeat(np.arange(idx.shape[0], dtype=np.int32),
                         valid.sum(axis=1))
        return rows, idx[valid].astype(np.int32)

    q = points if query is None else query
    n_pts = points.shape[0]
    tree = KDTree(points, leafsize=100)
    rows_out, cols_out = [], []
    k = min(max_k, n_pts)
    for i in range(0, q.shape[0], chunk_size):
        _, idx = tree.query(
            q[i : i + chunk_size],
            k=k,
            distance_upper_bound=max_dist,
            workers=-1,
        )
        if k == 1:
            idx = idx[:, None]
        valid = idx < n_pts  # padding sentinel = n_pts
        r = np.repeat(np.arange(idx.shape[0]) + i, k).reshape(idx.shape)
        rows_out.append(r[valid])
        cols_out.append(idx[valid])
    return (
        np.concatenate(rows_out).astype(np.int32),
        np.concatenate(cols_out).astype(np.int32),
    )


def transcripts_graph(
    tx_pos: np.ndarray, max_k: int = 5, max_dist: float = 5.0
) -> Tuple[np.ndarray, np.ndarray]:
    """tx->tx spatial kNN edges ``(src, dst)``
    (reference: neighbors.py:166-180; defaults data_module.py:145-146)."""
    return kdtree_neighbors(tx_pos, max_k=max_k, max_dist=max_dist)


def segmentation_graph(
    tx_cell_encoding: np.ndarray, segmentation_mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """tx->bd supervision edges: (row_id, cell_encoding) for masked
    transcripts with a known cell (reference: neighbors.py:183-197)."""
    mask = np.asarray(segmentation_mask) & (tx_cell_encoding >= 0)
    src = np.where(mask)[0].astype(np.int32)
    dst = tx_cell_encoding[mask].astype(np.int32)
    return src, dst


def prediction_graph(
    tx_pos: np.ndarray,
    bd_centroids: np.ndarray,
    mode: str = "cell",
    max_k: int = 3,
    buffer_ratio: float = 0.05,
    polygons: Optional[list] = None,
    polygon_areas: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """tx->bd candidate edges ``(tx_src, bd_dst)``
    (reference: neighbors.py:200-238).

    'uniform': k nearest transcripts of each cell centroid.
    'cell'/'nucleus': transcripts within each polygon buffered outward by
    ``sqrt(area/pi) * buffer_ratio``, as distance-to-polygon <= buffer
    (:func:`..geometry.query.points_in_polygons`).
    """
    if mode == "uniform":
        rows, cols = kdtree_neighbors(
            tx_pos, max_k=max_k, query=bd_centroids
        )
        # rows are bd indices, cols are tx indices -> reorient to (tx, bd)
        return cols, rows
    if mode in ("cell", "nucleus"):
        if polygons is None:
            raise ValueError(f"mode='{mode}' requires polygons")
        from ..geometry.query import points_in_polygons

        areas = (
            polygon_areas
            if polygon_areas is not None
            else polygon_areas_batch(polygons)
        )
        buffers = np.sqrt(np.maximum(areas, 0) / np.pi) * buffer_ratio
        return points_in_polygons(tx_pos, polygons, distances=buffers)
    raise ValueError(f"Unrecognized prediction graph mode: '{mode}'.")


def polygon_areas_batch(polygons) -> np.ndarray:
    """Shoelace areas for a ragged list of (nv, 2) vertex arrays in one
    vectorized pass."""
    n = len(polygons)
    if n == 0:
        return np.zeros(0)
    counts = np.fromiter((len(p) for p in polygons), np.int64, count=n)
    v = np.concatenate(
        [np.asarray(p, np.float64).reshape(-1, 2) for p in polygons]
    )
    if v.shape[0] == 0:
        return np.zeros(n)
    starts = np.concatenate(([0], np.cumsum(counts)))
    # next vertex within each ring: roll each segment by -1
    nxt = np.arange(1, v.shape[0] + 1)
    nxt[starts[1:] - 1] = starts[:-1]
    cross = v[:, 0] * v[nxt, 1] - v[:, 1] * v[nxt, 0]
    sums = np.add.reduceat(cross, starts[:-1])
    sums[counts == 0] = 0.0
    return 0.5 * np.abs(sums)
