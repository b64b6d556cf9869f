"""Host-side spatial kNN (SciPy KDTree).

The transcript kNN includes the query point itself, and neighbors beyond
``max_dist`` are dropped.  The C++ uniform-grid kNN of the JAX package
(``csrc/spatial.cpp``) waits for a later slice; this is its KDTree
branch.
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
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked kNN: COO ``(rows, cols)`` int32 with rows = query index and
    cols = neighbor index into ``points``."""
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
