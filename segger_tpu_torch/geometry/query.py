"""Spatial joins: point-in-(buffered)-polygon without GPU geometry libs.

The reference delegates to cuSpatial's quadtree spatial join
(reference: src/segger/geometry/query.py:21-176).  Here the join is a
KDTree prefilter (points within each polygon's bounding radius) followed
by an exact vectorized test:

  inside OR distance-to-boundary <= d

which is the exact Minkowski-sum ("buffer by d") containment — stronger
than the reference's approximate geometric buffer + contains.
:func:`points_in_polygons` runs the native core's grid-hash join
(``csrc/spatial.cpp``, one polygon per OpenMP task);
:func:`points_in_polygons_kdtree`, NumPy vectorized per polygon over its
candidate points, is its plain version and gives the same pairs.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import KDTree


def _point_segment_dist2(p: np.ndarray, a: np.ndarray, b: np.ndarray):
    """Squared distance of points p (N,2) to segments a->b (M,2) pairwise.

    Returns (N, M) matrix.
    """
    ab = b - a  # (M,2)
    ap = p[:, None, :] - a[None, :, :]  # (N,M,2)
    denom = np.maximum((ab * ab).sum(-1), 1e-30)  # (M,)
    t = np.clip((ap * ab[None]).sum(-1) / denom, 0.0, 1.0)  # (N,M)
    proj = a[None] + t[..., None] * ab[None]  # (N,M,2)
    d = p[:, None, :] - proj
    return (d * d).sum(-1)


def _ray_cast_inside(p: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd rule point-in-polygon test. p: (N,2)."""
    x, y = p[:, 0], p[:, 1]
    xa, ya = poly[:, 0], poly[:, 1]
    xb, yb = np.roll(xa, -1), np.roll(ya, -1)
    # crossing test per edge, broadcast (N, V)
    cond = (ya[None] > y[:, None]) != (yb[None] > y[:, None])
    with np.errstate(divide="ignore", invalid="ignore"):
        xcross = xa[None] + (y[:, None] - ya[None]) / (yb[None] - ya[None]) * (
            xb[None] - xa[None]
        )
    crossings = (cond & (x[:, None] < xcross)).sum(axis=1)
    return (crossings % 2).astype(bool)


def points_in_polygon(
    points: np.ndarray, poly: np.ndarray, distance: float = 0.0
) -> np.ndarray:
    """Boolean mask: point inside polygon or within ``distance`` of its
    boundary."""
    inside = _ray_cast_inside(points, poly)
    if distance > 0:
        near = ~inside
        if near.any():
            d2 = _point_segment_dist2(
                points[near], poly, np.roll(poly, -1, axis=0)
            ).min(axis=1)
            inside = inside.copy()
            inside[near] = d2 <= distance * distance
    return inside


def points_in_polygons(
    points: np.ndarray,
    polygons: Sequence[np.ndarray],
    distances: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Join: which points fall in which (buffered) polygons.

    Returns ``(point_idx, polygon_idx)`` int64 COO arrays in canonical
    order, from the native core's grid-hash join."""
    from .. import native

    points = np.asarray(points, dtype=np.float64)
    if distances is None:
        distances = np.zeros(len(polygons))
    return _canonical_join_order(
        *native.points_in_polygons(points, polygons, distances))


def points_in_polygons_kdtree(
    points: np.ndarray,
    polygons: Sequence[np.ndarray],
    distances: Optional[np.ndarray] = None,
    batch_points: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`points_in_polygons` as a KDTree prefilter on each polygon's
    bounding radius and the exact NumPy test on its candidates (the plain
    version)."""
    points = np.asarray(points, dtype=np.float64)
    if distances is None:
        distances = np.zeros(len(polygons))

    tree = KDTree(points)
    p_idx, g_idx = [], []
    for gi, poly in enumerate(polygons):
        poly = np.asarray(poly, dtype=np.float64)
        c = poly.mean(axis=0)
        r = np.sqrt(((poly - c) ** 2).sum(axis=1)).max() + distances[gi]
        cand = np.asarray(tree.query_ball_point(c, r + 1e-9))
        if cand.size == 0:
            continue
        for s in range(0, cand.size, batch_points):
            sub = cand[s : s + batch_points]
            hit = points_in_polygon(points[sub], poly, distances[gi])
            if hit.any():
                p_idx.append(sub[hit])
                g_idx.append(np.full(int(hit.sum()), gi, dtype=np.int64))
    if not p_idx:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return _canonical_join_order(
        np.concatenate(p_idx), np.concatenate(g_idx)
    )


def _canonical_join_order(p_idx: np.ndarray, g_idx: np.ndarray):
    """Polygon-major, point-minor edge order.

    The grid join appends per-thread buffers in completion order (and
    the KDTree path follows ball-query traversal order): the same edge
    SET in a run-dependent ORDER, which would leak into padded-CSR slot
    assignment and the candidate argmax tie-breaks.  One lexsort makes
    every path canonical."""
    order = np.lexsort((p_idx, g_idx))
    return p_idx[order], g_idx[order]


def polygons_in_polygons(
    inner: Sequence[np.ndarray],
    outer: Sequence[np.ndarray],
    mode: str = "centroid",
) -> Tuple[np.ndarray, np.ndarray]:
    """Polygon-in-polygon join (reference: geometry/query.py:244-285,
    a geopandas sjoin).

    ``mode='centroid'`` joins by inner-polygon centroid containment (the
    practical predicate for cell-in-tile assignment); ``mode='all'``
    requires every inner vertex inside the outer polygon.

    Returns (inner_idx, outer_idx) COO arrays.
    """
    cents = np.array(
        [np.asarray(p).mean(axis=0) for p in inner]
    ).reshape(-1, 2)
    if mode == "centroid":
        return points_in_polygons(cents, outer)
    if mode == "all":
        p_idx, o_idx = [], []
        for oi, op in enumerate(outer):
            op = np.asarray(op)
            for ii, ip in enumerate(inner):
                if points_in_polygon(np.asarray(ip), op).all():
                    p_idx.append(ii)
                    o_idx.append(oi)
        return (
            np.asarray(p_idx, np.int64),
            np.asarray(o_idx, np.int64),
        )
    raise ValueError(f"Unknown mode: {mode!r}")
