"""Boundary geometry helpers: ragged-vertex -> polygon arrays + repair.

Analogue of the reference's shapely-based helpers
(reference: src/segger/io/utils.py:44-159) on plain NumPy polygons; the
port's copy of ``segger_tpu.io.utils``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def contours_to_polygons(
    x: np.ndarray, y: np.ndarray, ids: np.ndarray
) -> Tuple[List[str], List[np.ndarray]]:
    """Group flat vertex arrays by id into per-polygon (V, 2) arrays
    (reference: io/utils.py:44-80).  Vertex order within each id is
    preserved.  Returns (unique ids, polygons) in first-appearance order.
    """
    ids = np.asarray(ids)
    # stable grouping preserving original vertex order, one argsort
    # pass (a per-id boolean scan is O(n_cells * n_vertices) — hours on
    # a 10M-vertex whole-slide boundary table)
    uniq, first_pos, inverse = np.unique(
        ids, return_index=True, return_inverse=True
    )
    order = np.argsort(first_pos, kind="stable")
    verts = np.stack([np.asarray(x), np.asarray(y)], axis=1)
    rows_by_group = np.argsort(inverse, kind="stable")
    counts = np.bincount(inverse, minlength=len(uniq))
    starts = np.concatenate(([0], np.cumsum(counts)))
    out_ids, out_polys = [], []
    for oi in order:
        rows = rows_by_group[starts[oi]:starts[oi + 1]]
        out_ids.append(str(uniq[oi]))
        out_polys.append(verts[rows])
    return out_ids, out_polys


def resort_coordinates(poly: np.ndarray) -> np.ndarray:
    """Angular re-sort of vertices around the centroid — the reference's
    first-line repair for self-intersecting rings (io/utils.py:105-135)."""
    c = poly.mean(axis=0)
    ang = np.arctan2(poly[:, 1] - c[1], poly[:, 0] - c[0])
    return poly[np.argsort(ang, kind="stable")]


def _self_intersects(poly: np.ndarray) -> bool:
    """Exact O(V^2) proper-crossing test between non-adjacent edges
    (cell rings are tens of vertices, so the quadratic cost is
    negligible; needed because shoelace area cannot detect bowties)."""
    n = len(poly)
    if n < 4:
        return False
    a = poly
    b = np.roll(poly, -1, axis=0)
    d = b - a
    # all edge pairs (i, j), j > i + 1, excluding the (0, n-1) wrap pair
    i, j = np.triu_indices(n, k=2)
    wrap = (i == 0) & (j == n - 1)
    i, j = i[~wrap], j[~wrap]
    if i.size == 0:
        return False
    p, r = a[i], d[i]
    q, s2 = a[j], d[j]
    rxs = r[:, 0] * s2[:, 1] - r[:, 1] * s2[:, 0]
    qp = q - p
    t_num = qp[:, 0] * s2[:, 1] - qp[:, 1] * s2[:, 0]
    u_num = qp[:, 0] * r[:, 1] - qp[:, 1] * r[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = t_num / rxs
        u = u_num / rxs
    eps = 1e-12
    cross = (
        (np.abs(rxs) > eps)
        & (t > eps) & (t < 1 - eps)
        & (u > eps) & (u < 1 - eps)
    )
    return bool(cross.any())


def _is_simple_enough(poly: np.ndarray) -> bool:
    """Validity check: >= 3 distinct vertices, nonzero area, and no
    proper self-intersection (the reference repairs bowties with an
    angular re-sort, io/utils.py:105-135 — area alone cannot see
    them)."""
    if len(poly) < 3:
        return False
    if len(np.unique(poly, axis=0)) < 3:
        return False
    x, y = poly[:, 0], poly[:, 1]
    area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    if not area > 0:
        return False
    return not _self_intersects(poly)


def fix_invalid_geometry(
    polygons: List[np.ndarray],
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Repair invalid polygons: drop consecutive duplicate vertices, then
    angular re-sort if degenerate (reference: io/utils.py:105-159; the
    buffer(0) fallback is GEOS-specific and replaced by the re-sort).

    Returns (repaired polygons, keep mask) — polygons that cannot be
    repaired (e.g. < 3 distinct vertices) are flagged for removal.
    """
    out, keep = [], []
    for poly in polygons:
        poly = np.asarray(poly, dtype=np.float64)
        if len(poly) and (poly[0] == poly[-1]).all():
            poly = poly[:-1]  # drop closing vertex
        # drop consecutive duplicates
        if len(poly) > 1:
            d = np.any(np.diff(poly, axis=0) != 0, axis=1)
            poly = poly[np.concatenate([[True], d])]
        if not _is_simple_enough(poly):
            poly = resort_coordinates(poly) if len(poly) >= 3 else poly
        ok = _is_simple_enough(poly)
        out.append(poly)
        keep.append(ok)
    return out, np.asarray(keep, dtype=bool)
