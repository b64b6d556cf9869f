"""Per-polygon shape features: area, convexity, elongation, circularity.

Re-implements the reference's morphology props
(reference: src/segger/geometry/morphology.py:4-43) without GEOS:
convex hulls via scipy, min-area rectangles via rotating calipers.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
from scipy.spatial import ConvexHull


def polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _min_rotated_rect_dims(hull_pts: np.ndarray):
    """Width/height of the minimum-area rotated rectangle (rotating
    calipers over hull edges)."""
    edges = np.roll(hull_pts, -1, axis=0) - hull_pts
    angles = np.arctan2(edges[:, 1], edges[:, 0])
    best = (np.inf, 0.0, 0.0)
    for th in angles:
        c, s = np.cos(-th), np.sin(-th)
        R = np.array([[c, -s], [s, c]])
        rot = hull_pts @ R.T
        w = rot[:, 0].max() - rot[:, 0].min()
        h = rot[:, 1].max() - rot[:, 1].min()
        if w * h < best[0]:
            best = (w * h, w, h)
    return best[1], best[2]


def polygon_props(
    polygons,
    area: bool = True,
    convexity: bool = True,
    elongation: bool = True,
    circularity: bool = True,
) -> pd.DataFrame:
    """Shape-feature table, one row per polygon
    (reference: morphology.py:4-43 — area, convex-hull area ratio,
    min-rotated-rect aspect vs envelope, area / bounding-radius^2)."""
    rows = []
    for poly in polygons:
        poly = np.asarray(poly, dtype=np.float64)
        rec = {}
        a = polygon_area(poly)
        if area:
            rec["area"] = a
        hull = None
        if convexity or elongation:
            try:
                hull = ConvexHull(poly)
            except Exception:
                hull = None
        if convexity:
            ha = hull.volume if hull is not None else a  # 2D: volume=area
            rec["convexity"] = a / ha if ha > 0 else 1.0
        if elongation:
            if hull is not None:
                w, h = _min_rotated_rect_dims(poly[hull.vertices])
            else:
                w = poly[:, 0].max() - poly[:, 0].min()
                h = poly[:, 1].max() - poly[:, 1].min()
            lo, hi = min(w, h), max(w, h)
            rec["elongation"] = lo / hi if hi > 0 else 1.0
        if circularity:
            c = poly.mean(axis=0)
            r = np.sqrt(((poly - c) ** 2).sum(axis=1)).max()
            rec["circularity"] = a / (np.pi * r * r) if r > 0 else 1.0
        rows.append(rec)
    return pd.DataFrame(rows)
