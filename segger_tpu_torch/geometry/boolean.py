"""Polygon-polygon boolean intersection (GEOS-free).

Implements the cell∩nucleus geometry the reference computes in its
Xenium reader (reference: src/segger/io/preprocessor.py:487-501 — the
``cells.intersection(nuclei)`` call; note the block REPLACING nucleus
geometry with the intersection is commented out there, so the
reference's live behavior keeps vendor rings).  The port exposes both
behaviors behind ``XeniumPreprocessor(nucleus_strategy=...)``; this
module provides the 'intersect' path without a GEOS dependency.

Algorithm — edge fragmentation + midpoint classification + ring walk
(Weiler–Atherton in spirit, on simple rings):

  1. split every edge of A at its intersections with edges of B (and
     vice versa),
  2. keep A-fragments whose midpoint lies inside B and B-fragments
     whose midpoint lies inside A,
  3. stitch kept fragments into closed rings by endpoint adjacency on
     an eps-rounded vertex grid.

Degenerate inputs (shared collinear edges, touching-only contact) can
leave an open chain; ``polygon_intersection`` then raises
``DegenerateIntersection`` and the caller keeps the vendor geometry for
that polygon (the reader logs how many fell back).  The port's copy of
``segger_tpu.geometry.boolean``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .morphology import polygon_area
from .query import _ray_cast_inside


class DegenerateIntersection(Exception):
    """Fragment stitching could not close a ring (degenerate contact)."""


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _seg_intersections(p0, p1, q0, q1, eps=1e-12):
    """Intersection parameters of segment p0->p1 against segments
    q0->q1 (vectorized over q).  Returns t values in (0, 1) along p."""
    d = p1 - p0                       # (2,)
    e = q1 - q0                       # (M, 2)
    w = q0 - p0                       # (M, 2)
    denom = d[0] * e[:, 1] - d[1] * e[:, 0]
    ok = np.abs(denom) > eps
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (w[:, 0] * e[:, 1] - w[:, 1] * e[:, 0]) / denom
        u = (w[:, 0] * d[1] - w[:, 1] * d[0]) / denom
    hit = ok & (t > eps) & (t < 1 - eps) & (u >= -eps) & (u <= 1 + eps)
    return t[hit]


def _fragments(poly, other, eps):
    """Split ``poly``'s edges at crossings with ``other``; return the
    sub-segments whose midpoints are strictly inside ``other``."""
    v0 = poly
    v1 = np.roll(poly, -1, axis=0)
    o0 = other
    o1 = np.roll(other, -1, axis=0)
    frags = []
    for a, b in zip(v0, v1):
        ts = _seg_intersections(a, b, o0, o1)
        cuts = np.concatenate(([0.0], np.sort(ts), [1.0]))
        pts = a[None, :] + np.outer(cuts, b - a)
        for s, e in zip(pts[:-1], pts[1:]):
            if np.abs(e - s).max() < eps:
                continue
            frags.append((s, e))
    if not frags:
        return np.zeros((0, 2, 2))
    frags = np.array(frags)            # (F, 2, 2)
    mids = frags.mean(axis=1)
    keep = _ray_cast_inside(mids, other)
    return frags[keep]


def _stitch(frags, eps):
    """Walk fragment endpoint adjacency into closed rings."""
    if len(frags) == 0:
        return []

    def key(p):
        return (round(float(p[0]) / eps), round(float(p[1]) / eps))

    start_map = {}
    for i, (s, _) in enumerate(frags):
        start_map.setdefault(key(s), []).append(i)
    used = np.zeros(len(frags), bool)
    rings = []
    for i in range(len(frags)):
        if used[i]:
            continue
        chain = [frags[i][0]]
        used[i] = True
        cur = frags[i][1]
        first = key(frags[i][0])
        guard = 0
        while key(cur) != first:
            chain.append(cur)
            nxts = [j for j in start_map.get(key(cur), []) if not used[j]]
            if not nxts:
                raise DegenerateIntersection(
                    "open fragment chain (touching/collinear contact)"
                )
            j = nxts[0]
            used[j] = True
            cur = frags[j][1]
            guard += 1
            if guard > len(frags) + 1:
                raise DegenerateIntersection("non-terminating ring walk")
        if len(chain) >= 3:
            rings.append(np.array(chain))
    return rings


def polygon_intersection(
    a: np.ndarray, b: np.ndarray, eps: float = 1e-9
) -> List[np.ndarray]:
    """Intersection of two simple rings as a list of (V, 2) rings
    (empty when disjoint).

    Raises :class:`DegenerateIntersection` on inputs the ring walk
    cannot close (shared collinear edges / point contact) — callers
    fall back to the uncut geometry.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    # bbox reject
    if (a.min(0) > b.max(0)).any() or (b.min(0) > a.max(0)).any():
        return []
    # the ring walk alternates A- and B-fragments head-to-tail, which
    # requires a consistent winding — normalize both to CCW
    a = a if _signed_area(a) >= 0 else a[::-1]
    b = b if _signed_area(b) >= 0 else b[::-1]
    a_in_b = _ray_cast_inside(a, b)
    b_in_a = _ray_cast_inside(b, a)
    fa = _fragments(a, b, eps)
    fb = _fragments(b, a, eps)
    # containment fast paths (no boundary crossings)
    if a_in_b.all() and len(fb) == 0:
        return [a]
    if b_in_a.all() and len(fa) == 0:
        return [b]
    frags = np.concatenate([fa, fb]) if len(fa) or len(fb) else fa
    if len(frags) == 0:
        return []
    return _stitch(frags, eps)


def largest_ring(rings: List[np.ndarray]) -> "np.ndarray | None":
    """The ring with the largest absolute area, or None."""
    if not rings:
        return None
    areas = [abs(polygon_area(r)) for r in rings]
    return rings[int(np.argmax(areas))]
