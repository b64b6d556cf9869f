"""Density-adaptive quadtree over 2D points, with the exactly-once
labeling invariant.

Boxes are half-open [x0, x1) x [y0, y1) and split at midpoints, so every
point lies in exactly one leaf by construction.  The prediction halo's
(point, leaf) membership runs the native core's grid join
(``csrc/spatial.cpp``); ``expanded_label_multi_plain`` is its NumPy
version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class QuadTree:
    """Adaptive quadtree; leaves partition the (slightly expanded)
    bounding box of the input points."""

    bounds: np.ndarray            # (4,) root x0, y0, x1, y1
    leaf_bounds: np.ndarray       # (L, 4) half-open leaf boxes
    leaf_counts: np.ndarray       # (L,) points per leaf at build time
    max_leaf_size: int
    max_depth: int = 24
    # implicit tree for O(depth) vectorized labeling: children[n, q] =
    # child node of node n for quadrant q (-1 at leaves); node_leaf[n] =
    # leaf index of a leaf node else -1; node_bounds[n] = (x0, y0, x1, y1)
    children: Optional[np.ndarray] = None
    node_leaf: Optional[np.ndarray] = None
    node_bounds: Optional[np.ndarray] = None

    @classmethod
    def build(
        cls,
        points: np.ndarray,
        max_leaf_size: int,
        max_depth: int = 24,
    ) -> "QuadTree":
        points = np.asarray(points, dtype=np.float64)
        x0, y0 = points.min(axis=0)
        x1, y1 = points.max(axis=0)
        # expand the upper edge so max-coordinate points fall inside the
        # half-open root box
        eps = max(x1 - x0, y1 - y0, 1.0) * 1e-9
        x1, y1 = x1 + eps, y1 + eps

        leaves: List[tuple] = []
        counts: List[int] = []
        children: List[list] = []
        node_leaf: List[int] = []
        node_bounds: List[tuple] = []

        def new_node(bx) -> int:
            nid = len(children)
            children.append([-1, -1, -1, -1])
            node_leaf.append(-1)
            node_bounds.append(bx)
            return nid

        def split(idx: np.ndarray, bx, depth: int, nid: int):
            if idx.size <= max_leaf_size or depth >= max_depth:
                node_leaf[nid] = len(leaves)
                leaves.append(bx)
                counts.append(idx.size)
                return
            bx0, by0, bx1, by1 = bx
            mx, my = (bx0 + bx1) / 2, (by0 + by1) / 2
            px, py = points[idx, 0], points[idx, 1]
            right = px >= mx
            top = py >= my
            quads = [
                (idx[~right & ~top], (bx0, by0, mx, my)),
                (idx[right & ~top], (mx, by0, bx1, my)),
                (idx[~right & top], (bx0, my, mx, by1)),
                (idx[right & top], (mx, my, bx1, by1)),
            ]
            for q, (sub_idx, sub_bx) in enumerate(quads):
                cid = new_node(sub_bx)
                children[nid][q] = cid
                split(sub_idx, sub_bx, depth + 1, cid)

        root = new_node((x0, y0, x1, y1))
        split(np.arange(len(points)), (x0, y0, x1, y1), 0, root)
        return cls(
            bounds=np.array([x0, y0, x1, y1]),
            leaf_bounds=np.array(leaves, dtype=np.float64).reshape(-1, 4),
            leaf_counts=np.array(counts, dtype=np.int64),
            max_leaf_size=max_leaf_size,
            max_depth=max_depth,
            children=np.array(children, dtype=np.int64),
            node_leaf=np.array(node_leaf, dtype=np.int64),
            node_bounds=np.array(node_bounds, dtype=np.float64),
        )

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_bounds)

    def label(self, points: np.ndarray) -> np.ndarray:
        """Leaf index per point; -1 for points outside the root box.

        Vectorized level-by-level descent of the implicit tree; a
        hand-built instance without one falls back to a per-leaf scan."""
        points = np.asarray(points, dtype=np.float64)
        x, y = points[:, 0], points[:, 1]

        if self.children is None:
            out = np.full(len(points), -1, dtype=np.int64)
            for li, (x0, y0, x1, y1) in enumerate(self.leaf_bounds):
                m = (x >= x0) & (x < x1) & (y >= y0) & (y < y1)
                out[m] = li
            return out

        rx0, ry0, rx1, ry1 = self.bounds
        inside = (x >= rx0) & (x < rx1) & (y >= ry0) & (y < ry1)
        node = np.zeros(len(points), dtype=np.int64)  # root id = 0
        active = inside & (self.node_leaf[0] < 0)
        while active.any():
            nb = self.node_bounds[node[active]]
            mx = (nb[:, 0] + nb[:, 2]) / 2
            my = (nb[:, 1] + nb[:, 3]) / 2
            quad = (
                (x[active] >= mx).astype(np.int64)
                + 2 * (y[active] >= my).astype(np.int64)
            )
            node[active] = self.children[node[active], quad]
            active = inside & (self.node_leaf[node] < 0)
        return np.where(inside, self.node_leaf[node], -1)

    def is_exactly_once(self, points: np.ndarray) -> bool:
        """Validity check (reference: quadtree.py:261-270): every point
        inside the root box hits exactly one leaf, every other none."""
        points = np.asarray(points, dtype=np.float64)
        x, y = points[:, 0], points[:, 1]
        hits = np.zeros(len(points), dtype=np.int64)
        for (x0, y0, x1, y1) in self.leaf_bounds:
            hits += (x >= x0) & (x < x1) & (y >= y0) & (y < y1)
        rx0, ry0, rx1, ry1 = self.bounds
        inside = (x >= rx0) & (x < rx1) & (y >= ry0) & (y < ry1)
        return bool((hits[inside] == 1).all() and (hits[~inside] == 0).all())

    def shrunk_mask(
        self, points: np.ndarray, labels: np.ndarray, margin: float
    ) -> np.ndarray:
        """True where a point lies inside its leaf shrunk by ``margin`` on
        every side: the training interior mask.  A leaf that the margin
        empties halves its margin until some point survives or the
        margin vanishes, as the reference does."""
        points = np.asarray(points, dtype=np.float64)
        out = np.zeros(len(points), dtype=bool)
        x, y = points[:, 0], points[:, 1]
        order = np.argsort(labels, kind="stable")
        lab_sorted = labels[order]
        starts = np.searchsorted(lab_sorted, np.arange(self.n_leaves))
        ends = np.searchsorted(
            lab_sorted, np.arange(self.n_leaves), side="right"
        )
        for li, (x0, y0, x1, y1) in enumerate(self.leaf_bounds):
            idx = order[starts[li] : ends[li]]
            if idx.size == 0:
                continue
            m = margin
            while True:
                inner = (
                    (x[idx] >= x0 + m)
                    & (x[idx] < x1 - m)
                    & (y[idx] >= y0 + m)
                    & (y[idx] < y1 - m)
                )
                if inner.any() or m < 1e-6:
                    break
                m /= 2
            out[idx[inner]] = True
        return out

    def expanded_label_multi(
        self, points: np.ndarray, margin: float
    ) -> tuple[np.ndarray, np.ndarray]:
        """(point_idx, leaf_idx) pairs for leaves expanded by ``margin``:
        the prediction halo membership (a point can belong to several
        expanded leaves), from the native core's grid join, in the order
        its threads finish."""
        from .. import native

        return native.points_in_boxes(points, self.leaf_bounds, margin)

    def expanded_label_multi_plain(
        self, points: np.ndarray, margin: float
    ) -> tuple[np.ndarray, np.ndarray]:
        """:meth:`expanded_label_multi` in NumPy (the plain version): each
        expanded leaf scans only the points of the leaves its box
        intersects, plus the points outside the root."""
        points = np.asarray(points, dtype=np.float64)
        x, y = points[:, 0], points[:, 1]
        labels = self.label(points)
        order = np.argsort(labels, kind="stable")
        lab_sorted = labels[order]
        starts = np.searchsorted(lab_sorted, np.arange(self.n_leaves))
        ends = np.searchsorted(
            lab_sorted, np.arange(self.n_leaves), side="right"
        )
        lb = self.leaf_bounds
        outside = np.where(labels == -1)[0]
        p_out, l_out = [], []
        for li, (x0, y0, x1, y1) in enumerate(lb):
            ex0, ey0 = x0 - margin, y0 - margin
            ex1, ey1 = x1 + margin, y1 + margin
            cand_leaves = np.where(
                (lb[:, 0] < ex1)
                & (lb[:, 2] > ex0)
                & (lb[:, 1] < ey1)
                & (lb[:, 3] > ey0)
            )[0]
            idx_parts = [
                order[starts[cl] : ends[cl]] for cl in cand_leaves
            ]
            if outside.size:
                idx_parts.append(outside)
            idx = (
                np.concatenate(idx_parts)
                if idx_parts
                else np.zeros(0, np.int64)
            )
            m = (
                (x[idx] >= ex0)
                & (x[idx] < ex1)
                & (y[idx] >= ey0)
                & (y[idx] < ey1)
            )
            hit = idx[m]
            p_out.append(hit)
            l_out.append(np.full(hit.size, li, dtype=np.int64))
        return np.concatenate(p_out), np.concatenate(l_out)
