"""Tiling and static-shape tile extraction (host side).

Training tiles are quadtree leaves with their cross-tile edges dropped and
an interior mask shrunk by a margin; prediction tiles are quadtree leaves
expanded by a halo margin, with an interior mask so each transcript is
predicted exactly once.  Each tile is
extracted into padded, fixed-shape arrays (:class:`TileGraph`) whose
widths come from a shape bucket shared by every tile of a batch; the
tables are byte for byte those of ``segger_tpu/data/partition.py``.
"""
from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..geometry.quadtree import QuadTree
from ..ops.padded_csr import coo_to_padded_csr, transpose_csr, PaddedCSR
from .assemble import HostGraph
from .graph import TileGraph, pad_axis


@dataclass
class TileSpec:
    """Host-side membership of one tile (global row indices)."""

    tx_rows: np.ndarray       # global tx indices (sorted)
    bd_rows: np.ndarray       # global bd indices (sorted)
    tx_interior: np.ndarray   # bool per tile tx (predict mask)
    bd_interior: np.ndarray   # bool per tile bd
    n_edges: int = 0          # message-passing edges (for bin packing)


def build_tiling(
    graph: HostGraph,
    nodes_per_tile: int = 50_000,
    mode: str = "adaptive",
    side_length: float = 250.0,
) -> QuadTree:
    """Tiling over tx+bd positions jointly
    (reference: data_module.py:242-262).

    ``mode='adaptive'``: density-adaptive quadtree capping nodes/tile.
    ``mode='square'``: fixed-size grid (the reference keeps this for
    benchmarking only; tiling.py:238-300) — expressed as a QuadTree with
    grid leaves so downstream code is identical.
    """
    pos = np.vstack([graph.tx_pos, graph.bd_pos])
    if mode == "adaptive":
        return QuadTree.build(pos, max_leaf_size=nodes_per_tile)
    if mode == "square":
        return square_tiling(pos, side_length)
    raise ValueError(f"Unrecognized tiling strategy: '{mode}'.")


def square_tiling(pos: np.ndarray, side_length: float) -> QuadTree:
    """Fixed-size grid tiling as a QuadTree-shaped object
    (reference: tiling.py:238-300).  The bounds are taken in float64:
    the root box's top edge lies ``1e-9 * extent`` beyond the last point,
    which a float32 sum rounds away (the JAX package's square tiling of a
    float32 graph leaves that point outside every leaf and raises)."""
    pos = np.asarray(pos, dtype=np.float64)
    x0, y0 = pos.min(axis=0)
    x1, y1 = pos.max(axis=0)
    eps = max(x1 - x0, y1 - y0, 1.0) * 1e-9
    x1, y1 = x1 + eps, y1 + eps
    nx = max(1, int(np.ceil((x1 - x0) / side_length)))
    ny = max(1, int(np.ceil((y1 - y0) / side_length)))
    leaves = []
    for gy in range(ny):
        for gx in range(nx):
            leaves.append(
                (
                    x0 + gx * side_length,
                    y0 + gy * side_length,
                    min(x0 + (gx + 1) * side_length, x1),
                    min(y0 + (gy + 1) * side_length, y1),
                )
            )
    tree = QuadTree(
        bounds=np.array([x0, y0, x1, y1]),
        leaf_bounds=np.array(leaves, dtype=np.float64),
        leaf_counts=np.zeros(len(leaves), dtype=np.int64),
        max_leaf_size=0,
    )
    tree.leaf_counts = np.bincount(
        tree.label(pos), minlength=tree.n_leaves
    )
    return tree


def _group_rows_by_label(labels: np.ndarray, n_groups: int,
                         rows: Optional[np.ndarray] = None):
    """Sorted row indices per label in one argsort pass.  With ``rows``,
    groups (row, label) membership pairs instead of positions."""
    order = np.argsort(labels, kind="stable")
    sl = labels[order]
    if rows is not None:
        order = rows[order]
    starts = np.searchsorted(sl, np.arange(n_groups))
    ends = np.searchsorted(sl, np.arange(n_groups), side="right")
    return [np.sort(order[s:e]) for s, e in zip(starts, ends)]


def make_fit_tiles(
    graph: HostGraph, tree: QuadTree, margin: float = 20.0
) -> List[TileSpec]:
    """Training tiles: nodes labelled by leaf, cross-tile edges dropped,
    interior = the leaf shrunk by ``margin``; ``n_edges`` counts the
    tile's tt and sg edges (for bin packing)."""
    tx_lab = tree.label(graph.tx_pos)
    bd_lab = tree.label(graph.bd_pos)
    tx_int = tree.shrunk_mask(graph.tx_pos, tx_lab, margin)
    bd_int = tree.shrunk_mask(graph.bd_pos, bd_lab, margin)

    tt_same = tx_lab[graph.tt_src] == tx_lab[graph.tt_dst]
    sg_same = tx_lab[graph.sg_src] == bd_lab[graph.sg_dst]
    tt_counts = np.bincount(
        tx_lab[graph.tt_dst][tt_same & (tx_lab[graph.tt_dst] >= 0)],
        minlength=tree.n_leaves,
    )
    sg_counts = np.bincount(
        bd_lab[graph.sg_dst][sg_same & (bd_lab[graph.sg_dst] >= 0)],
        minlength=tree.n_leaves,
    )

    tx_groups = _group_rows_by_label(tx_lab, tree.n_leaves)
    bd_groups = _group_rows_by_label(bd_lab, tree.n_leaves)
    tiles = []
    for li in range(tree.n_leaves):
        tx_rows = tx_groups[li]
        bd_rows = bd_groups[li]
        if tx_rows.size == 0:
            continue
        tiles.append(
            TileSpec(
                tx_rows=tx_rows,
                bd_rows=bd_rows,
                tx_interior=tx_int[tx_rows],
                bd_interior=bd_int[bd_rows],
                n_edges=int(tt_counts[li] + sg_counts[li]),
            )
        )
    return tiles


def make_predict_tiles(
    graph: HostGraph, tree: QuadTree, margin: float = 20.0
) -> List[TileSpec]:
    """Prediction tiles: leaf box expanded by ``margin`` (halo) so every
    interior node sees its full receptive field; interior = inside the
    unexpanded leaf, so each transcript is predicted exactly once."""
    tx_lab = tree.label(graph.tx_pos)
    bd_lab = tree.label(graph.bd_pos)
    tx_pairs = tree.expanded_label_multi(graph.tx_pos, margin)
    bd_pairs = tree.expanded_label_multi(graph.bd_pos, margin)

    tx_groups = _group_rows_by_label(tx_pairs[1], tree.n_leaves,
                                     rows=tx_pairs[0])
    bd_groups = _group_rows_by_label(bd_pairs[1], tree.n_leaves,
                                     rows=bd_pairs[0])
    eg = _edge_groups(graph)
    in_tile = np.zeros(graph.n_tx, bool)

    tiles = []
    for li in range(tree.n_leaves):
        tx_rows = tx_groups[li]
        bd_rows = bd_groups[li]
        if tx_rows.size == 0:
            continue
        tx_interior = tx_lab[tx_rows] == li
        bd_interior = bd_lab[bd_rows] == li
        if not tx_interior.any():
            continue
        # edge count for packing: tt edges with both endpoints in tile
        in_tile[tx_rows] = True
        r = eg["tt"].rows(tx_rows)
        ne = int(in_tile[graph.tt_src[r]].sum())
        in_tile[tx_rows] = False
        tiles.append(
            TileSpec(
                tx_rows=tx_rows,
                bd_rows=bd_rows,
                tx_interior=tx_interior,
                bd_interior=bd_interior,
                n_edges=ne,
            )
        )
    return tiles


def _round_up(x: int, m: int, minimum: int = 0) -> int:
    return max(minimum, -(-max(x, 1) // m) * m)


# padded width of the narrow tt edge-stage segment: rows with in-degree
# <= K_LO are sorted first so the edge stage skips the high-degree tail's
# padding (apply_degree_bucketing)
DEGREE_BUCKET_K_LO = 8
# width of the extra-low segment nested inside the lo region
DEGREE_BUCKET_K_XLO = 4


@dataclass(frozen=True)
class BucketShape:
    n_tx: int
    n_bd: int
    k_tt: int
    k_tb: int
    k_cand: int
    e_sg: int
    k_tt_t: int = 8   # transpose widths (max out-degree per src node)
    k_tb_t: int = 4
    # first n_lo tx rows have in-degree <= k_lo; n_lo merges by MIN, the
    # widths by max; n_lo == 0 disables
    n_lo: int = 0
    k_lo: int = 0
    k_lo_t: int = 4
    k_hi_t: int = 4
    # rows [0, n_xlo) have in-degree <= k_xlo; merges by MIN; 0 disables
    n_xlo: int = 0
    k_xlo: int = 0
    k_xlo_t: int = 4


class _EdgeGroups:
    """Key-sorted edge index: for each node, the rows of the edge arrays
    keyed by it, so per-tile edge selection is O(E_tile)."""

    def __init__(self, key: np.ndarray, n_keys: int):
        self.order = np.argsort(key, kind="stable")
        counts = np.bincount(key, minlength=n_keys)
        self.indptr = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(counts)]
        )

    @classmethod
    def from_arrays(cls, order: np.ndarray, indptr: np.ndarray):
        """Wrap precomputed (possibly memmapped) index arrays: a graph
        plane (``data.assemble.save_host_graph_plane``) stores them, so
        the run phase never argsorts O(E) in RAM."""
        self = cls.__new__(cls)
        self.order = order
        self.indptr = indptr
        return self

    def rows(self, nodes: np.ndarray) -> np.ndarray:
        """Edge rows whose key is in ``nodes`` (grouped by node)."""
        starts = self.indptr[nodes]
        counts = self.indptr[nodes + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        cum = np.concatenate([np.zeros(1, np.int64),
                              np.cumsum(counts)[:-1]])
        pos = (np.arange(total) - np.repeat(cum, counts)
               + np.repeat(starts, counts))
        return self.order[pos]


def _edge_groups(graph: HostGraph) -> dict:
    """Lazy per-graph edge indexes, keyed by the tile-row endpoint of
    each edge type (tt/cand: tx; sg: bd)."""
    eg = graph.__dict__.get("_edge_groups_cache")
    if eg is None:
        eg = {
            "tt": _EdgeGroups(graph.tt_dst, graph.n_tx),
            "sg": _EdgeGroups(graph.sg_dst, graph.n_bd),
            "cand": _EdgeGroups(graph.cand_src, graph.n_tx),
        }
        graph.__dict__["_edge_groups_cache"] = eg
    return eg


def _tile_edges(graph: HostGraph, spec: TileSpec):
    """Tile-local edge lists ``(tt_s, tt_d, sg_s, sg_d, ca_s, ca_d)``
    (indices into the tile's sorted ``tx_rows``/``bd_rows``), cached on
    the spec: ``tile_bucket`` and ``extract_tile`` both need them.  A
    graph loaded as a memmapped plane is flagged ``_transient_tile_edges``:
    its specs cache nothing, so the edges of all tiles are never resident
    at once, and each call recomputes O(E_tile)."""
    cached = getattr(spec, "_edges", None)
    if cached is not None:
        return cached
    eg = _edge_groups(graph)
    # per-thread global->local maps: only the tile's rows are written and
    # reset, so a call is O(N_tile), and planning threads do not collide
    scratch = graph.__dict__.get("_tile_map_scratch")
    if scratch is None:
        scratch = threading.local()
        graph.__dict__["_tile_map_scratch"] = scratch
    if not hasattr(scratch, "maps"):
        scratch.maps = (np.full(graph.n_tx, -1, np.int32),
                        np.full(graph.n_bd, -1, np.int32))
    tx_map, bd_map = scratch.maps
    tx_map[spec.tx_rows] = np.arange(spec.tx_rows.size, dtype=np.int32)
    bd_map[spec.bd_rows] = np.arange(spec.bd_rows.size, dtype=np.int32)

    def sel(rows_idx, src, dst, smap, dmap):
        # rows_idx ascends within each node's group (the stable per-key
        # order keeps the edge order), so plane reads stay near-sequential
        s = smap[src[rows_idx]]
        d = dmap[dst[rows_idx]]
        keep = (s >= 0) & (d >= 0)
        return s[keep], d[keep]

    tt_s, tt_d = sel(eg["tt"].rows(spec.tx_rows),
                     graph.tt_src, graph.tt_dst, tx_map, tx_map)
    sg_s, sg_d = sel(eg["sg"].rows(spec.bd_rows),
                     graph.sg_src, graph.sg_dst, tx_map, bd_map)
    ca_s, ca_d = sel(eg["cand"].rows(spec.tx_rows),
                     graph.cand_src, graph.cand_dst, tx_map, bd_map)
    tx_map[spec.tx_rows] = -1
    bd_map[spec.bd_rows] = -1
    edges = (tt_s, tt_d, sg_s, sg_d, ca_s, ca_d)
    if not graph.__dict__.get("_transient_tile_edges", False):
        spec._edges = edges
    return edges


def tile_bucket(
    graph: HostGraph, spec: TileSpec,
    round_tx: int = 256, round_bd: int = 64,
) -> BucketShape:
    """Padded bucket shape for a tile (degrees rounded so few distinct
    shapes occur)."""
    tt_s, tt_d, sg_s, sg_d, ca_s, ca_d = _tile_edges(graph, spec)
    def deg(d, n):
        return int(np.bincount(d, minlength=max(n, 1)).max()) if d.size else 1

    # degree-bucketing stats: n_lo is an upper bound on the merged lo
    # region (MIN merge), and k_lo_t / k_xlo_t are computed against this
    # tile's full lo / xlo sets, which contain any smaller merged prefix
    k_lo = DEGREE_BUCKET_K_LO
    k_xlo = DEGREE_BUCKET_K_XLO
    n_tx_local = spec.tx_rows.size
    if tt_d.size:
        degs = np.bincount(tt_d, minlength=n_tx_local)
        lo_rows = degs <= k_lo
        n_lo = int(lo_rows.sum()) // 8 * 8
        lo_edges = lo_rows[tt_d]
        k_lo_t = _round_up(deg(tt_s[lo_edges], n_tx_local), 4)
        xlo_rows = degs <= k_xlo
        n_xlo = int(xlo_rows.sum()) // 8 * 8
        xlo_edges = xlo_rows[tt_d]
        k_xlo_t = _round_up(deg(tt_s[xlo_edges], n_tx_local), 4)
    else:
        n_lo = n_tx_local // 8 * 8
        k_lo_t = 4
        n_xlo = n_lo
        k_xlo_t = 4

    return BucketShape(
        n_tx=_round_up(n_tx_local, round_tx),
        n_bd=_round_up(spec.bd_rows.size, round_bd),
        k_tt=_round_up(deg(tt_d, n_tx_local), 4),
        k_tb=_round_up(deg(sg_d, spec.bd_rows.size), 8),
        k_cand=_round_up(deg(ca_s, n_tx_local), 4),
        e_sg=_round_up(sg_s.size, 256),
        k_tt_t=_round_up(deg(tt_s, n_tx_local), 4),
        k_tb_t=max(deg(sg_s, n_tx_local), 1),
        n_lo=n_lo,
        k_lo=k_lo,
        k_lo_t=k_lo_t,
        # the merged lo boundary can demote lo rows into the hi region,
        # growing hi out-degrees: k_tt_t is the safe width
        k_hi_t=_round_up(deg(tt_s, n_tx_local), 4),
        n_xlo=n_xlo,
        k_xlo=k_xlo,
        k_xlo_t=k_xlo_t,
    )


def merge_buckets(shapes: Sequence[BucketShape]) -> BucketShape:
    """Least upper bound of bucket shapes (for stacking tiles).

    ``n_lo``/``n_xlo`` merge by MIN, quantized down to a coarse grid, and
    are zeroed when the table is already narrow or the segment is too
    small to pay for its own launch."""
    k_tt = max(s.k_tt for s in shapes)
    n_tx = max(s.n_tx for s in shapes)
    n_lo = min(s.n_lo for s in shapes)
    k_lo = max(s.k_lo for s in shapes)
    n_xlo = min(s.n_xlo for s in shapes)
    k_xlo = max(s.k_xlo for s in shapes)
    q = max(8, (n_tx // 16) // 8 * 8)
    n_lo = (n_lo // q) * q
    if k_tt <= k_lo or n_lo < n_tx // 4:
        n_lo = k_lo = 0
    n_xlo = min((n_xlo // q) * q, n_lo)
    if n_lo == 0 or k_lo <= k_xlo or n_xlo < n_tx // 4:
        n_xlo = k_xlo = 0
    return BucketShape(
        n_tx=n_tx,
        n_bd=max(s.n_bd for s in shapes),
        k_tt=k_tt,
        k_tb=max(s.k_tb for s in shapes),
        k_cand=max(s.k_cand for s in shapes),
        e_sg=max(s.e_sg for s in shapes),
        k_tt_t=max(s.k_tt_t for s in shapes),
        k_tb_t=max(s.k_tb_t for s in shapes),
        n_lo=n_lo,
        k_lo=k_lo,
        k_lo_t=max(s.k_lo_t for s in shapes),
        k_hi_t=max(s.k_hi_t for s in shapes),
        n_xlo=n_xlo,
        k_xlo=k_xlo,
        k_xlo_t=max(s.k_xlo_t for s in shapes),
    )


def _sampler_structure(
    clusters: np.ndarray, interior: np.ndarray, n_local: int,
    n_pad: int, n_clusters: int,
):
    """Triplet-sampler block layout for one tile: node rows sorted by
    cluster among loss-valid nodes (interior & clustered), padding last,
    plus per-cluster valid counts."""
    valid = np.zeros(n_pad, bool)
    valid[:n_local] = interior & (clusters[:n_local] >= 0)
    lab = np.where(valid, np.clip(clusters, 0, None), n_clusters)
    sorted_idx = np.argsort(lab[:n_pad], kind="stable").astype(np.int32)
    counts = np.bincount(
        lab[valid], minlength=n_clusters
    )[:n_clusters].astype(np.int32)
    return sorted_idx, counts


def _strip_major_order(pos: np.ndarray, strip_height: float = 5.0):
    """Locality ordering: sort by y-strip of the kNN radius, then x, so
    neighbor indices stay close and gathers stay local."""
    strip = np.floor(pos[:, 1] / strip_height).astype(np.int64)
    return np.lexsort((pos[:, 0], strip))


def extract_tile(
    graph: HostGraph, spec: TileSpec, bucket: BucketShape
) -> TileGraph:
    """Materialize one tile as a padded, fixed-shape NumPy TileGraph.

    Valid nodes occupy the leading rows in strip-major locality order."""
    tt_s0, tt_d0, sg_s0, sg_d0, ca_s0, ca_d0 = _tile_edges(graph, spec)

    perm = _strip_major_order(graph.tx_pos[spec.tx_rows])
    spec = TileSpec(
        tx_rows=spec.tx_rows[perm],
        bd_rows=spec.bd_rows,
        tx_interior=spec.tx_interior[perm],
        bd_interior=spec.bd_interior,
        n_edges=spec.n_edges,
    )
    ntx, nbd = spec.tx_rows.size, spec.bd_rows.size
    if ntx > bucket.n_tx or nbd > bucket.n_bd:
        raise ValueError("tile exceeds its bucket shape")

    padn = pad_axis

    # relabel tx endpoints into the strip-major order: new = inv[old]
    inv = np.empty(max(ntx, 1), np.int64)
    inv[perm] = np.arange(ntx)
    tt_s, tt_d = inv[tt_s0], inv[tt_d0]
    sg_s, sg_d = inv[sg_s0], sg_d0
    ca_s, ca_d = inv[ca_s0], ca_d0

    tt = coo_to_padded_csr(tt_d, tt_s, n_dst=bucket.n_tx, k=bucket.k_tt)
    tb = coo_to_padded_csr(sg_d, sg_s, n_dst=bucket.n_bd, k=bucket.k_tb)
    cand = coo_to_padded_csr(ca_s, ca_d, n_dst=bucket.n_tx, k=bucket.k_cand)
    # degree bucketing rebuilds the tt transposes from the permuted table
    will_bucket = bucket.n_lo > 0 and bucket.k_lo > 0
    tt_t = (
        None if will_bucket
        else transpose_csr(tt, n_src=bucket.n_tx, k=bucket.k_tt_t)
    )
    tb_t = transpose_csr(tb, n_src=bucket.n_tx, k=bucket.k_tb_t)

    tx_ss, tx_sc = _sampler_structure(
        padn(graph.tx_cluster[spec.tx_rows], bucket.n_tx, -1),
        spec.tx_interior, ntx, bucket.n_tx,
        graph.tx_similarity.shape[0],
    )
    bd_ss, bd_sc = _sampler_structure(
        padn(graph.bd_cluster[spec.bd_rows], bucket.n_bd, -1),
        spec.bd_interior, nbd, bucket.n_bd,
        graph.bd_similarity.shape[0],
    )

    e_sg = bucket.e_sg
    n_sg = min(sg_s.size, e_sg)

    tile = TileGraph(
        tx_gene=padn(graph.tx_gene[spec.tx_rows], bucket.n_tx),
        tx_pos=padn(graph.tx_pos[spec.tx_rows], bucket.n_tx),
        tx_cluster=padn(graph.tx_cluster[spec.tx_rows], bucket.n_tx, -1),
        tx_index=padn(
            graph.tx_index[spec.tx_rows].astype(np.int32), bucket.n_tx, -1
        ),
        tx_valid=padn(np.ones(ntx, bool), bucket.n_tx),
        tx_interior=padn(spec.tx_interior, bucket.n_tx),
        bd_x=padn(graph.bd_x[spec.bd_rows], bucket.n_bd),
        bd_pos=padn(graph.bd_pos[spec.bd_rows], bucket.n_bd),
        bd_cluster=padn(graph.bd_cluster[spec.bd_rows], bucket.n_bd, -1),
        bd_index=padn(
            graph.bd_index[spec.bd_rows].astype(np.int32), bucket.n_bd, -1
        ),
        bd_valid=padn(np.ones(nbd, bool), bucket.n_bd),
        bd_interior=padn(spec.bd_interior, bucket.n_bd),
        tt=tt,
        tb=tb,
        cand=cand,
        sg_src=padn(sg_s[:n_sg].astype(np.int32), e_sg),
        sg_dst=padn(sg_d[:n_sg].astype(np.int32), e_sg),
        sg_mask=padn(np.ones(n_sg, bool), e_sg),
        tt_t=tt_t,
        tb_t=tb_t,
        tx_sampler_sorted=tx_ss,
        tx_sampler_counts=tx_sc,
        bd_sampler_sorted=bd_ss,
        bd_sampler_counts=bd_sc,
    )
    if will_bucket:
        tile = apply_degree_bucketing(
            tile, n_lo=bucket.n_lo, k_lo=bucket.k_lo,
            k_lo_t=bucket.k_lo_t, k_hi_t=bucket.k_hi_t,
            k_tt_t=bucket.k_tt_t,
            n_xlo=bucket.n_xlo, k_xlo=bucket.k_xlo,
            k_xlo_t=bucket.k_xlo_t,
            build_full_transpose=False,
        )
    return tile


def apply_degree_bucketing(
    tile: TileGraph, n_lo: int, k_lo: int = DEGREE_BUCKET_K_LO,
    k_lo_t: Optional[int] = None, k_hi_t: Optional[int] = None,
    k_tt_t: Optional[int] = None,
    n_xlo: int = 0, k_xlo: int = DEGREE_BUCKET_K_XLO,
    k_xlo_t: Optional[int] = None,
    build_full_transpose: bool = True,
) -> TileGraph:
    """Reorder a NumPy tile's tx rows so low-tt-in-degree rows lead.

    The edge stage then runs narrow-K launches on rows [0, n_xlo) and
    [n_xlo, n_lo) and the full-width launch only on the tail.  Stable:
    valid xlo, lo, then hi rows keep their relative order, padding last.
    Builds the per-segment transpose tables and rebuilds every
    tx-indexed field."""
    idx = np.asarray(tile.tt.idx)
    mask = np.asarray(tile.tt.mask)
    n_tx, k_tt = idx.shape
    valid = np.asarray(tile.tx_valid)
    deg = mask.sum(1)
    is_hi = (deg > k_lo) | ~valid
    n_lo_avail = int((~is_hi).sum())
    if n_lo <= 0 or k_lo <= 0 or k_tt <= k_lo:
        return tile
    if n_lo > n_lo_avail:
        raise ValueError(
            f"degree-bucket boundary n_lo={n_lo} exceeds the tile's "
            f"{n_lo_avail} rows with in-degree <= {k_lo}"
        )
    xlo = n_xlo > 0 and 0 < k_xlo < k_lo
    if xlo:
        is_xlo = (deg <= k_xlo) & valid
        n_xlo_avail = int(is_xlo.sum())
        if n_xlo > n_xlo_avail:
            raise ValueError(
                f"degree-bucket boundary n_xlo={n_xlo} exceeds the "
                f"tile's {n_xlo_avail} rows with in-degree <= {k_xlo}"
            )
        if n_xlo > n_lo:
            raise ValueError(
                f"n_xlo={n_xlo} must not exceed n_lo={n_lo}"
            )
        cls = np.where(is_xlo, 0, np.where(is_hi, 2, 1))
        perm = np.argsort(cls, kind="stable")
    else:
        n_xlo = k_xlo = 0
        perm = np.argsort(is_hi, kind="stable")
    inv = np.empty(n_tx, np.int64)
    inv[perm] = np.arange(n_tx)
    inv32 = inv.astype(np.int32)

    def remap(a):
        return inv32[np.asarray(a)]

    tt = PaddedCSR(idx=remap(idx)[perm], mask=mask[perm])
    tt_xlo = PaddedCSR(
        idx=tt.idx[:n_xlo, :max(k_xlo, 1)],
        mask=tt.mask[:n_xlo, :max(k_xlo, 1)],
    )
    tt_lo = PaddedCSR(
        idx=tt.idx[n_xlo:n_lo, :k_lo], mask=tt.mask[n_xlo:n_lo, :k_lo]
    )
    tt_hi = PaddedCSR(idx=tt.idx[n_lo:], mask=tt.mask[n_lo:])
    # each region only holds rows with deg <= its width and edges sit in
    # the leading slots, so the column slices drop no edge
    if tt.mask[n_xlo:n_lo, k_lo:].any() or (
            xlo and tt.mask[:n_xlo, k_xlo:].any()):
        raise AssertionError("degree bucket slices would drop edges")

    cand = PaddedCSR(
        idx=np.asarray(tile.cand.idx)[perm],
        mask=np.asarray(tile.cand.mask)[perm],
    )
    tb = PaddedCSR(idx=remap(tile.tb.idx), mask=np.asarray(tile.tb.mask))

    kw = {}
    if tile.tt_t is not None or k_tt_t is not None:
        if build_full_transpose:
            w = k_tt_t if k_tt_t is not None else tile.tt_t.idx.shape[1]
            kw["tt_t"] = transpose_csr(tt, n_src=n_tx, k=w)
        else:
            kw["tt_t"] = None
        kw["tt_lo_t"] = transpose_csr(tt_lo, n_src=n_tx, k=k_lo_t)
        kw["tt_hi_t"] = transpose_csr(tt_hi, n_src=n_tx, k=k_hi_t)
        if xlo:
            kw["tt_xlo_t"] = transpose_csr(
                tt_xlo, n_src=n_tx, k=k_xlo_t
            )
    if tile.tb_t is not None:
        # tb rows are bd (unpermuted) and its slot layout is unchanged,
        # so only the src-keyed row order moves
        kw["tb_t"] = PaddedCSR(
            idx=np.asarray(tile.tb_t.idx)[perm],
            mask=np.asarray(tile.tb_t.mask)[perm],
        )
    if tile.tx_sampler_sorted is not None:
        kw["tx_sampler_sorted"] = remap(tile.tx_sampler_sorted)
    if tile.bt is not None:
        kw["bt"] = PaddedCSR(
            idx=np.asarray(tile.bt.idx)[perm],
            mask=np.asarray(tile.bt.mask)[perm],
        )

    return tile.replace(
        tx_gene=np.asarray(tile.tx_gene)[perm],
        tx_pos=np.asarray(tile.tx_pos)[perm],
        tx_cluster=np.asarray(tile.tx_cluster)[perm],
        tx_index=np.asarray(tile.tx_index)[perm],
        tx_valid=valid[perm],
        tx_interior=np.asarray(tile.tx_interior)[perm],
        tt=tt,
        cand=cand,
        tb=tb,
        sg_src=remap(tile.sg_src),
        tt_n_lo=n_lo,
        tt_k_lo=k_lo,
        tt_n_xlo=n_xlo,
        tt_k_xlo=k_xlo,
        **kw,
    )


def stack_tiles(tiles: Sequence[TileGraph]) -> TileGraph:
    """Stack same-bucket NumPy tiles on a leading axis.  Static ints and
    the presence of every optional table must agree across tiles."""
    kw = {}
    for f in dataclasses.fields(TileGraph):
        vals = [getattr(t, f.name) for t in tiles]
        v0 = vals[0]
        if v0 is None or isinstance(v0, (bool, int)):
            if any(v != v0 for v in vals):
                raise ValueError(f"tiles disagree on {f.name}: cannot stack")
            kw[f.name] = v0
        elif isinstance(v0, PaddedCSR):
            kw[f.name] = PaddedCSR(np.stack([v.idx for v in vals]),
                                   np.stack([v.mask for v in vals]))
        else:
            kw[f.name] = np.stack(vals)
    return TileGraph(**kw)


def empty_tile(
    bucket: BucketShape, f_bd: int, c_tx: int = 1, c_bd: int = 1
) -> TileGraph:
    """An all-padding tile (rounds batches up without touching any
    output: every mask is False)."""
    z = np.zeros

    def csr(n, k):
        return PaddedCSR(idx=z((n, k), np.int32), mask=z((n, k), bool))

    lo = bucket.n_lo > 0
    xlo = lo and bucket.n_xlo > 0
    return TileGraph(
        tx_gene=z(bucket.n_tx, np.int32),
        tx_pos=z((bucket.n_tx, 2), np.float32),
        tx_cluster=np.full(bucket.n_tx, -1, np.int32),
        tx_index=np.full(bucket.n_tx, -1, np.int32),
        tx_valid=z(bucket.n_tx, bool),
        tx_interior=z(bucket.n_tx, bool),
        bd_x=z((bucket.n_bd, f_bd), np.float32),
        bd_pos=z((bucket.n_bd, 2), np.float32),
        bd_cluster=np.full(bucket.n_bd, -1, np.int32),
        bd_index=np.full(bucket.n_bd, -1, np.int32),
        bd_valid=z(bucket.n_bd, bool),
        bd_interior=z(bucket.n_bd, bool),
        tt=csr(bucket.n_tx, bucket.k_tt),
        tb=csr(bucket.n_bd, bucket.k_tb),
        cand=csr(bucket.n_tx, bucket.k_cand),
        sg_src=z(bucket.e_sg, np.int32),
        sg_dst=z(bucket.e_sg, np.int32),
        sg_mask=z(bucket.e_sg, bool),
        # bucketed tiles carry no full tt transpose; the table layout
        # must match real tiles for stacking
        tt_t=None if lo else csr(bucket.n_tx, bucket.k_tt_t),
        tb_t=csr(bucket.n_tx, bucket.k_tb_t),
        tx_sampler_sorted=np.arange(bucket.n_tx, dtype=np.int32),
        tx_sampler_counts=z(c_tx, np.int32),
        bd_sampler_sorted=np.arange(bucket.n_bd, dtype=np.int32),
        bd_sampler_counts=z(c_bd, np.int32),
        tt_lo_t=csr(bucket.n_tx, bucket.k_lo_t) if lo else None,
        tt_hi_t=csr(bucket.n_tx, bucket.k_hi_t) if lo else None,
        tt_n_lo=bucket.n_lo if lo else 0,
        tt_k_lo=bucket.k_lo if lo else 0,
        tt_xlo_t=csr(bucket.n_tx, bucket.k_xlo_t) if xlo else None,
        tt_n_xlo=bucket.n_xlo if xlo else 0,
        tt_k_xlo=bucket.k_xlo if xlo else 0,
    )


def best_fit_decreasing(
    values: np.ndarray, max_num: float
) -> List[np.ndarray]:
    """Deterministic offline best-fit-decreasing: sort items descending,
    place each in the fullest bin it fits in."""
    order = np.argsort(-np.asarray(values), kind="stable")
    bins: List[list] = []
    loads: List[float] = []
    for i in order:
        v = values[i]
        best, best_load = -1, -1.0
        for b, load in enumerate(loads):
            if load + v <= max_num and load > best_load:
                best, best_load = b, load
        if best < 0:
            bins.append([i])
            loads.append(float(v))
        else:
            bins[best].append(i)
            loads[best] += v
    return [np.asarray(b) for b in bins]


def first_fit_decreasing_bucketed(
    values: np.ndarray,
    max_num: float,
    rng: Optional[np.random.Generator] = None,
    n_buckets: int = 10,
) -> List[np.ndarray]:
    """First-fit decreasing with shuffling inside value-similarity
    buckets (the reference's shuffled train packer), then the bins
    shuffled.  The same ``rng`` state gives the JAX package's bins."""
    values = np.asarray(values)
    rng = rng or np.random.default_rng()
    order = np.argsort(-values, kind="stable")
    chunks = np.array_split(order, n_buckets)
    order = np.concatenate([rng.permutation(c) for c in chunks if c.size])
    bins: List[list] = []
    loads: List[float] = []
    for i in order:
        v = values[i]
        for b in range(len(bins)):
            if loads[b] + v <= max_num:
                bins[b].append(i)
                loads[b] += v
                break
        else:
            bins.append([i])
            loads.append(float(v))
    out = [np.asarray(b) for b in bins]
    rng.shuffle(out)
    return out


def harmonic_k(
    values: np.ndarray,
    max_num: float,
    k: int = 6,
    skip_too_big: bool = False,
) -> List[np.ndarray]:
    """Harmonic-k online packing (the reference's, present there but
    unused by default; no path of the port calls it either).

    Items arrive in order.  An item with size fraction f = v/max_num is
    "large" when f > 1/k: it falls in the harmonic interval
    (1/(j+1), 1/j] with j = floor(1/f), and large items of class j are
    packed j to a bin (a class bin is emitted as soon as it holds j
    items).  Items with f <= 1/k are "small" and packed first-fit
    against each small bin's remaining capacity.  The class bins still
    open come after the full ones, then the small bins.

    Raises ValueError for k < 2, and for items <= 0 or > max_num unless
    ``skip_too_big`` is set, which drops them.
    """
    if k < 2:
        raise ValueError("k must be >= 2")
    values = np.asarray(values, dtype=float)
    bad = (values <= 0) | (values > max_num)
    if bad.any() and not skip_too_big:
        raise ValueError("all item sizes must be > 0 and <= max_num")
    stream = [(i, v) for i, v in enumerate(values) if not bad[i]]

    bins: List[list] = []
    open_class: dict = {}            # j -> partially filled class bin
    small_bins: List[list] = []
    small_room: List[float] = []
    for i, v in stream:
        f = v / max_num
        if f > 1.0 / k:
            j = int(1.0 // f)
            cur = open_class.setdefault(j, [])
            cur.append(i)
            if len(cur) == j:
                bins.append(cur)
                open_class[j] = []
        else:
            for b, room in enumerate(small_room):
                if v <= room:
                    small_bins[b].append(i)
                    small_room[b] -= v
                    break
            else:
                small_bins.append([i])
                small_room.append(max_num - v)

    bins.extend(cur for cur in open_class.values() if cur)
    bins.extend(small_bins)
    return [np.asarray(b) for b in bins]
