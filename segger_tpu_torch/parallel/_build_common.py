"""Shared host-side machinery for the halo-sharded graph builds.

The port's NumPy copy of ``segger_tpu/parallel/_build_common.py``.
``parallel/halo.py`` (1-D strips) and ``parallel/grid.py`` (2-D grid
with two-stage relay) differ only in how they *assign* nodes to shards
and how they enumerate/route cross-shard sources; everything downstream
— send-list tables, extended-space CSR construction, extended transpose
tables for training, and per-shard TileGraph assembly — is identical
and lives here.  Every node is owned by exactly one shard and halos are
exchanged per layer, so no tile margins and no dedupe are needed.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from ..data.assemble import HostGraph
from ..data.graph import TileGraph
from ..data.partition import _sampler_structure, stack_tiles
from ..ops.padded_csr import PaddedCSR, coo_to_padded_csr, transpose_csr


def round_up(x, m):
    return max(m, -(-int(x) // m) * m)


def padn(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


class NodePartition:
    """Per-shard row lists, padded sizes, and global->local index maps
    for both node types, plus the global positional-normalization frame.
    """

    def __init__(self, graph: HostGraph, tx_shard: np.ndarray,
                 bd_shard: np.ndarray, n_shards: int, round_nodes: int):
        self.D = n_shards
        self.tx_shard, self.bd_shard = tx_shard, bd_shard
        self.tx_rows = [np.where(tx_shard == d)[0] for d in range(n_shards)]
        self.bd_rows = [np.where(bd_shard == d)[0] for d in range(n_shards)]
        self.P = round_up(max(r.size for r in self.tx_rows), round_nodes)
        self.Q = round_up(
            max(max(r.size for r in self.bd_rows), 1), round_nodes
        )
        self.tx_local = np.full(graph.n_tx, -1, np.int64)
        self.bd_local = np.full(graph.n_bd, -1, np.int64)
        for d in range(n_shards):
            self.tx_local[self.tx_rows[d]] = np.arange(self.tx_rows[d].size)
            self.bd_local[self.bd_rows[d]] = np.arange(self.bd_rows[d].size)
        lo = np.vstack([graph.tx_pos, graph.bd_pos]).min(axis=0)
        hi = np.vstack([graph.tx_pos, graph.bd_pos]).max(axis=0)
        self.pos_lo, self.pos_scale = lo, (hi - lo) + 1e-8


def mk_send(send_sets: Sequence[set], n_shards: int, width: int,
            local_map: np.ndarray):
    """Ordered send lists + per-shard global-id -> slot maps."""
    idx = np.zeros((n_shards, width), np.int32)
    mask = np.zeros((n_shards, width), bool)
    slot_of: List[Dict[int, int]] = [dict() for _ in range(n_shards)]
    for d in range(n_shards):
        ordered = np.sort(np.fromiter(send_sets[d], dtype=np.int64))
        for j, g in enumerate(ordered):
            idx[d, j] = local_map[g]
            mask[d, j] = True
            slot_of[d][g] = j
    return idx, mask, slot_of


def ext_many(src_global: np.ndarray, d: int, src_shard_arr: np.ndarray,
             src_local_map: np.ndarray, ext_fn: Callable[[int, int], int]
             ) -> np.ndarray:
    """Vectorized extended-index lookup: same-shard sources (the
    overwhelming majority) resolve by local map; Python only runs on
    the cross-shard boundary tail."""
    out = np.empty(src_global.size, np.int64)
    same = src_shard_arr[src_global] == d
    out[same] = src_local_map[src_global[same]]
    for i in np.where(~same)[0]:
        out[i] = ext_fn(int(src_global[i]), d)
    return out


def shard_csr(n_shards: int, dst_rows_global, src_global, dst_shard_arr,
              dst_local_map, n_rows, src_shard_arr, src_local_map,
              ext_fn, k_round: int = 4) -> List[PaddedCSR]:
    """Per-shard padded CSR tables: rows in the dst shard's local space,
    entries in its extended source space (``ext_fn`` maps global ->
    extended or -1 = unreachable)."""
    tables = []
    for d in range(n_shards):
        sel = dst_shard_arr[dst_rows_global] == d
        dsts = dst_local_map[dst_rows_global[sel]]
        srcs = ext_many(src_global[sel], d, src_shard_arr,
                        src_local_map, ext_fn)
        keep = srcs >= 0
        tables.append((dsts[keep], srcs[keep]))
    kmax = 1
    for dsts, _ in tables:
        if dsts.size:
            kmax = max(kmax, int(np.bincount(dsts).max()))
    kmax = round_up(kmax, k_round)
    return [
        coo_to_padded_csr(d_, s_, n_dst=n_rows, k=kmax)
        for d_, s_ in tables
    ]


def ext_transposes(tables: Sequence[PaddedCSR],
                   n_src_ext: int) -> List[PaddedCSR]:
    """Extended-space transpose tables: one shared column width so the
    stacked shard tensors agree, sized to the densest source row."""
    width = 4
    for t in tables:
        srcs = np.asarray(t.idx)[np.asarray(t.mask)]
        if srcs.size:
            width = max(width, round_up(
                int(np.bincount(srcs, minlength=n_src_ext).max()), 4,
            ))
    return [transpose_csr(t, n_src=n_src_ext, k=width) for t in tables]


class PartitionedBuild:
    """Everything the sharded-graph builds produce, in one bag.

    ``halo.py`` (1-D strips) and ``grid.py`` (2-D grid) wrap these
    arrays into their own HaloSpec dataclasses; all construction logic
    lives in :func:`build_partitioned`.  1-D is exactly the ``dy == 1``
    case: the y-stage widths are zero and the y tables are absent
    (``None``).
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)


def build_partitioned(
    graph: HostGraph,
    tx_shard: np.ndarray,
    bd_shard: np.ndarray,
    dx: int,
    dy: int,
    round_nodes: int = 128,
    round_halo: int = 32,
    for_training: bool = False,
) -> PartitionedBuild:
    """One implementation of the halo-sharded graph build.

    Shard ids are ``gx * dy + gy``.  Stage-1 send lists cross the x
    axis (local row indices); when ``dy > 1`` a second stage crosses y
    with send lists indexing the x-extended space ``[0, P + 2H)`` (the
    two-stage relay — corner sources travel owner -> x-neighbour ->
    consumer).  When ``dy == 1`` the y stage vanishes entirely
    (``Hy = Hqy = 0``, y tables ``None``) and the extended space is
    ``[local | from_x_left | from_x_right]`` — the 1-D strip layout.

    Edges spanning shards further than one grid step in either axis are
    dropped and counted in ``dropped`` (tt, sg, cand).
    """
    D = dx * dy
    part = NodePartition(graph, tx_shard, bd_shard, D, round_nodes)
    tx_local, bd_local = part.tx_local, part.bd_local
    P_, Q_ = part.P, part.Q

    dropped = np.zeros(3, dtype=np.int64)

    # ------------------------------------------------------------------
    # pass 1: cross-shard requirements.  For every edge whose source
    # lives on a different shard than its consumer: stage-1 x sends for
    # any dgx != 0, and a pending y-relay record for any dgy != 0 (the
    # relay shard is (consumer_gx, owner_gy)).  Vectorized bucketing —
    # a per-edge Python loop costs minutes at 10M-transcript scale;
    # only the cross-shard boundary tail is touched per element.
    # ------------------------------------------------------------------
    xs_r_tx = [set() for _ in range(D)]
    xs_l_tx = [set() for _ in range(D)]
    xs_r_bd = [set() for _ in range(D)]
    xs_l_bd = [set() for _ in range(D)]
    pend_tx: list = []  # (g, relay_shard, dgy)
    pend_bd: list = []

    def collect(src_arr, cons_arr, shard_arr, xs_r, xs_l, pend, drop_i):
        osh = shard_arr[src_arr]
        ogx, ogy = osh // dy, osh % dy
        cgx, cgy = cons_arr // dy, cons_arr % dy
        ddx, ddy = cgx - ogx, cgy - ogy
        far = (np.abs(ddx) > 1) | (np.abs(ddy) > 1)
        dropped[drop_i] += int(far.sum())
        sel = ((ddx != 0) | (ddy != 0)) & ~far
        for g, dxx, dyy, cx in zip(
            src_arr[sel], ddx[sel], ddy[sel], cgx[sel]
        ):
            o = int(shard_arr[g])
            if dxx == 1:
                xs_r[o].add(g)
            elif dxx == -1:
                xs_l[o].add(g)
            if dyy != 0:
                pend.append((int(g), int(cx * dy + (o % dy)), int(dyy)))

    collect(graph.tt_src, tx_shard[graph.tt_dst], tx_shard,
            xs_r_tx, xs_l_tx, pend_tx, 0)
    collect(graph.sg_src, bd_shard[graph.sg_dst], tx_shard,
            xs_r_tx, xs_l_tx, pend_tx, 1)
    collect(graph.cand_dst, tx_shard[graph.cand_src], bd_shard,
            xs_r_bd, xs_l_bd, pend_bd, 2)

    H = round_up(
        max([1] + [len(s) for s in xs_r_tx] + [len(s) for s in xs_l_tx]),
        round_halo,
    )
    Hq = round_up(
        max([1] + [len(s) for s in xs_r_bd] + [len(s) for s in xs_l_bd]),
        round_halo,
    )

    sr_tx_i, sr_tx_m, sr_tx_s = mk_send(xs_r_tx, D, H, tx_local)
    sl_tx_i, sl_tx_m, sl_tx_s = mk_send(xs_l_tx, D, H, tx_local)
    sr_bd_i, sr_bd_m, sr_bd_s = mk_send(xs_r_bd, D, Hq, bd_local)
    sl_bd_i, sl_bd_m, sl_bd_s = mk_send(xs_l_bd, D, Hq, bd_local)

    # x-extended index of source g at a shard r in the owner's grid row
    # (r's gy == owner's gy, |r_gx - owner_gx| <= 1)
    def xext(g, r, shard_arr, local_map, P_n, Hn, sr_s, sl_s):
        o = int(shard_arr[g])
        if o == r:
            return int(local_map[g])
        if r // dy == o // dy + 1:
            return P_n + sr_s[o][g]
        if r // dy == o // dy - 1:
            return P_n + Hn + sl_s[o][g]
        return -1

    def xext_tx(g, r):
        return xext(g, r, tx_shard, tx_local, P_, H, sr_tx_s, sl_tx_s)

    def xext_bd(g, r):
        return xext(g, r, bd_shard, bd_local, Q_, Hq, sr_bd_s, sl_bd_s)

    if dy > 1:
        # --------------------------------------------------------------
        # pass 2: y-stage send sets.  Entries are x-extended indices at
        # the relay shard; the dict also remembers which global node
        # each x-extended slot carries (to decode bd_index_ext).
        # --------------------------------------------------------------
        ys_u_tx = [dict() for _ in range(D)]  # xext -> global g
        ys_d_tx = [dict() for _ in range(D)]
        ys_u_bd = [dict() for _ in range(D)]
        ys_d_bd = [dict() for _ in range(D)]

        for g, r, dyy in pend_tx:
            xe = xext_tx(g, r)
            (ys_u_tx if dyy == 1 else ys_d_tx)[r][xe] = g
        for g, r, dyy in pend_bd:
            xe = xext_bd(g, r)
            (ys_u_bd if dyy == 1 else ys_d_bd)[r][xe] = g

        Hy = round_up(
            max([1] + [len(s) for s in ys_u_tx]
                + [len(s) for s in ys_d_tx]),
            round_halo,
        )
        Hqy = round_up(
            max([1] + [len(s) for s in ys_u_bd]
                + [len(s) for s in ys_d_bd]),
            round_halo,
        )

        def mk_ysend(send_dicts, width):
            idx = np.zeros((D, width), np.int32)
            mask = np.zeros((D, width), bool)
            slot_of: List[Dict[int, int]] = [dict() for _ in range(D)]
            for d in range(D):
                for j, xe in enumerate(sorted(send_dicts[d])):
                    idx[d, j] = xe
                    mask[d, j] = True
                    slot_of[d][xe] = j
            return idx, mask, slot_of

        yu_tx_i, yu_tx_m, yu_tx_s = mk_ysend(ys_u_tx, Hy)
        yd_tx_i, yd_tx_m, yd_tx_s = mk_ysend(ys_d_tx, Hy)
        yu_bd_i, yu_bd_m, yu_bd_s = mk_ysend(ys_u_bd, Hqy)
        yd_bd_i, yd_bd_m, yd_bd_s = mk_ysend(ys_d_bd, Hqy)
    else:
        # 1-D: no y stage at all — zero-width tables keep the grid
        # device path functional for a dy==1 grid while the 1-D strip
        # path ignores them entirely.
        Hy = Hqy = 0
        yu_tx_i = yd_tx_i = np.zeros((D, 0), np.int32)
        yu_tx_m = yd_tx_m = np.zeros((D, 0), bool)
        yu_bd_i = yd_bd_i = np.zeros((D, 0), np.int32)
        yu_bd_m = yd_bd_m = np.zeros((D, 0), bool)
        yu_tx_s = yd_tx_s = yu_bd_s = yd_bd_s = None
        ys_u_bd = ys_d_bd = None

    # full extended index of source g as seen from consumer shard c
    def mk_ext(shard_arr, xext_fn, P_n, Hn, Hyn, yu_s, yd_s):
        def ext(g, c):
            o = int(shard_arr[g])
            ogx, ogy = divmod(o, dy)
            cgx, cgy = divmod(c, dy)
            dxx, dyy = cgx - ogx, cgy - ogy
            if abs(dxx) > 1 or abs(dyy) > 1:
                return -1
            if dyy == 0:
                return xext_fn(g, c)
            r = cgx * dy + ogy
            xe = xext_fn(g, r)
            if dyy == 1:   # relay sends up; consumer's from-below buffer
                return P_n + 2 * Hn + yu_s[r][xe]
            return P_n + 2 * Hn + Hyn + yd_s[r][xe]
        return ext

    ext_tx = mk_ext(tx_shard, xext_tx, P_, H, Hy, yu_tx_s, yd_tx_s)
    ext_bd = mk_ext(bd_shard, xext_bd, Q_, Hq, Hqy, yu_bd_s, yd_bd_s)

    # per-shard CSR tables in extended index space
    tt_tables = shard_csr(
        D, graph.tt_dst, graph.tt_src, tx_shard, tx_local, P_,
        tx_shard, tx_local, ext_tx,
    )
    tb_tables = shard_csr(
        D, graph.sg_dst, graph.sg_src, bd_shard, bd_local, Q_,
        tx_shard, tx_local, ext_tx, k_round=8,
    )
    cand_tables = shard_csr(
        D, graph.cand_src, graph.cand_dst, tx_shard, tx_local, P_,
        bd_shard, bd_local, ext_bd,
    )

    tiles = assemble_shard_tiles(
        graph, part, ext_tx, tt_tables, tb_tables, cand_tables,
        for_training, n_src_ext=P_ + 2 * H + 2 * Hy,
    )

    # decode table for extended bd rows
    bd_index_ext = np.full((D, Q_ + 2 * Hq + 2 * Hqy), -1, np.int64)
    for d in range(D):
        nbd = part.bd_rows[d].size
        bd_index_ext[d, :nbd] = graph.bd_index[part.bd_rows[d]]
        gx_, gy_ = divmod(d, dy)
        if gx_ - 1 >= 0:
            for g, j in sr_bd_s[(gx_ - 1) * dy + gy_].items():
                bd_index_ext[d, Q_ + j] = graph.bd_index[g]
        if gx_ + 1 < dx:
            for g, j in sl_bd_s[(gx_ + 1) * dy + gy_].items():
                bd_index_ext[d, Q_ + Hq + j] = graph.bd_index[g]
        if dy > 1 and gy_ - 1 >= 0:
            r = gx_ * dy + (gy_ - 1)
            for xe, j in yu_bd_s[r].items():
                bd_index_ext[d, Q_ + 2 * Hq + j] = \
                    graph.bd_index[ys_u_bd[r][xe]]
        if dy > 1 and gy_ + 1 < dy:
            r = gx_ * dy + (gy_ + 1)
            for xe, j in yd_bd_s[r].items():
                bd_index_ext[d, Q_ + 2 * Hq + Hqy + j] = \
                    graph.bd_index[ys_d_bd[r][xe]]

    return PartitionedBuild(
        stacked=stack_tiles(tiles),
        dropped=dropped,
        tx_send_xl=sl_tx_i, tx_send_xl_mask=sl_tx_m,
        tx_send_xr=sr_tx_i, tx_send_xr_mask=sr_tx_m,
        tx_send_yd=yd_tx_i, tx_send_yd_mask=yd_tx_m,
        tx_send_yu=yu_tx_i, tx_send_yu_mask=yu_tx_m,
        bd_send_xl=sl_bd_i, bd_send_xl_mask=sl_bd_m,
        bd_send_xr=sr_bd_i, bd_send_xr_mask=sr_bd_m,
        bd_send_yd=yd_bd_i, bd_send_yd_mask=yd_bd_m,
        bd_send_yu=yu_bd_i, bd_send_yu_mask=yu_bd_m,
        bd_index_ext=bd_index_ext,
    )


def sg_capacity(graph: HostGraph, bd_shard: np.ndarray,
                n_shards: int) -> int:
    return round_up(
        max([1] + [int((bd_shard[graph.sg_dst] == d).sum())
                   for d in range(n_shards)]),
        256,
    )


def assemble_shard_tiles(
    graph: HostGraph,
    part: NodePartition,
    ext_tx: Callable[[int, int], int],
    tt_tables, tb_tables, cand_tables,
    for_training: bool,
    n_src_ext: int,
) -> List[TileGraph]:
    """Per-shard padded TileGraphs (positions pre-normalized to the
    global frame; training shards additionally carry extended transpose
    tables and the host-precomputed triplet-sampler block structure)."""
    E_sg = sg_capacity(graph, part.bd_shard, part.D)
    tt_t_tables = tb_t_tables = None
    if for_training:
        tt_t_tables = ext_transposes(tt_tables, n_src_ext)
        tb_t_tables = ext_transposes(tb_tables, n_src_ext)

    tiles = []
    for d in range(part.D):
        txr, bdr = part.tx_rows[d], part.bd_rows[d]
        ntx, nbd = txr.size, bdr.size
        sel = part.bd_shard[graph.sg_dst] == d
        sgs = ext_many(graph.sg_src[sel], d, part.tx_shard,
                       part.tx_local, ext_tx)
        sgd = part.bd_local[graph.sg_dst[sel]]
        keep = sgs >= 0
        sgs, sgd = sgs[keep], sgd[keep]
        n_sg = min(sgs.size, E_sg)

        pos_tx = (graph.tx_pos[txr] - part.pos_lo) / part.pos_scale
        pos_bd = (graph.bd_pos[bdr] - part.pos_lo) / part.pos_scale

        extra = {}
        if for_training:
            tx_ss, tx_sc = _sampler_structure(
                padn(graph.tx_cluster[txr], part.P, -1),
                np.ones(ntx, bool), ntx, part.P,
                graph.tx_similarity.shape[0],
            )
            bd_ss, bd_sc = _sampler_structure(
                padn(graph.bd_cluster[bdr], part.Q, -1),
                np.ones(nbd, bool), nbd, part.Q,
                graph.bd_similarity.shape[0],
            )
            extra = dict(
                tt_t=tt_t_tables[d],
                tb_t=tb_t_tables[d],
                transposes_extended=True,
                tx_sampler_sorted=tx_ss,
                tx_sampler_counts=tx_sc,
                bd_sampler_sorted=bd_ss,
                bd_sampler_counts=bd_sc,
            )

        tiles.append(
            TileGraph(
                tx_gene=padn(graph.tx_gene[txr], part.P),
                tx_pos=padn(pos_tx.astype(np.float32), part.P),
                tx_cluster=padn(graph.tx_cluster[txr], part.P, -1),
                tx_index=padn(
                    graph.tx_index[txr].astype(np.int32), part.P, -1
                ),
                tx_valid=padn(np.ones(ntx, bool), part.P),
                tx_interior=padn(np.ones(ntx, bool), part.P),
                bd_x=padn(graph.bd_x[bdr], part.Q),
                bd_pos=padn(pos_bd.astype(np.float32), part.Q),
                bd_cluster=padn(graph.bd_cluster[bdr], part.Q, -1),
                bd_index=padn(
                    graph.bd_index[bdr].astype(np.int32), part.Q, -1
                ),
                bd_valid=padn(np.ones(nbd, bool), part.Q),
                bd_interior=padn(np.ones(nbd, bool), part.Q),
                tt=tt_tables[d],
                tb=tb_tables[d],
                cand=cand_tables[d],
                sg_src=padn(sgs[:n_sg].astype(np.int32), E_sg),
                sg_dst=padn(sgd[:n_sg].astype(np.int32), E_sg),
                sg_mask=padn(np.ones(n_sg, bool), E_sg),
                **extra,
            )
        )
    return tiles
