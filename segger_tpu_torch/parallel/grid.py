"""2-D grid halo-exchange sharding: whole-slide execution over a
``(dx, dy)`` grid of shards.

The port of ``segger_tpu/parallel/grid.py``.  The 1-D strips
(``parallel/halo.py``) scale until strips grow thin relative to the
interaction radius; for slides large in both dimensions a grid of
rectangles keeps each shard's surface-to-volume ratio bounded.  The mesh has axes ``("x", "y")`` and shard id
``gx * dy + gy``.

Halo rows cross shard boundaries in a **two-stage relay**: first an
exchange along x, then one along y whose send buffers gather *from the
x-extended space*, so diagonal (corner) neighbours are reached with two
exchanges per layer instead of eight point-to-point sends; the corner
row travels owner -> x-neighbour -> consumer.  Extended node space, in
order::

    [ local (P) | from_x_left (H) | from_x_right (H)
                | from_y_below (Hy) | from_y_above (Hy) ]

x-stage send lists index local rows; y-stage send lists index the
x-extended prefix ``[0, P + 2H)``.  As in the 1-D module the exchange
returns *pieces*, which the conv projects one by one, and each stage
moves through ``parallel/transport.py``, across ranks too; stage 2's
buffers read stage 1's received rows, so a rank posts stage 2 only once
stage 1's sends and receives are complete.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.assemble import HostGraph
from ..data.graph import TileGraph
from ._build_common import build_partitioned
from .halo import (
    Exchange, _sends, flat_predictions, make_train_step, predict_shards,
    send_buffer,
)
from .mesh import ArrayFields, Mesh, make_grid_mesh, put_sharded
from .transport import exchange, shard_ids

logger = logging.getLogger(__name__)

__all__ = ["GridHaloSpec", "build_grid_sharded_graph", "make_grid_mesh",
           "make_grid_predict", "make_grid_train_step", "grid_predict"]


@dataclass
class GridHaloSpec(ArrayFields):
    """Per-shard send lists (leading axis = shard id ``gx * dy + gy``).

    ``*_send_xl/xr``: local row indices shipped to the left/right
    x-neighbour (stage 1).  ``*_send_yd/yu``: x-extended indices (in
    ``[0, P + 2H)``) shipped to the below/above y-neighbour (stage 2).
    ``bd_index_ext``: global cell encoding of every extended bd row
    (-1 for unused slots), which decodes the candidate argmax.
    """

    tx_send_xl: Any
    tx_send_xl_mask: Any
    tx_send_xr: Any
    tx_send_xr_mask: Any
    tx_send_yd: Any
    tx_send_yd_mask: Any
    tx_send_yu: Any
    tx_send_yu_mask: Any
    bd_send_xl: Any
    bd_send_xl_mask: Any
    bd_send_xr: Any
    bd_send_xr_mask: Any
    bd_send_yd: Any
    bd_send_yd_mask: Any
    bd_send_yu: Any
    bd_send_yu_mask: Any
    bd_index_ext: Any


def _grid_assign(graph: HostGraph, dx: int, dy: int):
    """Equal-count x-quantile columns, then per-column y-quantile rows.

    bd follows its centroid through the same column/row boundaries, so
    a cell and the transcripts near it land on the same or an adjacent
    shard.
    """
    tx_x, tx_y = graph.tx_pos[:, 0], graph.tx_pos[:, 1]
    xq = (
        np.quantile(tx_x, np.linspace(0, 1, dx + 1)[1:-1])
        if dx > 1 else np.zeros(0)
    )
    tx_gx = np.searchsorted(xq, tx_x, side="right").astype(np.int64)
    bd_gx = np.searchsorted(
        xq, graph.bd_pos[:, 0], side="right"
    ).astype(np.int64)
    tx_gy = np.zeros(graph.n_tx, np.int64)
    bd_gy = np.zeros(graph.n_bd, np.int64)
    for cx in range(dx):
        m = tx_gx == cx
        ys = tx_y[m]
        yq = (
            np.quantile(ys, np.linspace(0, 1, dy + 1)[1:-1])
            if dy > 1 and ys.size else np.zeros(0)
        )
        tx_gy[m] = np.searchsorted(yq, ys, side="right")
        mb = bd_gx == cx
        bd_gy[mb] = np.searchsorted(yq, graph.bd_pos[mb, 1], side="right")
    return tx_gx * dy + tx_gy, bd_gx * dy + bd_gy


def build_grid_sharded_graph(
    graph: HostGraph,
    dx: int,
    dy: int,
    round_nodes: int = 128,
    round_halo: int = 32,
    for_training: bool = False,
) -> Tuple[TileGraph, GridHaloSpec, np.ndarray]:
    """Partition the whole-slide graph over a ``dx x dy`` grid.

    Returns (stacked per-shard TileGraph with leading axis ``dx*dy``,
    GridHaloSpec, dropped-edge counts per edge type (tt, sg, cand)).
    Edges spanning shards further than one grid step in either axis are
    dropped and counted.  ``for_training`` adds the extended-space
    transpose tables and the triplet-sampler block structure, as in the
    strip build, which is this build's ``dy == 1`` case.
    """
    tx_shard, bd_shard = _grid_assign(graph, dx, dy)
    b = build_partitioned(
        graph, tx_shard, bd_shard, dx=dx, dy=dy,
        round_nodes=round_nodes, round_halo=round_halo,
        for_training=for_training,
    )
    halo = GridHaloSpec(
        tx_send_xl=b.tx_send_xl, tx_send_xl_mask=b.tx_send_xl_mask,
        tx_send_xr=b.tx_send_xr, tx_send_xr_mask=b.tx_send_xr_mask,
        tx_send_yd=b.tx_send_yd, tx_send_yd_mask=b.tx_send_yd_mask,
        tx_send_yu=b.tx_send_yu, tx_send_yu_mask=b.tx_send_yu_mask,
        bd_send_xl=b.bd_send_xl, bd_send_xl_mask=b.bd_send_xl_mask,
        bd_send_xr=b.bd_send_xr, bd_send_xr_mask=b.bd_send_xr_mask,
        bd_send_yd=b.bd_send_yd, bd_send_yd_mask=b.bd_send_yd_mask,
        bd_send_yu=b.bd_send_yu, bd_send_yu_mask=b.bd_send_yu_mask,
        bd_index_ext=b.bd_index_ext,
    )
    return b.stacked, halo, b.dropped


# ----------------------------------------------------------------------
# device side
# ----------------------------------------------------------------------
def _exchange_2d(xs: Sequence[Optional[torch.Tensor]], s_xl, s_xl_m, s_xr,
                 s_xr_m, s_yd, s_yd_m, s_yu, s_yu_m, dx: int, dy: int,
                 mesh: Optional[Mesh] = None) -> List[Optional[tuple]]:
    """The two-stage relay; every send argument is a per-shard list
    (``None`` for the other ranks' shards; without a mesh every shard is
    this process's).  Shard ``d`` gets ``(local, from_xl, from_xr,
    from_yd, from_yu)``, zeros where it has no neighbour.  Stage-2 send
    buffers gather from the x-extended space piecewise (local rows from
    ``x``, halo rows from the stage-1 results) without forming the
    concatenation."""
    n = dx * dy
    local = shard_ids(n, mesh)
    buf_r, buf_l = [None] * n, [None] * n
    for d in local:
        buf_r[d] = send_buffer(xs[d], s_xr[d], s_xr_m[d])
        buf_l[d] = send_buffer(xs[d], s_xl[d], s_xl_m[d])
    from_xl, from_xr = exchange(
        ([(d, d + dy) for d in range(n) if d // dy < dx - 1],
         [(d, d - dy) for d in range(n) if d // dy > 0]),
        (buf_r, buf_l), mesh)

    def pick(d, idx, m):
        x = xs[d]
        p = x.shape[0]
        xhalo = torch.cat([from_xl[d], from_xr[d]])       # (2H, F), small
        idx = idx.long()
        loc = x[idx.clamp(0, p - 1)]
        hal = xhalo[(idx - p).clamp(0, xhalo.shape[0] - 1)]
        v = torch.where((idx < p)[:, None], loc, hal)
        return torch.where(m[:, None], v, 0.0)

    up, down = [None] * n, [None] * n
    for d in local:
        up[d] = pick(d, s_yu[d], s_yu_m[d])
        down[d] = pick(d, s_yd[d], s_yd_m[d])
    from_yd, from_yu = exchange(
        ([(d, d + 1) for d in range(n) if d % dy < dy - 1],
         [(d, d - 1) for d in range(n) if d % dy > 0]), (up, down), mesh)
    return [None if from_xl[d] is None
            else (xs[d], from_xl[d], from_xr[d], from_yd[d], from_yu[d])
            for d in range(n)]


def grid_exchanges(halos: Sequence[Optional[GridHaloSpec]], dx: int,
                   dy: int, mesh: Optional[Mesh] = None
                   ) -> Tuple[Exchange, Exchange]:
    """The tx and bd two-stage exchanges of a grid-sharded slide."""
    def make(kind):
        sends = _sends(halos, [f"{kind}_send_{side}{m}"
                               for side in ("xl", "xr", "yd", "yu")
                               for m in ("", "_mask")])
        return lambda xs: _exchange_2d(xs, *sends, dx, dy, mesh=mesh)
    return make("tx"), make("bd")


def _grid_dims(mesh: Mesh, ax: str, ay: str) -> Tuple[int, int]:
    if mesh.axis_names != (ax, ay):
        raise ValueError(f"a grid mesh has the axes ({ax!r}, {ay!r})")
    return mesh.shape[ax], mesh.shape[ay]


def make_grid_predict(model, mesh: Mesh, ax: str = "x", ay: str = "y"):
    """``fn(shards, halos)`` -> per-shard ``(tx_index, cell_encoding,
    similarity, gene, valid)`` of a grid-sharded slide; mirrors
    ``halo.make_sharded_predict`` with the two-stage exchange."""
    dx, dy = _grid_dims(mesh, ax, ay)

    def fn(shards, halos):
        return predict_shards(model, mesh, shards, halos,
                              grid_exchanges(halos, dx, dy, mesh))
    return fn


def make_grid_train_step(model, optimizer, mesh: Mesh, tx_similarity,
                         bd_similarity, ax: str = "x", ay: str = "y",
                         tx_margin: float = 0.3, sg_margin: float = 0.4,
                         sg_loss_type: str = "triplet"):
    """Whole-slide margin-free training step over the grid; the strip
    step's semantics (``halo.make_train_step``: local numerators over
    detached global counts, the gradient summed over shards)."""
    dx, dy = _grid_dims(mesh, ax, ay)
    return make_train_step(
        model, optimizer, mesh, tx_similarity, bd_similarity,
        lambda halos, m: grid_exchanges(halos, dx, dy, m), tx_margin,
        sg_margin, sg_loss_type)


def grid_predict(model, graph: HostGraph, mesh: Mesh, ax: str = "x",
                 ay: str = "y") -> Dict[str, np.ndarray]:
    """End-to-end 2-D sharded whole-slide prediction."""
    dx, dy = _grid_dims(mesh, ax, ay)
    stacked, halo, dropped = build_grid_sharded_graph(graph, dx, dy)
    if dropped.any():
        logger.warning("grid partition dropped %s far-shard edges "
                       "(tt, sg, cand)", dropped.tolist())
    fn = make_grid_predict(model, mesh, ax, ay)
    return flat_predictions(fn(put_sharded(stacked, mesh),
                               put_sharded(halo, mesh)), mesh)
