"""Halo-exchange sharded execution: whole-slide inference and training
over a device mesh without tiling truncation.

The port of ``segger_tpu/parallel/halo.py``.  The graph is
strip-partitioned by x-coordinate, every shard owns its nodes exactly
once, and before *each* GATv2 layer the features of boundary nodes are
fetched from their owners: a masked row gather on the owner, moved to
the consumer by ``parallel/transport.py`` (the counterpart of
``jax.lax.ppermute``): with ``.to()`` inside a process, with
point-to-point sends between the ranks of a mesh that spans processes.
The per-layer refresh makes the computation exact at any depth: no
margins, no duplicate predictions, no dedupe.

Host side: :func:`build_sharded_graph` strips the slide, builds per-shard
padded TileGraphs whose CSR indices point into the *extended* node space
``[local | halo-from-left | halo-from-right]``, and records the send
index lists; every rank builds every shard.  Device side:
:func:`sharded_forward` runs the encoder's steps (``ISTEncoder.embed`` /
``layer`` / ``head``) with the layers on the outside and this process's
shards on the inside, the exchange between layers: the exchange is a
barrier between the shards' layers.  Per-shard lists span the whole mesh
and hold ``None`` for the other ranks' shards.  Nothing synchronizes
inside a process's loop, so shards on different cards overlap.  Autograd
carries the backward through the exchange: the gather's backward adds
each consumer's cotangent into the owner's rows and the transport's
backward sends it back, as JAX derives the VJP of ``ppermute``.  On a
CUDA tensor every conv runs the fused kernels: the prediction launches
the forward kernel without transpose tables, training with the
extended ones (``TileGraph.transposes_extended``).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.assemble import HostGraph
from ..data.graph import TileGraph
from ..models import losses as L
from ..models.encoder import whole_table_segments
from ..ops.gather_agg import score_candidates
from ._build_common import build_partitioned
from .mesh import ArrayFields, Mesh, fetch_global, put_sharded, replicate
from .transport import all_reduce_, all_reduce_gradients, exchange, shard_ids

logger = logging.getLogger(__name__)

# a whole-slide exchange: per-shard (N, F) tensors -> per-shard tuples of
# the extended source's pieces, on each shard's device (None for the other
# ranks' shards, in and out)
Exchange = Callable[[List[torch.Tensor]], List[Tuple[torch.Tensor, ...]]]


@dataclass
class HaloSpec(ArrayFields):
    """Per-shard send lists (leading axis = shard), plus the extended
    metadata for prediction."""

    tx_send_left: Any        # (D, H) local tx rows -> left neighbour
    tx_send_left_mask: Any
    tx_send_right: Any
    tx_send_right_mask: Any
    bd_send_left: Any        # (D, Hq)
    bd_send_left_mask: Any
    bd_send_right: Any
    bd_send_right_mask: Any
    bd_index_ext: Any        # (D, Q+2Hq) global cell encoding of the
                             # extended bd rows (-1 unused)


def _strip_assign(x: np.ndarray, n_shards: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Equal-count strip partition along x; returns (shard_of_point,
    strip boundaries)."""
    qs = np.quantile(x, np.linspace(0, 1, n_shards + 1)[1:-1])
    shard = np.searchsorted(qs, x, side="right")
    return shard.astype(np.int64), qs


def build_sharded_graph(
    graph: HostGraph,
    n_shards: int,
    round_nodes: int = 128,
    round_halo: int = 32,
    for_training: bool = False,
) -> Tuple[TileGraph, HaloSpec, np.ndarray]:
    """Partition the whole-slide graph into ``n_shards`` x-strips.

    Returns (stacked per-shard TileGraph with leading axis D, HaloSpec,
    dropped-edge counts per edge type (tt, sg, cand)).  Edges spanning
    non-adjacent strips are dropped and counted; with equal-count strips
    and local spatial graphs there are none in practice.

    ``for_training`` also gives each shard the extended-space transpose
    tables (the edge-stage backward through the halo exchange) and the
    triplet-sampler block structure.  The 1-D build is the ``dy == 1``
    case of the grid build (``_build_common.build_partitioned``).
    """
    tx_shard, qs = _strip_assign(graph.tx_pos[:, 0], n_shards)
    # bd follows its centroid, against the same strip boundaries
    bd_shard = np.searchsorted(
        qs, graph.bd_pos[:, 0], side="right"
    ).astype(np.int64)

    b = build_partitioned(
        graph, tx_shard, bd_shard, dx=n_shards, dy=1,
        round_nodes=round_nodes, round_halo=round_halo,
        for_training=for_training,
    )
    halo = HaloSpec(
        tx_send_left=b.tx_send_xl,
        tx_send_left_mask=b.tx_send_xl_mask,
        tx_send_right=b.tx_send_xr,
        tx_send_right_mask=b.tx_send_xr_mask,
        bd_send_left=b.bd_send_xl,
        bd_send_left_mask=b.bd_send_xl_mask,
        bd_send_right=b.bd_send_xr,
        bd_send_right_mask=b.bd_send_xr_mask,
        bd_index_ext=b.bd_index_ext,
    )
    return b.stacked, halo, b.dropped


# ----------------------------------------------------------------------
# device side
# ----------------------------------------------------------------------
def send_buffer(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
    """The rows ``x[idx]`` a shard sends, zero where ``mask`` is False."""
    return torch.where(mask[:, None], x[idx.long()], 0.0)


def _exchange_1d(xs: Sequence[Optional[torch.Tensor]], send_left,
                 send_left_mask, send_right, send_right_mask,
                 mesh: Optional[Mesh] = None) -> List[Optional[tuple]]:
    """Exchange halo rows between strip neighbours; every argument is a
    per-shard list (``None`` for the other ranks' shards; without a mesh
    every shard is this process's).  Shard ``d`` gets ``(x[d], from_left,
    from_right)``: ``from_left`` is shard ``d - 1``'s ``send_right``
    rows, zeros on shard 0, and ``from_right`` shard ``d + 1``'s
    ``send_left`` rows, zeros on the last.  The pieces are returned
    apart, not concatenated: the conv projects each on its own
    (``models/gatv2.py``), and the extended-space indices address
    ``[local | from_left | from_right]`` in this order."""
    n = len(xs)
    to_right, to_left = [None] * n, [None] * n
    for d in shard_ids(n, mesh):
        to_right[d] = send_buffer(xs[d], send_right[d], send_right_mask[d])
        to_left[d] = send_buffer(xs[d], send_left[d], send_left_mask[d])
    from_left, from_right = exchange(
        ([(d, d + 1) for d in range(n - 1)],
         [(d + 1, d) for d in range(n - 1)]), (to_right, to_left), mesh)
    return [None if from_left[d] is None
            else (xs[d], from_left[d], from_right[d]) for d in range(n)]


def _sends(halos: Sequence, names: Sequence[str]) -> List[list]:
    """The named send tables of every shard, one per-shard list a name
    (``None`` for the other ranks' shards)."""
    return [[None if h is None else getattr(h, name) for h in halos]
            for name in names]


def strip_exchanges(halos: Sequence[Optional[HaloSpec]],
                    mesh: Optional[Mesh] = None
                    ) -> Tuple[Exchange, Exchange]:
    """The tx and bd exchanges of a strip-sharded slide."""
    def make(kind):
        sends = _sends(halos, [f"{kind}_send_{side}{m}"
                               for side in ("left", "right")
                               for m in ("", "_mask")])
        return lambda xs: _exchange_1d(xs, *sends, mesh=mesh)
    return make("tx"), make("bd")


class _Method(torch.nn.Module):
    """Calls a method of ``model`` by name, so that ``functional_call``
    can run it with the parameters of another device."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, name: str, *args, **kwargs):
        return getattr(self.model, name)(*args, **kwargs)


def _callers(model: torch.nn.Module, mesh: Mesh) -> List[Optional[Callable]]:
    """Per shard of this process (``None`` for the other ranks'),
    ``call(method_name, *args)`` on the model with the parameters of the
    shard's device (:func:`~.mesh.replicate`): the parameters themselves
    on the model's own device, and elsewhere ``.to()`` copies made once
    per device inside the autograd graph, so that each device's gradient
    flows back into the one parameter set."""
    home = next(model.parameters()).device
    wrapper = _Method(model)

    def direct(name, *args, **kwargs):
        return getattr(model, name)(*args, **kwargs)

    def on(params):
        return lambda name, *args, **kwargs: torch.func.functional_call(
            wrapper, params, (name, *args), kwargs)

    by_device = {
        dev: direct if dev == home else
        on({f"model.{k}": v for k, v in params.items()})
        for dev, params in replicate(model, mesh).items()}
    return [by_device[mesh.devices[d]] if d in mesh.local else None
            for d in range(mesh.size)]


def sharded_forward(model, mesh: Mesh, shards: Sequence[Optional[TileGraph]],
                    exchange: Exchange, deterministic: bool = True,
                    seeds: Optional[Sequence] = None
                    ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """Every shard's embeddings, ``{"tx", "bd"}`` on its device, for this
    process's shards (``None`` for the other ranks'): the encoder's
    embedding of each shard (positions prenormalized in the slide's
    frame), then per layer the tx exchange and each shard's layer over its
    extended sources, then the head.  ``seeds[d]`` is shard ``d``'s seed
    source when dropout is on."""
    calls = _callers(model, mesh)
    xs: List[Optional[tuple]] = [None] * mesh.size
    segments = {}
    for d in mesh.local:
        xs[d] = calls[d]("embed", shards[d], True)
        segments[d] = whole_table_segments(shards[d])
    for i in range(model.n_layers):
        srcs = exchange([None if x is None else x[0] for x in xs])
        for d in mesh.local:
            xs[d] = calls[d]("layer", i, xs[d][0], xs[d][1], shards[d],
                             deterministic,
                             None if seeds is None else seeds[d],
                             x_tx_src=srcs[d], segments=segments[d])
    return [None if x is None else calls[d]("head", *x)
            for d, x in enumerate(xs)]


def predict_shards(model, mesh: Mesh, shards: Sequence[Optional[TileGraph]],
                   halos: Sequence, exchanges: Tuple[Exchange, Exchange]
                   ) -> List[Optional[tuple]]:
    """Whole-slide prediction on device shards: :func:`sharded_forward`,
    one bd exchange for the candidate scoring (candidate indices address
    the extended bd rows), and the scoring per shard.  Per shard of this
    process ``(tx_index, cell_encoding, similarity, gene, valid)``,
    ``None`` for the other ranks'."""
    ex_tx, ex_bd = exchanges
    out: List[Optional[tuple]] = [None] * mesh.size
    with torch.no_grad():
        emb = sharded_forward(model, mesh, shards, ex_tx)
        bd_ext = ex_bd([None if e is None else e["bd"] for e in emb])
        for d in mesh.local:
            t, h = shards[d], halos[d]
            # the similarity in the embeddings' float32, as the JAX
            # package's whole-slide predict scores them
            max_sim, seg = score_candidates(
                emb[d]["tx"], torch.cat(bd_ext[d]), t.cand, h.bd_index_ext,
                normalized=model.normalize_embeddings)
            out[d] = (t.tx_index, seg, max_sim, t.tx_gene, t.tx_valid)
    return out


def make_sharded_predict(model, mesh: Mesh, axis: str = "data"):
    """``fn(shards, halos)`` -> per-shard ``(tx_index, cell_encoding,
    similarity, gene, valid)`` of a strip-sharded slide, the shards and
    halo specs on their devices (:func:`~.mesh.put_sharded`).  The model
    carries its parameters: nothing is compiled or cached."""
    if mesh.shape.get(axis) != mesh.size:
        raise ValueError(f"a strip mesh has the one axis {axis!r}")

    def fn(shards, halos):
        return predict_shards(model, mesh, shards, halos,
                              strip_exchanges(halos, mesh))
    return fn


def make_train_step(model, optimizer, mesh: Mesh, tx_similarity,
                    bd_similarity, exchanges: Callable, tx_margin: float,
                    sg_margin: float, sg_loss_type: str):
    """The whole-slide train step for any decomposition, whose
    ``exchanges(halos, mesh)`` gives the tx and bd exchanges.

    ``step(shards, halos, seeds, randoms, weights) -> (loss, aux)``:
    the forward with dropout on (``seeds[d]`` yields shard ``d``'s seed
    words), one final tx exchange so that the link loss reads the
    neighbours' embeddings, each of this process's shards' loss
    statistics from ``randoms(d, shard)`` (drawn after its forward), and
    one optimizer step.  As in the JAX package each shard's local
    numerators are divided by the global counts, which are detached
    (JAX's ``stop_gradient(psum(...))``), and the gradient is the sum over
    shards: inside a process autograd forms it, since the shards'
    parameters are copies of the one set inside the graph, and on a mesh
    that spans ranks the statistics and then the flat gradient are
    all-reduced (JAX's ``psum``), so that every rank takes the same
    optimizer step.  ``aux`` holds the three masked means and ``loss``
    their weighted sum."""
    home = next(model.parameters()).device
    sims = {}
    for d in mesh.local:
        dev = mesh.devices[d]
        sims.setdefault(dev, (tx_similarity.to(dev), bd_similarity.to(dev)))

    def step(shards, halos, seeds, randoms, weights):
        ex_tx, _ = exchanges(halos, mesh)
        emb = sharded_forward(model, mesh, shards, ex_tx,
                              deterministic=False, seeds=seeds)
        tx_ext = ex_tx([None if e is None else e["tx"] for e in emb])
        stats = []
        for d in mesh.local:
            tx_sim, bd_sim = sims[mesh.devices[d]]
            stats.append(L.loss_stats(
                randoms(d, shards[d]), emb[d], shards[d], tx_sim, bd_sim,
                tx_margin=tx_margin, sg_margin=sg_margin,
                sg_loss_type=sg_loss_type, use_interior=False,
                sg_tx=torch.cat(tx_ext[d])).to(home))
        w = torch.as_tensor(weights, dtype=torch.float32, device=home)
        tot = torch.stack(stats).detach().sum(dim=0)
        if mesh.spans_ranks:
            all_reduce_(tot)
        counts = tot[1::2].clamp(min=1.0)
        local = sum(w[0] * s[0] / counts[0] + w[1] * s[2] / counts[1]
                    + w[2] * s[4] / counts[2] for s in stats)
        aux = tot[0::2] / counts
        loss = w[0] * aux[0] + w[1] * aux[1] + w[2] * aux[2]
        optimizer.zero_grad(set_to_none=True)
        local.backward()
        if mesh.spans_ranks:
            all_reduce_gradients(list(model.parameters()))
        optimizer.step()
        return loss, aux
    return step


def make_sharded_train_step(model, optimizer, mesh: Mesh, tx_similarity,
                            bd_similarity, axis: str = "data",
                            tx_margin: float = 0.3, sg_margin: float = 0.4,
                            sg_loss_type: str = "triplet"):
    """Whole-slide margin-free training step over a strip mesh
    (:func:`make_train_step`).  The reference trains on margin tiles and
    drops cross-tile edges; here the slide itself is sharded and every
    layer refreshes the halo rows, so receptive fields are exact at any
    depth.  Triplet and segmentation negatives are drawn shard-locally,
    as the reference draws them within a tile."""
    if mesh.shape.get(axis) != mesh.size:
        raise ValueError(f"a strip mesh has the one axis {axis!r}")
    return make_train_step(model, optimizer, mesh, tx_similarity,
                           bd_similarity, strip_exchanges, tx_margin,
                           sg_margin, sg_loss_type)


def flat_predictions(per_shard: Sequence[Optional[tuple]], mesh: Mesh
                     ) -> Dict[str, np.ndarray]:
    """Per-shard predict outputs -> flat host arrays of the valid rows,
    the same on every rank (:func:`~.mesh.fetch_global`)."""
    idx, seg, sim, gene, mask = fetch_global(per_shard, mesh)
    m = mask.ravel()
    return {
        "row_index": idx.ravel()[m],
        "cell_encoding": seg.ravel()[m],
        "similarity": sim.ravel()[m],
        "gene": gene.ravel()[m],
    }


def sharded_predict(model, graph: HostGraph, mesh: Mesh,
                    axis: str = "data") -> Dict[str, np.ndarray]:
    """End to end: build the strips, put this process's on their
    devices, run the exchange forward and gather flat prediction arrays
    on the host of every rank."""
    stacked, halo, dropped = build_sharded_graph(graph, mesh.shape[axis])
    if dropped.any():
        logger.warning("halo partition dropped %s non-adjacent-shard "
                       "edges (tt, sg, cand)", dropped.tolist())
    fn = make_sharded_predict(model, mesh, axis)
    return flat_predictions(fn(put_sharded(stacked, mesh),
                               put_sharded(halo, mesh)), mesh)
