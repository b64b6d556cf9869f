"""ISTEncoder: heterogeneous GATv2 stack embedding transcripts and cells
into a shared metric space.

Architecture of the reference's ``ISTEncoder`` and of
``segger_tpu/models/encoder.py``:

  - gene embedding for tx, ``Dense`` for bd, each to ``in_channels``
  - concat of the 2D sinusoidal positional embedding, then exact GELU
  - (2 + n_mid_layers) hetero GATv2 layers, GELU after each
  - per-type ``Dense`` to ``out_channels``, then L2 normalization

Each hetero layer runs a GATv2 conv over tx->tx neighbor edges and one
over the tx->bd supervision ('belongs') edges, the reference's quirk; its
bd->tx conv never receives edges, so it is built only with
``use_bd_to_tx=True`` and runs only on tiles that carry a ``bt`` table.
Every conv has the attention dropout ``attn_dropout`` (0.2, the
reference's), active in ``forward(..., deterministic=False)``.

A conv runs the fused edge stage when the tile carries its transpose
tables (or the degree-bucketed split) and the unfused one otherwise, as
in the JAX package; ``forward(..., capture_attention=True)`` forces the
unfused path everywhere so that each conv's attention is recorded.
``forward(..., intermediates={})`` fills the dict under the flax
``intermediates`` names: ``embed_tx``, ``embed_bd``, ``layer{i}_tx``,
``layer{i}_bd`` (post-conv, pre-GELU) and ``conv_{i}/{tt,tb,bt}/
attention`` for each conv that ran unfused.

The forward is three steps, :meth:`ISTEncoder.embed`,
:meth:`ISTEncoder.layer` per layer and :meth:`ISTEncoder.head`, so that
the whole-slide paths (``parallel/halo.py``) can run every shard's layer
``i`` and exchange the halo rows before layer ``i + 1``; a layer then
reads halo-extended sources (``x_tx_src``).

Submodule and parameter names follow the flax parameter tree, so
``models/convert.py`` maps one onto the other by name.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..data.graph import TileGraph
from ..ops.embed import embed_lookup
from .gatv2 import GATv2Conv, Segment, SeedSource
from .positional import Positional2dEmbedder, dense


def safe_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2 normalize with ``F.normalize`` semantics (zero rows stay
    zero), as the JAX package computes it."""
    sq = (x * x).sum(dim=-1, keepdim=True)
    norm = torch.sqrt(sq.clamp(min=eps * eps))
    return torch.where(sq > eps * eps, x / norm, 0.0)


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (+-2 std), variance
    1/fan_in, on an (out, in) torch weight."""
    std = (1.0 / t.shape[1]) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        t.normal_(generator=generator)
        while True:
            bad = t.abs() > 2.0
            if not bad.any():
                break
            t[bad] = torch.randn(int(bad.sum()), generator=generator)
        t.mul_(std)


class DenseGradEmbed(nn.Module):
    """Embedding table with the flax layout (a single 'embedding')."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self.embedding, ids)


class HeteroGATLayer(nn.Module):
    """One SkipGAT-equivalent layer: tx->tx and tx->bd GATv2, per
    destination type, plus the bd->tx conv with ``use_bd_to_tx``."""

    def __init__(self, in_channels: int, out_channels: int, heads: int,
                 dropout: float = 0.2, dtype: Optional[torch.dtype] = None,
                 use_bd_to_tx: bool = False):
        super().__init__()
        self.tt = GATv2Conv(in_channels, out_channels, heads,
                            dropout=dropout, dtype=dtype)
        self.tb = GATv2Conv(in_channels, out_channels, heads,
                            dropout=dropout, dtype=dtype)
        self.bt = (GATv2Conv(in_channels, out_channels, heads,
                             dropout=dropout, dtype=dtype)
                   if use_bd_to_tx else None)

    def forward(self, x_tx, x_bd, tile: TileGraph,
                segments: Tuple[Optional[List[Segment]],
                                Optional[List[Segment]]],
                deterministic: bool = True,
                seeds: Optional[SeedSource] = None,
                capture_attention: bool = False,
                intermediates: Optional[Dict[str, torch.Tensor]] = None,
                prefix: str = "", x_tx_src=None, x_bd_src=None):
        """``segments``: the tt and tb launches of the fused edge stage,
        None where the conv runs unfused.  ``x_tx_src`` / ``x_bd_src``
        replace the source features (halo-extended copies, one tensor or
        a tuple of pieces, in whole-slide execution); destinations stay
        local."""
        if x_tx_src is None:
            x_tx_src = x_tx
        if x_bd_src is None:
            x_bd_src = x_bd
        tt_segs, tb_segs = segments
        kw = dict(deterministic=deterministic, seeds=seeds,
                  capture_attention=capture_attention,
                  intermediates=intermediates)
        out_tx = self.tt(x_tx_src, x_tx, tile.tt, segments=tt_segs,
                         name=f"{prefix}tt/attention", **kw)
        out_bd = self.tb(x_tx_src, x_bd, tile.tb, segments=tb_segs,
                         name=f"{prefix}tb/attention", **kw)
        if self.bt is not None and tile.bt is not None:
            out_tx = out_tx + self.bt(x_bd_src, x_tx, tile.bt,
                                      name=f"{prefix}bt/attention", **kw)
        return out_tx, out_bd


def conv_segments(tile: TileGraph):
    """The fused launches of a tile's tt and tb convs (``tt_segments``;
    tb as one segment), None for a conv whose transpose tables the tile
    lacks: that conv runs unfused, as in the JAX package."""
    return (tt_segments(tile), None if tile.tb_t is None else [
        (0, tile.tb.idx.shape[0], tile.tb.idx, tile.tb.mask, tile.tb_t)])


def whole_table_segments(tile: TileGraph):
    """Each conv's table as one fused launch with its transpose table,
    None where the tile has none: the whole-slide shards, which are not
    degree-bucketed.  Without a transpose table the launch runs the
    forward kernel alone, and a backward through it raises."""
    return ([(0, tile.tt.idx.shape[0], tile.tt.idx, tile.tt.mask,
              tile.tt_t)],
            [(0, tile.tb.idx.shape[0], tile.tb.idx, tile.tb.mask,
              tile.tb_t)])


def tt_segments(tile: TileGraph) -> Optional[List[Segment]]:
    """The tt edge stage's launches over a degree-bucketed tile: the
    extra-low and low segments at their narrow widths, then the
    full-width tail, each with its transpose table.  As in the JAX
    package the split is taken only when the tile carries the
    per-segment transpose tables; otherwise the whole table is one
    segment with the full transpose, and without that the conv runs
    unfused (None)."""
    idx, mask = tile.tt.idx, tile.tt.mask
    n = idx.shape[0]
    bounds = _tt_bounds(tile, n, idx.shape[1])
    if bounds is None:
        if tile.tt_t is None:
            return None
        return [(0, n, idx, mask, tile.tt_t)]
    return [(a, b, idx[a:b, :k].contiguous(), mask[a:b, :k].contiguous(), t)
            for a, b, k, t in bounds]


def _tt_bounds(tile: TileGraph, n: int, k: int):
    """``(start, stop, K, transpose table)`` of each degree segment of an
    (n, k) tt table, or None when the tile carries no per-segment
    transpose tables."""
    if not (tile.tt_n_lo > 0 and tile.tt_lo_t is not None
            and tile.tt_hi_t is not None):
        return None
    if tile.tt_n_xlo > 0 and tile.tt_xlo_t is not None:
        bounds = [(0, tile.tt_n_xlo, tile.tt_k_xlo, tile.tt_xlo_t),
                  (tile.tt_n_xlo, tile.tt_n_lo, tile.tt_k_lo, tile.tt_lo_t)]
    else:
        bounds = [(0, tile.tt_n_lo, tile.tt_k_lo, tile.tt_lo_t)]
    bounds.append((tile.tt_n_lo, n, k, tile.tt_hi_t))
    return bounds


class ISTEncoder(nn.Module):
    def __init__(
        self,
        n_genes: int,
        n_bd_features: int,
        in_channels: int = 16,
        hidden_channels: int = 32,
        out_channels: int = 32,
        n_mid_layers: int = 3,
        n_heads: int = 3,
        normalize_embeddings: bool = True,
        use_positional_embeddings: bool = True,
        attn_dropout: float = 0.2,
        dtype: Optional[torch.dtype] = None,
        use_bd_to_tx: bool = False,
    ):
        """``dtype``: compute dtype of the GATv2 layers (e.g.
        ``torch.bfloat16``); parameters stay float32.  ``use_bd_to_tx``
        builds the dormant bd->tx conv of every layer."""
        super().__init__()
        self.normalize_embeddings = normalize_embeddings
        self.gene_embedding = DenseGradEmbed(n_genes, in_channels)
        self.bd_linear = nn.Linear(n_bd_features, in_channels)
        width = in_channels
        self.pos_emb = None
        if use_positional_embeddings:
            self.pos_emb = Positional2dEmbedder(in_channels)
            width += 2 * (in_channels // 2)
        widths = [hidden_channels] * (1 + n_mid_layers) + [out_channels]
        for i, w in enumerate(widths):
            self.add_module(
                f"conv_{i}",
                HeteroGATLayer(width, w, n_heads, attn_dropout, dtype,
                               use_bd_to_tx)
            )
            width = n_heads * w
        self.n_layers = len(widths)
        self.lin_last_tx = nn.Linear(width, out_channels)
        self.lin_last_bd = nn.Linear(width, out_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from ``generator``."""
        with torch.no_grad():
            self.gene_embedding.embedding.normal_(generator=generator)
        dense_layers = [self.bd_linear, self.lin_last_tx, self.lin_last_bd]
        if self.pos_emb is not None:
            dense_layers += [self.pos_emb.Dense_0, self.pos_emb.Dense_1]
        for lin in dense_layers:
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        for i in range(self.n_layers):
            layer = getattr(self, f"conv_{i}")
            for conv in (layer.tt, layer.tb, layer.bt):
                if conv is not None:
                    conv.reset_parameters(generator)
        # the reference's final projection is a torch Linear, whose bias
        # init keeps isolated nodes off the exact-zero embedding
        for lin in (self.lin_last_tx, self.lin_last_bd):
            bound = 1.0 / lin.in_features ** 0.5
            with torch.no_grad():
                lin.bias.uniform_(-bound, bound, generator=generator)

    def seed_launches(self, tile: TileGraph) -> int:
        """The seed-word pairs one forward of ``tile`` (fused, dropout
        on) draws: one per edge-stage launch of each conv with dropout,
        i.e. per tt segment, tb, and bt where it runs.  ``tile`` may hold
        NumPy arrays or a batch; only its static fields are read."""
        n_tt = len(_tt_bounds(tile, 0, 0) or [None])
        count = 0
        for i in range(self.n_layers):
            layer = getattr(self, f"conv_{i}")
            for conv, n in ((layer.tt, n_tt), (layer.tb, 1),
                            (layer.bt, int(tile.bt is not None))):
                if conv is not None and conv.dropout > 0.0:
                    count += n
        return count

    def embed(self, tile: TileGraph, pos_prenormalized: bool = False,
              intermediates: Optional[Dict[str, torch.Tensor]] = None):
        """The first projection of both node types: gene embedding / bd
        ``Dense``, the positional embedding (of coordinates already in
        [0, 1] when ``pos_prenormalized``), then GELU."""
        x_tx = self.gene_embedding(tile.tx_gene)
        x_bd = dense(self.bd_linear, tile.bd_x)
        if self.pos_emb is not None:
            x_tx = torch.cat([x_tx, self.pos_emb(
                tile.tx_pos, tile.tx_valid, pos_prenormalized)], dim=-1)
            x_bd = torch.cat([x_bd, self.pos_emb(
                tile.bd_pos, tile.bd_valid, pos_prenormalized)], dim=-1)
        # exact (erf) GELU, the reference's
        x_tx, x_bd = F.gelu(x_tx), F.gelu(x_bd)
        if intermediates is not None:
            intermediates["embed_tx"] = x_tx
            intermediates["embed_bd"] = x_bd
        return x_tx, x_bd

    def layer(self, i: int, x_tx, x_bd, tile: TileGraph,
              deterministic: bool = True,
              seeds: Optional[SeedSource] = None,
              x_tx_src=None, x_bd_src=None, segments=None,
              capture_attention: bool = False,
              intermediates: Optional[Dict[str, torch.Tensor]] = None):
        """Hetero layer ``i``, then GELU.  ``segments`` defaults to the
        tile's :func:`conv_segments` when the sources are local or the
        tile's transpose tables address the extended source space
        (``transposes_extended``), and to the unfused convs otherwise,
        the JAX package's rule."""
        if segments is None:
            segments = (conv_segments(tile) if x_tx_src is None
                        or tile.transposes_extended else (None, None))
        x_tx, x_bd = getattr(self, f"conv_{i}")(
            x_tx, x_bd, tile, segments, deterministic, seeds,
            capture_attention, intermediates, prefix=f"conv_{i}/",
            x_tx_src=x_tx_src, x_bd_src=x_bd_src)
        if intermediates is not None:
            intermediates[f"layer{i}_tx"] = x_tx
            intermediates[f"layer{i}_bd"] = x_bd
        return F.gelu(x_tx), F.gelu(x_bd)

    def head(self, x_tx, x_bd) -> Dict[str, torch.Tensor]:
        """The final per-type ``Dense``, then L2 normalization."""
        x_tx = dense(self.lin_last_tx, x_tx)
        x_bd = dense(self.lin_last_bd, x_bd)
        if self.normalize_embeddings:
            x_tx, x_bd = safe_normalize(x_tx), safe_normalize(x_bd)
        return {"tx": x_tx, "bd": x_bd}

    def forward(self, tile: TileGraph, deterministic: bool = True,
                seeds: Optional[SeedSource] = None,
                capture_attention: bool = False,
                intermediates: Optional[Dict[str, torch.Tensor]] = None,
                pos_prenormalized: bool = False,
                ) -> Dict[str, torch.Tensor]:
        """Embeddings of one tile (tensors on the model's device, no
        batch axis): ``{"tx": (Ntx, out), "bd": (Nbd, out)}``.

        ``deterministic=False`` turns the attention dropout on; ``seeds``
        then yields each edge-stage launch's two seed words in launch
        order (layer by layer: the tt segments, then tb, then bt), drawn
        from torch's default generator when None.  ``capture_attention``
        runs every conv unfused; ``intermediates``, a dict, receives the
        activations and attentions named in the module docstring.
        ``pos_prenormalized``: the coordinates are in [0, 1] already.
        :meth:`embed`, :meth:`layer` and :meth:`head` are its steps, which
        the whole-slide paths (``parallel/``) run layer by layer across
        shards."""
        x_tx, x_bd = self.embed(tile, pos_prenormalized, intermediates)
        segments = conv_segments(tile)
        for i in range(self.n_layers):
            x_tx, x_bd = self.layer(i, x_tx, x_bd, tile, deterministic,
                                    seeds, segments=segments,
                                    capture_attention=capture_attention,
                                    intermediates=intermediates)
        return self.head(x_tx, x_bd)
