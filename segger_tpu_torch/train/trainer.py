"""Tiled prediction driver for the IST encoder (PyTorch).

``SeggerTrainer.predict`` bin-packs halo tiles into batches, extracts
each batch on a background thread, moves it to the device, runs the
encoder and the candidate scoring on every tile, and returns the
assignment of each interior transcript.  Training (``fit``, the losses,
Adam) waits for a later slice of the port.

The trainer runs on CUDA unless the caller asks for the CPU
(``device="cpu"``), and raises when no CUDA device is present rather
than falling back.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.assemble import HostGraph
from ..data.graph import TileGraph
from ..data.partition import (
    BucketShape,
    TileSpec,
    best_fit_decreasing,
    empty_tile,
    extract_tile,
    merge_buckets,
    stack_tiles,
    tile_bucket,
)
from ..models.convert import params_from_flax
from ..models.encoder import ISTEncoder
from ..ops.gather_agg import score_candidates
from .prefetch import PrefetchIterator


@dataclass
class TrainConfig:
    """Hyperparameters (defaults follow the reference's LitISTEncoder /
    ISTDataModule), as in ``segger_tpu.train.trainer.TrainConfig``.
    Fields that only training reads are kept for the training slice."""

    in_channels: int = 16
    hidden_channels: int = 64
    out_channels: int = 64
    n_mid_layers: int = 2
    n_heads: int = 2
    learning_rate: float = 1e-3
    sg_loss_type: str = "triplet"
    tx_margin: float = 0.3
    sg_margin: float = 0.4
    tx_weight_start: float = 1.0
    tx_weight_end: float = 1.0
    bd_weight_start: float = 1.0
    bd_weight_end: float = 1.0
    sg_weight_start: float = 0.0
    sg_weight_end: float = 0.5
    update_gene_embedding: bool = True
    use_positional_embeddings: bool = True
    normalize_embeddings: bool = True
    compute_dtype: str = "bfloat16"  # params stay float32; 'float32'
                                     # opts out
    max_epochs: int = 20
    edges_per_batch: int = 1_000_000
    training_fraction: float = 0.75
    tiles_per_step: int = 1
    seed: int = 0
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    scan_steps: int = 0
    # 'global' pads every batch of a pass to one merged bucket shape;
    # 'bin' keeps per-bin merged shapes
    shape_merge: str = "global"
    tile_cache_gb: float = 24.0


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: segger_tpu_torch runs on the GPU; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return device


class SeggerTrainer:
    """Predict driver over a HostGraph and tile specs."""

    def __init__(
        self,
        graph: HostGraph,
        config: Optional[TrainConfig] = None,
        device=None,
    ):
        self.graph = graph
        self.cfg = TrainConfig() if config is None else config
        self.device = resolve_device(device)
        self.dtype = (
            torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else None
        )
        cfg = self.cfg
        # the pretrained gene embedding sets in_channels
        self.in_channels = graph.gene_embedding.shape[1]
        self.model = ISTEncoder(
            n_genes=graph.n_genes,
            n_bd_features=graph.bd_x.shape[1],
            in_channels=self.in_channels,
            hidden_channels=cfg.hidden_channels,
            out_channels=cfg.out_channels,
            n_mid_layers=cfg.n_mid_layers,
            n_heads=cfg.n_heads,
            normalize_embeddings=cfg.normalize_embeddings,
            use_positional_embeddings=cfg.use_positional_embeddings,
            dtype=self.dtype,
        ).eval()
        self.initialized = False

    # ------------------------------------------------------------------
    def init(self) -> None:
        """Draw the parameters from ``cfg.seed`` (on the CPU, so the draw
        does not depend on the device) and install the pretrained gene
        embedding.  The model is sized from the graph, so no template
        tile is needed."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        model = self.model.cpu()
        model.reset_parameters(gen)
        with torch.no_grad():
            model.gene_embedding.embedding.copy_(
                torch.from_numpy(np.asarray(self.graph.gene_embedding,
                                            np.float32)))
        self.model = model.to(self.device)
        self.initialized = True

    def load_params(self, params) -> None:
        """Load a flax-layout parameter tree (nested dict of arrays, as
        ``segger_tpu`` trains and ``train/checkpoint.load_checkpoint``
        reads); every parameter must be present, and nothing else."""
        self.model.load_state_dict(params_from_flax(params), strict=True)
        self.model.to(self.device)
        self.initialized = True

    # ------------------------------------------------------------------
    def _batch_plans(
        self, tiles: Sequence[TileSpec], use_xlo: bool = False,
    ) -> List[Tuple[List[TileSpec], BucketShape]]:
        """Bin-pack tile specs (best-fit decreasing on edge counts) into
        batch plans: spec lists plus merged bucket shapes.  ``use_xlo``
        keeps the extra-low degree segment, which prediction uses."""
        if not tiles:
            return []
        values = np.array([max(t.n_edges, 1) for t in tiles])
        bins = best_fit_decreasing(values, self.cfg.edges_per_batch)
        all_shapes = [tile_bucket(self.graph, s) for s in tiles]
        per_bin = []
        for bin_idx in bins:
            bucket = merge_buckets([all_shapes[i] for i in bin_idx])
            if not use_xlo and bucket.n_xlo:
                bucket = dataclasses.replace(bucket, n_xlo=0, k_xlo=0)
            per_bin.append(([tiles[i] for i in bin_idx], bucket))
        if self.cfg.shape_merge == "global":
            g = merge_buckets([b for _, b in per_bin])
            per_bin = [(specs, g) for specs, _ in per_bin]
        m = self.cfg.tiles_per_step
        return [
            (specs[s : s + m], bucket)
            for specs, bucket in per_bin
            for s in range(0, len(specs), m)
        ]

    def _build_batch(self, plan) -> TileGraph:
        """Extract and stack one plan's tiles, rounded up to
        ``tiles_per_step`` with empty tiles."""
        specs, bucket = plan
        tgs = [extract_tile(self.graph, s, bucket) for s in specs]
        while len(tgs) % self.cfg.tiles_per_step:
            tgs.append(empty_tile(
                bucket, self.graph.bd_x.shape[1],
                c_tx=self.graph.tx_similarity.shape[0],
                c_bd=self.graph.bd_similarity.shape[0],
            ))
        return stack_tiles(tgs)

    def _predict_tile(self, tile: TileGraph):
        emb = self.model(tile)
        max_sim, seg = score_candidates(
            emb["tx"], emb["bd"], tile.cand, tile.bd_index,
            dtype=self.dtype, normalized=self.cfg.normalize_embeddings,
        )
        m = tile.tx_interior & tile.tx_valid
        return tile.tx_index[m], seg[m], max_sim[m], tile.tx_gene[m]

    def _predict_batches(self, predict_tiles: Sequence[TileSpec]):
        """Per batch, the concatenated (row_index, cell_encoding,
        similarity, gene) NumPy arrays of its interior transcripts."""
        if not self.initialized:
            raise RuntimeError("call init() or load_params() first")
        plans = self._batch_plans(predict_tiles, use_xlo=True)
        with torch.no_grad(), PrefetchIterator(
                plans, self._build_batch) as batches:
            for batch in batches:
                dev = batch.to(self.device)
                n_tiles = dev.tx_gene.shape[0]
                outs = [self._predict_tile(dev.map_arrays(lambda a: a[b]))
                        for b in range(n_tiles)]
                yield tuple(
                    torch.cat([o[i] for o in outs]).cpu().numpy()
                    for i in range(4)
                )

    def predict(
        self, predict_tiles: Sequence[TileSpec]
    ) -> Dict[str, np.ndarray]:
        """Prediction over halo tiles: flat arrays of (row_index,
        cell_encoding, similarity, gene) for interior transcripts."""
        keys = ("row_index", "cell_encoding", "similarity", "gene")
        out = {k: [] for k in keys}
        for parts in self._predict_batches(predict_tiles):
            for k, a in zip(keys, parts):
                out[k].append(a)
        return {k: np.concatenate(v) if v else np.zeros(0)
                for k, v in out.items()}

    def predict_streaming(
        self,
        predict_tiles: Sequence[TileSpec],
        n_rows: Optional[int] = None,
        best_sim: Optional[np.ndarray] = None,
        best_enc: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Prediction into dense row_index-addressed arrays, max-merged
        batch by batch (O(n_rows) host memory; the merge is the
        reference's cross-tile dedupe).

        Returns ``(best_sim f32, best_enc int32)``: ``enc == -2`` never
        predicted, ``-1`` predicted but unassigned.
        """
        if best_sim is None:
            if n_rows is None:
                n_rows = int(self.graph.tx_index.max()) + 1
            best_sim = np.full(n_rows, -np.inf, np.float32)
            best_enc = np.full(n_rows, -2, np.int32)
        for idx, seg, sim, _ in self._predict_batches(predict_tiles):
            r = idx.astype(np.int64)
            if not r.size:
                continue
            # resolve duplicates within the batch: best similarity first
            order = np.lexsort((-sim, r))
            first = np.empty(order.size, bool)
            first[0] = True
            first[1:] = r[order[1:]] != r[order[:-1]]
            keep = order[first]
            rk, sk, ek = r[keep], sim[keep], seg[keep]
            upd = sk > best_sim[rk]
            best_sim[rk[upd]] = sk[upd]
            best_enc[rk[upd]] = ek[upd]
        return best_sim, best_enc
