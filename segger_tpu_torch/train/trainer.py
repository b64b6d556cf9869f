"""Training and tiled prediction driver for the IST encoder (PyTorch).

``SeggerTrainer.fit`` trains on margin tiles with the JAX package's
semantics: a seeded train/val split of the tiles, shuffled bucketed
packing per epoch, the cosine loss-weight schedule, the joint masked
means of the three losses across the tiles of a step, Adam, a
deterministic validation pass, and checkpoints that the JAX package
reads.  ``SeggerTrainer.predict`` bin-packs halo tiles into batches,
extracts each batch on a background thread, moves it to the device,
runs the encoder and the candidate scoring on every tile, and returns
the assignment of each interior transcript.

The trainer runs on CUDA unless the caller asks for the CPU
(``device="cpu"``), and raises when no CUDA device is present rather
than falling back.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    first_fit_decreasing_bucketed,
    merge_buckets,
    stack_tiles,
    tile_bucket,
)
from ..models import losses as L
from ..models.convert import params_from_flax
from ..models.encoder import ISTEncoder
from ..models.gatv2 import torch_seed_source
from ..ops.gather_agg import score_candidates
from ..ops.padded_csr import PaddedCSR
from .checkpoint import load_checkpoint, save_checkpoint
from .prefetch import PrefetchIterator

logger = logging.getLogger(__name__)


@dataclass
class TrainConfig:
    """Hyperparameters (defaults follow the reference's LitISTEncoder /
    ISTDataModule), as in ``segger_tpu.train.trainer.TrainConfig``.
    ``scan_steps`` is accepted and changes nothing: the JAX package uses
    it to run several steps in one dispatch, with the same result as
    running them one by one, which is what this trainer does."""

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
    """Train and predict driver over a HostGraph and tile specs."""

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
        )
        self.tx_similarity = torch.from_numpy(
            np.asarray(graph.tx_similarity, np.float32)).to(self.device)
        self.bd_similarity = torch.from_numpy(
            np.asarray(graph.bd_similarity, np.float32)).to(self.device)
        self.initialized = False
        self.optimizer: Optional[torch.optim.Adam] = None
        self.history: List[Dict] = []
        # per training step: (epoch, [loss, loss_tx, loss_bd, loss_sg],
        # host seconds from the batch's arrival to its loss on the host)
        self.step_log: List[Tuple[int, List[float], float]] = []
        # epoch-spanning tile-extraction cache (TrainConfig.tile_cache_gb)
        self._tile_cache: Dict = {}
        self._tile_cache_bytes = 0

    # ------------------------------------------------------------------
    def init(self) -> None:
        """Draw the parameters from ``cfg.seed`` (on the CPU, so the draw
        does not depend on the device), install the pretrained gene
        embedding and make a fresh optimizer.  The model is sized from
        the graph, so no template tile is needed."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        model = self.model.cpu()
        model.reset_parameters(gen)
        with torch.no_grad():
            model.gene_embedding.embedding.copy_(
                torch.from_numpy(np.asarray(self.graph.gene_embedding,
                                            np.float32)))
        self.model = model.to(self.device)
        self.initialized = True
        self._make_optimizer()

    def load_params(self, params) -> None:
        """Load a flax-layout parameter tree (nested dict of arrays, as
        ``segger_tpu`` trains and ``train/checkpoint.load_checkpoint``
        reads); every parameter must be present, and nothing else."""
        self.model.load_state_dict(params_from_flax(params), strict=True)
        self.model.to(self.device)
        self.initialized = True
        if self.optimizer is None:
            self._make_optimizer()

    def _make_optimizer(self) -> None:
        """``optax.adam(lr)`` as ``torch.optim.Adam``; with
        ``update_gene_embedding=False`` the gene embedding is frozen (left
        out, as ``optax.masked`` leaves it out)."""
        params = []
        for name, p in self.model.named_parameters():
            frozen = (not self.cfg.update_gene_embedding
                      and name.startswith("gene_embedding."))
            p.requires_grad_(not frozen)
            if not frozen:
                params.append(p)
        self.optimizer = torch.optim.Adam(
            params, lr=self.cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    # ------------------------------------------------------------------
    def _batch_plans(
        self, tiles: Sequence[TileSpec], use_xlo: bool = False,
        shuffle: bool = False, rng: Optional[np.random.Generator] = None,
    ) -> List[Tuple[List[TileSpec], BucketShape]]:
        """Bin-pack tile specs into batch plans: spec lists plus merged
        bucket shapes.  Training shuffles (bucketed first-fit decreasing
        from ``rng``), prediction does not (best-fit decreasing).
        ``use_xlo`` keeps the extra-low degree segment, which prediction
        uses and training does not."""
        if not tiles:
            return []
        values = np.array([max(t.n_edges, 1) for t in tiles])
        if shuffle:
            bins = first_fit_decreasing_bucketed(
                values, self.cfg.edges_per_batch, rng=rng)
        else:
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

    def _extract_cached(self, spec: TileSpec, bucket: BucketShape,
                        cache: bool = True) -> TileGraph:
        """``extract_tile`` through the epoch-spanning cache, keyed by
        (spec identity, bucket shape).  ``cache=False`` reads hits but
        inserts nothing (tiles that nothing will read again)."""
        if self.cfg.tile_cache_gb <= 0:
            return extract_tile(self.graph, spec, bucket)
        key = (id(spec), dataclasses.astuple(bucket))
        hit = self._tile_cache.get(key)
        if hit is not None:
            return hit[1]
        tile = extract_tile(self.graph, spec, bucket)
        if not cache:
            return tile
        nbytes = 0
        for f in dataclasses.fields(tile):
            v = getattr(tile, f.name)
            arrays = (v.idx, v.mask) if isinstance(v, PaddedCSR) else (v,)
            nbytes += sum(a.nbytes for a in arrays if hasattr(a, "nbytes"))
        if self._tile_cache_bytes + nbytes <= self.cfg.tile_cache_gb * 1e9:
            # the spec rides in the value to pin its id() for the key
            self._tile_cache[key] = (spec, tile)
            self._tile_cache_bytes += nbytes
        return tile

    def release_tile_cache(self) -> None:
        """Drop the epoch-spanning tile-extraction cache: its only value
        is across fit epochs."""
        self._tile_cache = {}
        self._tile_cache_bytes = 0

    def _build_batch(self, plan, cache: bool = True) -> TileGraph:
        """Extract and stack one plan's tiles, rounded up to
        ``tiles_per_step`` with empty tiles."""
        specs, bucket = plan
        tgs = [self._extract_cached(s, bucket, cache) for s in specs]
        while len(tgs) % self.cfg.tiles_per_step:
            tgs.append(empty_tile(
                bucket, self.graph.bd_x.shape[1],
                c_tx=self.graph.tx_similarity.shape[0],
                c_bd=self.graph.bd_similarity.shape[0],
            ))
        return stack_tiles(tgs)

    # ------------------------------------------------------------------
    def split_tiles(self, fit_tiles: Sequence[TileSpec]
                    ) -> Tuple[List[TileSpec], List[TileSpec]]:
        """The seeded train/val split of the fit tiles (the JAX
        package's: a permutation from ``default_rng(cfg.seed)``)."""
        rng = np.random.default_rng(self.cfg.seed)
        n = len(fit_tiles)
        perm = rng.permutation(n)
        split = int(self.cfg.training_fraction * n)
        train = [fit_tiles[i] for i in perm[:split]]
        val = [fit_tiles[i] for i in perm[split:]]
        return (train or list(fit_tiles)), val

    def epoch_streams(self, epoch: int
                      ) -> Tuple[np.random.Generator, torch.Generator]:
        """The epoch's packing rng (``default_rng([seed, epoch])``, as the
        JAX package) and its torch generator of dropout seeds and loss
        draws, derived from ``(seed + 1, epoch)``; a resumed run draws
        what an uninterrupted one would."""
        state = np.random.SeedSequence(
            [self.cfg.seed + 1, epoch]).generate_state(1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(state))
        return np.random.default_rng([self.cfg.seed, epoch]), gen

    def weights(self, epoch: int, max_epochs: int) -> np.ndarray:
        cfg = self.cfg
        return L.cosine_weight_schedule(
            epoch, max_epochs,
            np.array([cfg.tx_weight_start, cfg.bd_weight_start,
                      cfg.sg_weight_start]),
            np.array([cfg.tx_weight_end, cfg.bd_weight_end,
                      cfg.sg_weight_end]),
        )

    def _loss(self, batch: TileGraph, gen: torch.Generator,
              weights: np.ndarray, deterministic: bool):
        """The step loss over a device batch and its three parts: each
        tile draws its dropout seeds (forward) and its loss randoms from
        ``gen``, and the per-tile ``(sum, count)`` statistics are summed
        before the masked means, as the JAX package's joint means."""
        seeds = torch_seed_source(gen)
        stats = []
        for b in range(batch.tx_gene.shape[0]):
            tile = batch.map_arrays(lambda a: a[b])
            emb = self.model(tile, deterministic=deterministic, seeds=seeds)
            stats.append(L.loss_stats(
                L.draw_loss_randoms(tile, gen), emb, tile,
                self.tx_similarity, self.bd_similarity,
                tx_margin=self.cfg.tx_margin, sg_margin=self.cfg.sg_margin,
                sg_loss_type=self.cfg.sg_loss_type, use_interior=True,
            ))
        tot = torch.stack(stats).sum(dim=0)
        parts = tot[0::2] / tot[1::2].clamp(min=1.0)
        w = torch.from_numpy(weights).to(parts.device)
        loss = w[0] * parts[0] + w[1] * parts[1] + w[2] * parts[2]
        return loss, parts

    def train_step(self, batch: TileGraph, gen: torch.Generator,
                   weights: np.ndarray) -> List[float]:
        """One optimizer step on a device batch with dropout on; returns
        ``[loss, loss_tx, loss_bd, loss_sg]``."""
        loss, parts = self._loss(batch, gen, weights, deterministic=False)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return torch.cat([loss[None], parts]).tolist()

    def eval_step(self, batch: TileGraph, gen: torch.Generator,
                  weights: np.ndarray) -> List[float]:
        """The validation loss of a device batch (no dropout, no grad)."""
        with torch.no_grad():
            loss, parts = self._loss(batch, gen, weights, deterministic=True)
        return torch.cat([loss[None], parts]).tolist()

    def fit(
        self,
        fit_tiles: Sequence[TileSpec],
        max_epochs: Optional[int] = None,
        on_epoch_end: Optional[Callable] = None,
    ) -> List[Dict]:
        """Train/val loop over margin tiles (``make_fit_tiles``).

        Per epoch: shuffled bucketed packing without the extra-low degree
        segment, the cosine loss weights, one Adam step per batch with
        dropout on, then a deterministic validation pass; one history
        record per epoch with the JAX package's keys.
        ``on_epoch_end(epoch, trainer)`` runs after each record.  With
        ``checkpoint_dir``, ``latest.npz`` is resumed from at the epoch
        after its own and written every ``checkpoint_every`` epochs."""
        cfg = self.cfg
        max_epochs = cfg.max_epochs if max_epochs is None else max_epochs
        train_tiles, val_tiles = self.split_tiles(fit_tiles)
        val_plans = self._batch_plans(val_tiles)
        if not self.initialized:
            self.init()
        start_epoch = 0
        latest = Path(cfg.checkpoint_dir) / "latest.npz" \
            if cfg.checkpoint_dir else None
        if latest is not None and latest.exists():
            params, meta = load_checkpoint(latest, self.model,
                                           self.optimizer)
            self.model.load_state_dict(params_from_flax(params), strict=True)
            start_epoch = int(meta.get("extra", {}).get("epoch", -1)) + 1
            logger.info("resumed from epoch %d", start_epoch)

        for epoch in range(start_epoch, max_epochs):
            weights = self.weights(epoch, max_epochs)
            erng, gen = self.epoch_streams(epoch)
            # the cache pays only across epochs: the last inserts nothing
            cache = epoch < max_epochs - 1
            plans = self._batch_plans(train_tiles, shuffle=True, rng=erng)
            ep_loss = []
            with PrefetchIterator(
                    plans, lambda p: self._build_batch(p, cache)) as batches:
                for batch in batches:
                    t0 = time.perf_counter()
                    rec = self.train_step(batch.to(self.device), gen,
                                          weights)
                    self.step_log.append(
                        (epoch, rec, time.perf_counter() - t0))
                    ep_loss.append(rec)
            rec = {"epoch": epoch}
            rec.update(_means("train", ep_loss))
            if val_plans:
                vl = []
                with PrefetchIterator(
                        val_plans,
                        lambda p: self._build_batch(p, cache)) as batches:
                    for batch in batches:
                        vl.append(self.eval_step(batch.to(self.device), gen,
                                                 weights))
                rec.update(_means("val", vl))
            logger.info("epoch %d: %s", epoch, rec)
            self.history.append(rec)
            if on_epoch_end is not None:
                on_epoch_end(epoch, self)
            if latest is not None and cfg.checkpoint_every \
                    and (epoch + 1) % cfg.checkpoint_every == 0:
                save_checkpoint(latest, self.model, self.optimizer,
                                config=cfg, extra={"epoch": epoch})
        return self.history

    # ------------------------------------------------------------------
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
        self.release_tile_cache()
        plans = self._batch_plans(predict_tiles, use_xlo=True)
        with torch.no_grad(), PrefetchIterator(
                plans, lambda p: self._build_batch(p, cache=False)
        ) as batches:
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


def _means(prefix: str, rows: List[List[float]]) -> Dict[str, float]:
    """Epoch means of ``[loss, loss_tx, loss_bd, loss_sg]`` rows."""
    keys = ("loss", "loss_tx", "loss_bd", "loss_sg")
    return {f"{prefix}:{k}": float(np.mean([r[i] for r in rows]))
            for i, k in enumerate(keys)}
