"""Training and tiled prediction driver for the IST encoder (PyTorch).

``SeggerTrainer.fit`` trains on margin tiles with the JAX package's
semantics: a seeded train/val split of the tiles, shuffled bucketed
packing per epoch, the cosine loss-weight schedule, the joint masked
means of the three losses across the tiles of a step, Adam, a
deterministic validation pass, and checkpoints that the JAX package
reads.  ``SeggerTrainer.predict`` bin-packs halo tiles into batches,
extracts each batch on a background thread, runs the encoder and the
candidate scoring on every tile, and returns the assignment of each
interior transcript.

Every train, eval and predict step is a :class:`~.graphs.CompiledStep`,
the port of the JAX package's ``jax.jit`` steps: on CUDA it is captured
as a CUDA graph once per kind and input signature (one bucket shape
under ``shape_merge="global"``) and replayed for every batch, the host
staging each batch, its dropout seed words and its loss uniforms into
the step's inputs; on the CPU the same step body runs eagerly.  There is
no eager path on CUDA: a capture or replay that fails raises.
``train_step`` and ``eval_step`` stay eager, for comparisons.

With a mesh of several shards (``SeggerTrainer(mesh=)``), ``fit``,
``predict`` and ``predict_streaming`` are tile data parallel, as the JAX
package's sharded steps: each batch's tiles split into one equal group
per shard, each shard runs its group on its own device through its own
replica of the model and its own compiled steps, the loss is the joint
masked means over the whole batch (the shards' ``(sum, count)``
statistics summed, then divided), the shards' gradients are summed on the
model's device for one Adam step, and the new parameters go back to the
replicas.  The random numbers are drawn in the one-device order, tile by
tile in global tile order, so a mesh step uses the draws of the one-device
step at the same ``tiles_per_step``; predictions come back in global tile
order.  The shard steps are split CUDA graphs (``graphs.SplitStep``):
the reduction between them is eager.

``SeggerTrainer.predict_whole_slide`` and ``fit_whole_slide`` run the
slide itself, sharded into strips or a grid over a mesh of devices with a
per-layer halo exchange (``parallel/``): exact receptive fields, no
margins, one optimizer step per epoch.  They run eagerly, in one process
or, after ``parallel.mesh.initialize_multihost``, over the ranks of a
``torch.distributed`` group, each driving its own shards, with the same
results.

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
from ..models.gatv2 import BufferSeedSource, torch_seed_source
from ..ops.gather_agg import score_candidates
from ..ops.padded_csr import PaddedCSR
from ..ops.postgather import seed_int32
from ..utils_profiling import count, substage
from .checkpoint import load_checkpoint, save_checkpoint
from ..parallel.mesh import Replicas, reduce_gradients
from .graphs import (
    CapturedCall, CompiledStep, SplitStep, StepInputs, signature, tile_arrays,
)
from .prefetch import PrefetchIterator

logger = logging.getLogger(__name__)


@dataclass
class TrainConfig:
    """Hyperparameters (defaults follow the reference's LitISTEncoder /
    ISTDataModule), as in ``segger_tpu.train.trainer.TrainConfig``.
    A step's loss row comes back to the host one step late, while the
    device runs the next step.  ``scan_steps = S > 0`` reads the rows S
    at a time, still behind the newest step (the JAX package runs S steps
    in one dispatch); the result equals ``scan_steps = 0``, which reads
    every step's on its own."""

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
        mesh=None,
    ):
        """``mesh`` (``parallel.mesh.Mesh``): with several shards ``fit``,
        ``predict`` and ``predict_streaming`` shard each batch's tiles over
        it (tile data parallelism); it is also the whole-slide paths'
        default mesh.  With a mesh, ``tiles_per_step`` becomes a multiple
        of its size on a copy of ``config``, as in the JAX package; the
        caller's config is never changed."""
        self.graph = graph
        self.mesh = mesh
        config = TrainConfig() if config is None else config
        if mesh is not None and config.tiles_per_step % mesh.size:
            config = dataclasses.replace(
                config, tiles_per_step=mesh.size * max(
                    1, config.tiles_per_step // mesh.size))
        self.cfg = config
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
        # owned copies: a graph plane's arrays are read-only memmaps,
        # which torch.from_numpy would share (and warn about)
        self.tx_similarity = torch.from_numpy(
            np.array(graph.tx_similarity, np.float32)).to(self.device)
        self.bd_similarity = torch.from_numpy(
            np.array(graph.bd_similarity, np.float32)).to(self.device)
        self.initialized = False
        self.optimizer: Optional[torch.optim.Adam] = None
        self.history: List[Dict] = []
        # per training step: (epoch, [loss, loss_tx, loss_bd, loss_sg],
        # host seconds from the step's staging to its loss row on the
        # host, which comes back one step late)
        self.step_log: List[Tuple[int, List[float], float]] = []
        # epoch-spanning tile-extraction cache (TrainConfig.tile_cache_gb)
        self._tile_cache: Dict = {}
        self._tile_cache_bytes = 0
        # bytes the steps' inputs took in and their outputs gave back (on
        # CUDA the pinned staging copies), as the JAX package counts them
        self.bytes_to_device = 0
        self.bytes_to_host = 0
        # compiled steps by (kind, input signature), their memory pool,
        # and the captures made per kind (JAX's trace count)
        self._steps: Dict[tuple, CompiledStep] = {}
        self._pool = None
        self.captures = dict.fromkeys(("train", "eval", "predict"), 0)
        # tile data parallelism: the replicas, each shard's memory pool,
        # the similarity tables by device, the model's flat gradient and
        # the optimizer step (made at first use)
        self._replicas: Optional[Replicas] = None
        self._shard_pools: List = []
        self._sims: Dict[torch.device, tuple] = {}
        self._grad_flat: Optional[torch.Tensor] = None
        self._adam: Optional[CapturedCall] = None

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
                torch.from_numpy(np.array(self.graph.gene_embedding,
                                          np.float32)))
        self.model = model.to(self.device)
        self.initialized = True
        self._make_optimizer()
        self._drop_steps()

    def load_params(self, params) -> None:
        """Load a flax-layout parameter tree (nested dict of arrays, as
        ``segger_tpu`` trains and ``train/checkpoint.load_checkpoint``
        reads); every parameter must be present, and nothing else."""
        self.model.load_state_dict(params_from_flax(params), strict=True)
        self.model.to(self.device)
        self.initialized = True
        if self.optimizer is None:
            self._make_optimizer()
        self._drop_steps()

    def _make_optimizer(self) -> None:
        """``optax.adam(lr)`` as ``torch.optim.Adam``; with
        ``update_gene_embedding=False`` the gene embedding is frozen (left
        out, as ``optax.masked`` leaves it out).  On CUDA it is
        ``capturable``, its step count on the device, so that a captured
        train step replays its update, and ``fused``: one kernel for the
        update of every parameter."""
        params = []
        for name, p in self.model.named_parameters():
            frozen = (not self.cfg.update_gene_embedding
                      and name.startswith("gene_embedding."))
            p.requires_grad_(not frozen)
            if not frozen:
                params.append(p)
        cuda = self.device.type == "cuda"
        self.optimizer = torch.optim.Adam(
            params, lr=self.cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            capturable=cuda, fused=cuda or None)

    @property
    def tile_dp(self) -> bool:
        """``fit`` and ``predict`` shard their batches over the mesh."""
        return self.mesh is not None and self.mesh.size > 1

    def _drop_steps(self) -> None:
        """Forget the compiled steps and the replicas: they hold the
        addresses of the parameters and the optimizer state they were
        captured with."""
        self._steps = {}
        self._pool = None
        self._replicas = None
        self._shard_pools = []
        self._grad_flat = None
        self._adam = None

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
        with substage("plan.tile_bucket", items=len(tiles)):
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
            with substage("extract.tile"):
                return extract_tile(self.graph, spec, bucket)
        key = (id(spec), dataclasses.astuple(bucket))
        hit = self._tile_cache.get(key)
        if hit is not None:
            count("tile_cache.hit")
            return hit[1]
        count("tile_cache.miss")
        with substage("extract.tile"):
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

    def _tile_stats(self, model, sims, batch: TileGraph, seeds, randoms):
        """The ``(sum, count)`` loss statistics of a device batch, summed
        over its tiles: each tile's forward through ``model`` (dropout on
        when ``seeds`` yields its launches' words), then its statistics
        from ``randoms(b, tile)`` against the similarity tables ``sims``."""
        stats = []
        for b in range(batch.tx_gene.shape[0]):
            tile = batch.map_arrays(lambda a: a[b])
            emb = model(tile, deterministic=seeds is None, seeds=seeds)
            stats.append(L.loss_stats(
                randoms(b, tile), emb, tile, *sims,
                tx_margin=self.cfg.tx_margin, sg_margin=self.cfg.sg_margin,
                sg_loss_type=self.cfg.sg_loss_type, use_interior=True,
            ))
        return torch.stack(stats).sum(dim=0)

    def _joint_loss(self, batch: TileGraph, seeds, randoms, w):
        """The step loss over a device batch and its three parts: the
        per-tile ``(sum, count)`` statistics are summed before the masked
        means, as the JAX package's joint means, and weighted by ``w``."""
        return _combine(self._tile_stats(
            self.model, (self.tx_similarity, self.bd_similarity), batch,
            seeds, randoms), w)

    def _loss(self, batch: TileGraph, gen: torch.Generator,
              weights: np.ndarray, deterministic: bool):
        """The eager step loss: each tile draws its dropout seeds
        (forward) and its loss randoms from ``gen``, in that order."""
        return self._joint_loss(
            batch, None if deterministic else torch_seed_source(gen),
            lambda b, tile: L.draw_loss_randoms(tile, gen),
            torch.from_numpy(weights).to(self.device))

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

    # ------------------------------------------------------------------
    # compiled steps: bodies that read only their StepInputs
    def _stats_from(self, inp: StepInputs, train: bool, model, sims):
        """:meth:`_tile_stats` on the step inputs."""
        seeds = BufferSeedSource(inp.seeds) if train else None
        stats = self._tile_stats(
            model, sims, inp.batch, seeds,
            lambda b, tile: L.loss_randoms(tile, inp.tx_u[b], inp.bd_u[b],
                                           inp.sg_u[b]))
        if seeds is not None and seeds.used != inp.seeds.shape[0]:
            raise RuntimeError(f"the step used {seeds.used} of its "
                               f"{inp.seeds.shape[0]} seed pairs")
        return stats

    def _loss_from(self, inp: StepInputs, train: bool):
        return _combine(self._stats_from(
            inp, train, self.model, (self.tx_similarity, self.bd_similarity)),
            inp.weights)

    def _train_body(self, inp: StepInputs) -> torch.Tensor:
        """:meth:`train_step` on the step inputs: the loss row
        ``[loss, loss_tx, loss_bd, loss_sg]`` after one Adam step."""
        loss, parts = self._loss_from(inp, train=True)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return torch.cat([loss[None], parts]).detach()

    def _eval_body(self, inp: StepInputs) -> torch.Tensor:
        """:meth:`eval_step` on the step inputs."""
        with torch.no_grad():
            loss, parts = self._loss_from(inp, train=False)
        return torch.cat([loss[None], parts])

    def _predict_body(self, inp: StepInputs, model=None) -> torch.Tensor:
        """Per tile, ``(tx_index, cell_encoding, similarity, gene,
        interior mask)`` over every row, as the JAX package's
        ``predict_step`` returns them, in one ``(B, 5, n_tx)`` int32
        tensor (the similarity's float32 bits) for one copy back; through
        ``model`` (the trainer's by default)."""
        model = self.model if model is None else model
        rows = []
        with torch.no_grad():
            for b in range(inp.batch.tx_gene.shape[0]):
                tile = inp.batch.map_arrays(lambda a: a[b])
                emb = model(tile)
                max_sim, seg = score_candidates(
                    emb["tx"], emb["bd"], tile.cand, tile.bd_index,
                    dtype=self.dtype,
                    normalized=self.cfg.normalize_embeddings,
                )
                rows.append(torch.stack([
                    tile.tx_index, seg, max_sim.view(torch.int32),
                    tile.tx_gene,
                    (tile.tx_interior & tile.tx_valid).to(torch.int32)]))
        return torch.stack(rows)

    def _train_state(self) -> Callable[[], None]:
        """Copy the parameters and the optimizer state; the function
        returned writes them back in place (state the optimizer did not
        have yet as zeros, which is how Adam starts it)."""
        params = [p.detach().clone() for p in self.model.parameters()]
        saved = {p: {k: v.clone() for k, v in st.items()
                     if torch.is_tensor(v)}
                 for p, st in self.optimizer.state.items()}

        def restore():
            with torch.no_grad():
                for p, c in zip(self.model.parameters(), params):
                    p.copy_(c)
                for p, st in self.optimizer.state.items():
                    for k, v in st.items():
                        if torch.is_tensor(v):
                            if p in saved:
                                v.copy_(saved[p][k])
                            else:
                                v.zero_()
        return restore

    def _step(self, kind: str, batch: TileGraph) -> CompiledStep:
        """The compiled step of ``kind`` ("train", "eval" or "predict")
        for a NumPy batch's signature, made at its first use."""
        key = (kind, signature(batch))
        step = self._steps.get(key)
        if step is not None:
            return step
        n_seeds = (self.model.seed_launches(batch) * batch.tx_gene.shape[0]
                   if kind == "train" else 0)
        cuda = self.device.type == "cuda"
        if cuda and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

        def inputs(device, pin=False):
            return StepInputs.like(batch, n_seeds, device,
                                   losses=kind != "predict", pin=pin)

        step = CompiledStep(
            {"train": self._train_body, "eval": self._eval_body,
             "predict": self._predict_body}[kind],
            inputs(self.device), self._pool,
            snapshot=self._train_state if kind == "train" else None,
            staging=[inputs("cpu", pin=True) for _ in range(2)]
            if cuda else None)
        self._steps[key] = step
        return step

    # ------------------------------------------------------------------
    # tile data parallelism: one step per shard on its own device
    def _tile_dp_setup(self) -> None:
        """The replicas (made at first use, after any change of the
        parameters' tensors) with the model's current parameters."""
        if self.mesh.spans_ranks:
            raise ValueError("tile data parallelism runs in one process; "
                             "a mesh that spans ranks serves the "
                             "whole-slide paths")
        if self._replicas is None:
            self._replicas = Replicas(self.model, self.mesh)
            self._shard_pools = [
                torch.cuda.graph_pool_handle() if dev.type == "cuda"
                else None for dev in self.mesh.devices]
        else:
            self._replicas.pull(self.model)

    def _sims_on(self, device: torch.device) -> tuple:
        """The similarity tables on ``device``."""
        if device not in self._sims:
            self._sims[device] = (self.tx_similarity.to(device),
                                  self.bd_similarity.to(device))
        return self._sims[device]

    def _shard_steps(self, kind: str, batch: TileGraph) -> List:
        """Each shard's step of ``kind`` for a NumPy batch: shard ``d``
        runs the ``d``-th equal group of its tiles on ``mesh.devices[d]``
        through its replica, a :class:`~.graphs.SplitStep` for "train"
        and a :class:`~.graphs.CompiledStep` otherwise, made at first
        use with the shard's own inputs, staging and memory pool."""
        n = self.mesh.size
        g = batch.tx_gene.shape[0] // n
        group = batch.map_arrays(lambda a: a[:g])
        sig = signature(group)
        n_seeds = self.model.seed_launches(group) * g if kind == "train" \
            else 0
        reps = self._replicas
        steps = []
        for d, dev in enumerate(self.mesh.devices):
            key = (kind, sig, d)
            step = self._steps.get(key)
            if step is None:
                cuda = dev.type == "cuda"
                model, sims = reps.modules[d], self._sims_on(dev)

                def inputs(device, pin=False):
                    return StepInputs.like(group, n_seeds, device,
                                           losses=kind != "predict", pin=pin)

                staging = [inputs("cpu", pin=True) for _ in range(2)] \
                    if cuda else None
                pool = self._shard_pools[d]
                if kind == "train":
                    step = SplitStep(
                        lambda inp, m=model, s=sims: self._stats_from(
                            inp, True, m, s),
                        inputs(dev), [p for p in model.parameters()
                                      if p.requires_grad],
                        n_stats=6, pool=pool, staging=staging)
                elif kind == "eval":
                    step = CompiledStep(
                        lambda inp, m=model, s=sims: self._eval_stats(
                            inp, m, s), inputs(dev), pool, staging=staging)
                else:
                    step = CompiledStep(
                        lambda inp, m=model: self._predict_body(inp, m),
                        inputs(dev), pool, staging=staging)
                self._steps[key] = step
            steps.append(step)
        return steps

    def _eval_stats(self, inp: StepInputs, model, sims) -> torch.Tensor:
        with torch.no_grad():
            return self._stats_from(inp, False, model, sims)

    def _optimizer_step(self, flat_grads: List[torch.Tensor],
                        used: List[bool]) -> None:
        """The shards' flat gradients (of the trainable parameters that
        ``used`` marks) summed into the model's gradients, then one Adam
        step on the model's device (captured on CUDA, as the one-device
        train step captures it)."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        if self._grad_flat is None:
            n = sum(p.numel() for p, u in zip(params, used) if u)
            self._grad_flat = torch.zeros(n, device=self.device)
            cuda = self.device.type == "cuda"
            if cuda and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._adam = CapturedCall(self.optimizer.step, self.device,
                                      self._pool, snapshot=self._train_state)
        off = 0
        for p, u in zip(params, used):
            # a parameter no shard's statistics reach keeps no gradient,
            # and Adam skips it, as on one device
            if u:
                p.grad = self._grad_flat[off:off + p.numel()].view_as(p)
                off += p.numel()
            else:
                p.grad = None
        reduce_gradients(flat_grads, self._grad_flat)
        self._adam()

    def _tile_dp_row(self, kind: str, batch: TileGraph,
                     gen: Optional[torch.Generator],
                     weights: Optional[np.ndarray]) -> torch.Tensor:
        """One step of ``kind`` over the mesh: every shard's forward, the
        statistics summed on the model's device into the joint means; for
        "train" every shard's backward from the scales ``w_k / max(count_k,
        1)``, the gradients summed, one Adam step and the parameters back
        to the replicas.  Returns the loss row (train, eval) on the
        model's device, or the ``(B, 5, n_tx)`` predict rows on the host
        in global tile order."""
        steps = self._shard_steps(kind, batch)
        self._stage(steps, batch, gen, weights)
        outs = [self._run(kind, s) for s in steps]
        if kind == "predict":
            out = torch.cat([s.fetch(o) for s, o in zip(steps, outs)])
            self.bytes_to_host += out.nbytes
            return out
        tot = torch.stack([o.to(self.device) for o in outs]).sum(dim=0)
        w = torch.from_numpy(weights).to(self.device)
        loss, parts = _combine(tot, w)
        if kind == "train":
            # d loss / d sum_k, as autograd forms it on one device; the
            # counts carry no gradient
            scale = torch.zeros_like(tot)
            scale[0::2] = w / tot[1::2].clamp(min=1.0)
            flats = [s.backward(scale) for s in steps]
            self._optimizer_step(flats, steps[0].used)
            self._replicas.pull(self.model)
        return torch.cat([loss[None], parts])

    def _stage(self, steps, batch: TileGraph,
               gen: Optional[torch.Generator] = None,
               weights: Optional[np.ndarray] = None) -> None:
        """Fill the steps' inputs with a NumPy batch and, for a loss
        step, the random numbers ``gen`` gives in the eager step's order:
        per tile its launches' seed words (train steps), then its loss
        uniforms; then the weights.  ``steps`` is one step, or one per
        shard, shard ``d`` taking the ``d``-th equal group of tiles; the
        draws go tile by tile in global tile order either way."""
        steps = steps if isinstance(steps, list) else [steps]
        inps = [s.staging() for s in steps]
        with substage("stage"):
            g = batch.tx_gene.shape[0] // len(steps)
            for d, inp in enumerate(inps):
                for dst, src in zip(tile_arrays(inp.batch),
                                    tile_arrays(batch)):
                    dst.copy_(torch.from_numpy(src[d * g:(d + 1) * g]))
            if gen is not None:
                with substage("stage.draws"):
                    self._draw(inps, g, batch.tx_gene.shape[0], gen)
                for inp in inps:
                    inp.weights.copy_(torch.from_numpy(weights))
            for s, inp in zip(steps, inps):
                s.upload()
                self.bytes_to_device += sum(t.nbytes for t in inp.tensors())

    @staticmethod
    def _draw(inps: List[StepInputs], g: int, n_tiles: int,
              gen: torch.Generator) -> None:
        """Per tile, in global tile order, its launches' seed words (train
        steps), then its loss uniforms, into the inputs of its shard."""
        per_tile = inps[0].seeds.shape[0] // g
        draw = torch_seed_source(gen)
        words = [[] for _ in inps]
        for b in range(n_tiles):
            d, t = divmod(b, g)
            inp = inps[d]
            words[d] += [seed_int32(draw()) for _ in range(per_tile)]
            for dst, u in zip((inp.tx_u[t], inp.bd_u[t], inp.sg_u[t]),
                              L.draw_loss_uniforms(
                                  inp.tx_u.shape[2], inp.bd_u.shape[2],
                                  inp.sg_u.shape[1], gen)):
                dst.copy_(u)
        for inp, ws in zip(inps, words):
            if ws:
                inp.seeds.copy_(torch.tensor(ws, dtype=torch.int32))

    def _run(self, kind: str, step: CompiledStep) -> torch.Tensor:
        if step.cuda and step.graph is None:
            self.captures[kind] += 1
        return step.run()

    def _loss_row(self, kind: str, batch: TileGraph, gen: torch.Generator,
                  weights: np.ndarray) -> torch.Tensor:
        """One train or eval step on a NumPy batch: its loss row."""
        if self.tile_dp:
            return self._tile_dp_row(kind, batch, gen, weights)
        step = self._step(kind, batch)
        self._stage(step, batch, gen, weights)
        return self._run(kind, step)

    def _loss_pass(self, kind: str, plans, gen: torch.Generator,
                   weights: np.ndarray, cache: bool, depth: int,
                   epoch: Optional[int] = None) -> List[List[float]]:
        """Run the compiled ``kind`` step ("train" or "eval") on every
        plan's batch, reading the loss rows back one step late, so that
        the device runs a step while the host stages the next.  As each
        step is enqueued, its row is queued for a host ring (on CUDA a
        pinned one, the copy ordered after the step on its stream); once
        ``depth`` rows wait behind a newer step, they are read in one
        ``device.wait``, and the rest at the pass's end.  Training steps
        also go into ``step_log``, their seconds from the step's staging
        to its row on the host."""
        rows: List[List[float]] = []
        ring: Optional[torch.Tensor] = None
        done: List[Optional[torch.cuda.Event]] = []
        # (staging start, ring slot) of each row not read yet, oldest first
        sent: List[Tuple[float, int]] = []

        def read_back(n: int) -> None:
            group = sent[:n]
            with substage("device.wait"):
                last = done[group[-1][1]]
                if last is not None:
                    last.synchronize()
                got = ring[[slot for _, slot in group]].tolist()
            now = time.perf_counter()
            for (t0, _), rec in zip(group, got):
                rows.append(rec)
                if epoch is not None:
                    self.step_log.append((epoch, rec, now - t0))
            # every row but the newest step's was read after a later step
            # was enqueued
            lagged = n if len(sent) > n else n - 1
            if lagged:
                count("loss_row.lagged", lagged)
            del sent[:n]

        with PrefetchIterator(
                plans, lambda p: self._build_batch(p, cache)) as batches:
            for i, batch in enumerate(batches):
                t0 = time.perf_counter()
                row = self._loss_row(kind, batch, gen, weights)
                if ring is None:
                    ring = torch.empty((depth + 1, *row.shape),
                                       dtype=row.dtype, pin_memory=row.is_cuda)
                    done = [torch.cuda.Event() if row.is_cuda else None
                            for _ in range(depth + 1)]
                slot = i % (depth + 1)
                # on CUDA the copy follows the step on the row's stream
                ring[slot].copy_(row, non_blocking=True)
                if row.is_cuda:
                    done[slot].record(torch.cuda.current_stream(row.device))
                sent.append((t0, slot))
                if len(sent) > depth:
                    read_back(depth)
        if sent:
            read_back(len(sent))
        return rows

    def iter_batches(self, tiles: Sequence[TileSpec], shuffle: bool,
                     rng: Optional[np.random.Generator] = None,
                     prefetch: int = 2, cache: bool = True,
                     use_xlo: bool = False) -> PrefetchIterator:
        """Stacked NumPy batches of ``tiles``' plans, built ``prefetch``
        ahead on a background thread (the JAX package's
        ``iter_batches``): shuffled bucketed packing from ``rng`` when
        ``shuffle``, with the extra-low degree segment when ``use_xlo``,
        extracted through the tile cache (``cache=False`` inserts
        nothing)."""
        plans = self._batch_plans(tiles, use_xlo=use_xlo, shuffle=shuffle,
                                  rng=rng)
        return PrefetchIterator(plans, lambda p: self._build_batch(p, cache),
                                depth=prefetch)

    def make_batches(self, tiles: Sequence[TileSpec], shuffle: bool,
                     rng: Optional[np.random.Generator] = None,
                     cache: bool = False) -> List[TileGraph]:
        """Every batch of ``tiles``' plans, built now (small runs and
        templates).  The caller holds them, so by default their
        extractions do not go into the tile cache."""
        return [self._build_batch(p, cache) for p in
                self._batch_plans(tiles, shuffle=shuffle, rng=rng)]

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
        record per epoch with the JAX package's keys.  Every step is a
        compiled step (a replayed CUDA graph on CUDA).  A step's loss row
        comes back one step late, after the next step is enqueued, so the
        host stages step n + 1 while the device runs step n; with
        ``scan_steps = S > 0`` the rows come back S at a time.  Each pass
        ends with its rows read, so ``history`` and ``on_epoch_end`` see
        whole epochs; ``step_log``'s seconds run from a step's staging to
        its row on the host.
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
            self._drop_steps()      # the optimizer state is new tensors
            start_epoch = int(meta.get("extra", {}).get("epoch", -1)) + 1
            logger.info("resumed from epoch %d", start_epoch)
        if self.tile_dp:
            self._tile_dp_setup()

        for epoch in range(start_epoch, max_epochs):
            weights = self.weights(epoch, max_epochs)
            erng, gen = self.epoch_streams(epoch)
            # the cache pays only across epochs: the last inserts nothing
            cache = epoch < max_epochs - 1
            plans = self._batch_plans(train_tiles, shuffle=True, rng=erng)
            ep_loss = self._loss_pass("train", plans, gen, weights, cache,
                                      max(cfg.scan_steps, 1), epoch)
            rec = {"epoch": epoch}
            rec.update(_means("train", ep_loss))
            if val_plans:
                vl = self._loss_pass("eval", val_plans, gen, weights, cache,
                                     1)
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
    def _predict_batches(self, predict_tiles: Sequence[TileSpec]):
        """Per batch, the concatenated (row_index, cell_encoding,
        similarity, gene) NumPy arrays of its interior transcripts: the
        compiled predict step returns every row and its mask in one
        tensor, and the host applies the mask."""
        if not self.initialized:
            raise RuntimeError("call init() or load_params() first")
        self.release_tile_cache()
        if self.tile_dp:
            self._tile_dp_setup()
        with self.iter_batches(predict_tiles, shuffle=False, cache=False,
                               use_xlo=True) as batches:
            for batch in batches:
                if self.tile_dp:
                    a = self._tile_dp_row("predict", batch, None,
                                          None).numpy()
                else:
                    step = self._step("predict", batch)
                    self._stage(step, batch)
                    out = step.fetch(self._run("predict", step))
                    self.bytes_to_host += out.nbytes
                    a = out.numpy()
                m = a[:, 4].ravel() != 0
                yield (a[:, 0].ravel()[m], a[:, 1].ravel()[m],
                       a[:, 2].ravel().view(np.float32)[m],
                       a[:, 3].ravel()[m])

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

    # ------------------------------------------------------------------
    def _whole_slide_mesh(self, mesh=None,
                         grid: Optional[Tuple[int, int]] = None):
        """The mesh of a whole-slide call: with ``grid=(dx, dy)`` ``mesh``
        laid out as the grid when it has ``dx * dy`` shards, else a grid
        mesh over every rank's devices after ``initialize_multihost``, or
        every visible card (on the CPU, ``dx * dy`` shards on it); without
        a grid ``mesh``, the trainer's, or the global mesh after
        ``initialize_multihost``, or every visible card (on the CPU, one
        shard)."""
        from ..parallel.mesh import make_grid_mesh, make_mesh, world

        one_cpu = self.device.type == "cpu" and world() is None
        if grid is not None:
            dx, dy = grid
            if mesh is not None and mesh.size == dx * dy:
                return dataclasses.replace(mesh, axis_names=("x", "y"),
                                           dims=(dx, dy))
            return make_grid_mesh(
                dx, dy, [self.device] * (dx * dy) if one_cpu else None)
        mesh = mesh or self.mesh
        if mesh is None:
            mesh = make_mesh(devices=[self.device] if one_cpu else None)
        return mesh

    def predict_whole_slide(self, mesh=None,
                            grid: Optional[Tuple[int, int]] = None
                            ) -> Dict[str, np.ndarray]:
        """Whole-slide prediction by halo exchange: the graph is
        partitioned into strips over the mesh (``parallel/halo.py``), or
        into a ``grid=(dx, dy)`` (``parallel/grid.py``), and boundary
        rows are exchanged before every layer, so the result is exact,
        with no margins and no dedupe.  Flat arrays of (row_index,
        cell_encoding, similarity, gene) for every transcript, the same on
        every rank of a mesh that spans ranks, whose parameters must be
        equal (``parallel.mesh.check_replicated``)."""
        from ..parallel.grid import grid_predict
        from ..parallel.halo import sharded_predict
        from ..parallel.mesh import check_replicated

        if not self.initialized:
            raise RuntimeError("call init() or load_params() first")
        mesh = self._whole_slide_mesh(mesh, grid)
        check_replicated(self.model, mesh)
        if grid is not None:
            return grid_predict(self.model, self.graph, mesh)
        return sharded_predict(self.model, self.graph, mesh)

    def shard_generator(self, epoch: int, shard: int) -> torch.Generator:
        """Shard ``shard``'s generator of dropout seeds and loss draws in
        whole-slide epoch ``epoch``, seeded with ``(seed + 1, epoch,
        shard)``: the counterpart of the JAX package's ``fold_in`` of the
        epoch and the shard's axis index."""
        state = np.random.SeedSequence(
            [self.cfg.seed + 1, epoch, shard]).generate_state(1, np.uint64)
        return torch.Generator().manual_seed(int(state[0]))

    def fit_whole_slide(self, mesh=None, max_epochs: Optional[int] = None,
                        grid: Optional[Tuple[int, int]] = None
                        ) -> List[Dict]:
        """Margin-free whole-slide training over the mesh.

        :meth:`fit` keeps the reference's semantics (margin tiles,
        cross-tile edges dropped); this path shards the slide itself into
        strips (or a ``grid=(dx, dy)``) and trains with exact receptive
        fields: the per-layer halo exchange in the forward, gradients
        back through it, loss statistics summed over shards into exact
        whole-slide masked means (``parallel.halo.make_train_step``).
        One optimizer step per epoch, the whole slide being the batch;
        each shard draws its randomness from :meth:`shard_generator` with
        its global shard id, so that a mesh that spans ranks draws what
        one process draws.  There every rank must start from the same
        parameters (``parallel.mesh.check_replicated`` raises otherwise)
        and ends with the same ones.  Returns the history, with the JAX
        package's keys, which also becomes ``self.history``; ``step_log``
        gets each epoch's row and host seconds."""
        from ..parallel.grid import (
            build_grid_sharded_graph, make_grid_train_step,
        )
        from ..parallel.halo import (
            build_sharded_graph, make_sharded_train_step,
        )
        from ..parallel.mesh import check_replicated, put_sharded

        cfg = self.cfg
        max_epochs = cfg.max_epochs if max_epochs is None else max_epochs
        mesh = self._whole_slide_mesh(mesh, grid)
        if grid is not None:
            stacked, halo, dropped = build_grid_sharded_graph(
                self.graph, *grid, for_training=True)
            make_step = make_grid_train_step
        else:
            stacked, halo, dropped = build_sharded_graph(
                self.graph, mesh.size, for_training=True)
            make_step = make_sharded_train_step
        if dropped.any():
            logger.warning("whole-slide training dropped %s non-adjacent-"
                           "shard edges (tt, sg, cand)", dropped.tolist())
        if not self.initialized:
            self.init()
        check_replicated(self.model, mesh)
        shards, halos = put_sharded(stacked, mesh), put_sharded(halo, mesh)
        step = make_step(self.model, self.optimizer, mesh,
                         self.tx_similarity, self.bd_similarity,
                         tx_margin=cfg.tx_margin, sg_margin=cfg.sg_margin,
                         sg_loss_type=cfg.sg_loss_type)
        history = []
        for epoch in range(max_epochs):
            t0 = time.perf_counter()
            gens = {d: self.shard_generator(epoch, d) for d in mesh.local}
            loss, aux = step(
                shards, halos,
                [torch_seed_source(gens[d]) if d in gens else None
                 for d in range(mesh.size)],
                lambda d, tile: L.draw_loss_randoms(tile, gens[d]),
                self.weights(epoch, max_epochs))
            row = torch.cat([loss[None], aux]).tolist()
            self.step_log.append((epoch, row, time.perf_counter() - t0))
            rec = {"epoch": epoch}
            rec.update(_means("train", [row]))
            history.append(rec)
            logger.info("whole-slide epoch %d: loss=%.4f", epoch, row[0])
        self.history = history
        return history


def _combine(tot: torch.Tensor, w: torch.Tensor):
    """The step loss and its three parts from the summed ``(sum, count)``
    statistics: the masked means, weighted by ``w``."""
    parts = tot[0::2] / tot[1::2].clamp(min=1.0)
    loss = w[0] * parts[0] + w[1] * parts[1] + w[2] * parts[2]
    return loss, parts


def _means(prefix: str, rows: List[List[float]]) -> Dict[str, float]:
    """Epoch means of ``[loss, loss_tx, loss_bd, loss_sg]`` rows."""
    keys = ("loss", "loss_tx", "loss_bd", "loss_sg")
    return {f"{prefix}:{k}": float(np.mean([r[i] for r in rows]))
            for i, k in enumerate(keys)}
