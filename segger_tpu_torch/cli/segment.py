"""`segger-tpu-torch segment`: the main train + predict entry point.

Options are scraped from the PipelineConfig / TrainConfig dataclass
sources by the AST registry — defaults and help text live on the
classes, never duplicated here (reference: cli/segment.py:14-22,63-313).
The port's copy of ``segger_tpu.cli.segment``, with the same options
and ``--device``: training and prediction run on CUDA unless
``--device cpu`` is given, and the command raises without a card.
``--low-memory`` streams the transcripts into a disk-spooled columnar
table (``OUT/transcripts_spool``) and predicts through the streaming
max-merge; ``--graph-cache DIR`` loads the memmapped graph plane
(``DIR/plane``, ``DIR/gene_names.npy``) when it is there, skipping the
read and the build, and writes it after the build when it is not, in
the JAX package's layout, so a cache crosses between the packages.
With ``--prepare-only`` the command stops after the graph and touches
no CUDA.  ``--distributed-train`` and ``--distributed-predict`` train and
predict on the whole slide, sharded into strips over ``--devices N``
cards (every visible one by default; with ``--device cpu``, N shards on
the CPU) or into a ``--grid DXxDY`` of DX·DY devices, with a per-layer
halo exchange (``parallel/``).  ``--devices N`` above 1 (its default, 0,
means every visible card) also makes the trainer tile data parallel over
N devices (``SeggerTrainer(mesh=)``, with ``--device cpu`` N shards on
the CPU), as in the JAX package: the tiled fit and predict shard each
batch's tiles over them.  More devices than are visible raise before any
file is read.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parents[1]

_PIPELINE_NAMES = [
    "cells_representation_mode",
    "cells_embedding_size",
    "cells_min_counts",
    "cells_clusters_n_neighbors",
    "cells_clusters_resolution",
    "genes_min_counts",
    "genes_clusters_n_neighbors",
    "genes_clusters_resolution",
    "transcripts_graph_max_k",
    "transcripts_graph_max_dist",
    "segmentation_graph_mode",
    "prediction_graph_mode",
    "prediction_graph_max_k",
    "prediction_graph_buffer_ratio",
    "tiling_mode",
    "tiling_nodes_per_tile",
    "tiling_side_length",
    "tiling_margin_training",
    "tiling_margin_prediction",
    "gene_corr_reference_path",
    "gene_missing_strategy",
    "seed",
]
_TRAIN_NAMES = [
    "in_channels",
    "hidden_channels",
    "out_channels",
    "n_mid_layers",
    "n_heads",
    "learning_rate",
    "sg_loss_type",
    "tx_margin",
    "sg_margin",
    "tx_weight_start",
    "tx_weight_end",
    "bd_weight_start",
    "bd_weight_end",
    "sg_weight_start",
    "sg_weight_end",
    "update_gene_embedding",
    "use_positional_embeddings",
    "normalize_embeddings",
    "compute_dtype",
    "max_epochs",
    "edges_per_batch",
    "training_fraction",
    "tiles_per_step",
    "shape_merge",
    "seed",
    "checkpoint_every",
    "checkpoint_dir",
    "scan_steps",
    "tile_cache_gb",
]


def _registry():
    from .registry import ParameterRegistry

    reg = ParameterRegistry()
    reg.register_from_file(_PKG / "pipeline.py", "PipelineConfig")
    reg.register_from_file(_PKG / "train" / "trainer.py", "TrainConfig")
    return reg


def add_segment_parser(sub):
    p = sub.add_parser(
        "segment", help="Train the model and segment transcripts"
    )
    p.add_argument("-i", "--input-directory", required=True,
                   help="Standardized (or raw platform) dataset directory")
    p.add_argument("-o", "--output-directory", required=True)
    p.add_argument("--platform", default=None)
    p.add_argument("--nucleus-strategy", default="vendor",
                   choices=["vendor", "intersect"],
                   help="Xenium nucleus geometry: vendor rings as "
                        "shipped (the reference's live behavior) or "
                        "clipped to their cell ring (the reference's "
                        "disabled cell-intersection intent)")
    p.add_argument("--no-anndata", action="store_true",
                   help="Skip segger_anndata.h5ad output")
    p.add_argument("--debug", action="store_true",
                   help="Dump params.json and debug artifacts")
    p.add_argument("--devices", type=int, default=0,
                   help="Shard tile batches over this many devices "
                        "(0 = all available)")
    p.add_argument("--distributed-predict", action="store_true",
                   help="Predict via halo-exchange whole-slide sharding "
                        "over the mesh instead of halo tiles (exact; "
                        "no margins or dedupe)")
    p.add_argument("--distributed-train", action="store_true",
                   help="Train margin-free on the whole strip-sharded "
                        "slide (per-layer halo exchange, exact "
                        "receptive fields) instead of margin tiles")
    p.add_argument("--grid", default=None, metavar="DXxDY",
                   help="Use a 2-D grid decomposition (e.g. 4x2) for "
                        "the distributed train/predict paths instead "
                        "of 1-D strips — for slides large in both axes")
    p.add_argument("--low-memory", action="store_true",
                   help="Stream transcripts into a disk-spooled "
                        "columnar table instead of a whole-slide "
                        "DataFrame, predict via the streaming "
                        "max-merge path, and write with categorical "
                        "cell ids (bounded host RSS for 50M+ "
                        "transcript slides; skips the h5ad export)")
    p.add_argument("--graph-cache", default=None, metavar="DIR",
                   help="Cache the whole-slide graph as a memmappable "
                        "plane in DIR: when present it is loaded "
                        "(memmapped, skipping the host build — edge "
                        "arrays page from disk); otherwise it is "
                        "written after the build.  Enables phased "
                        "prepare-on-CPU / run-on-accelerator workflows")
    p.add_argument("--prepare-only", action="store_true",
                   help="Build features + graph (+ --graph-cache) and "
                        "exit before touching any accelerator")
    add_device_argument(p)
    _registry().add_arguments(p)
    p.set_defaults(func=run_segment)
    return p


def add_device_argument(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Train and predict on the GPU (cuda), or run the "
                        "kernels' plain PyTorch versions on the CPU")


def _meshes(args):
    """``(tile_mesh, whole_slide_mesh)``: the trainer's mesh of
    ``--devices`` N devices for tile data parallelism (None for one
    device), and the whole-slide mesh of ``--distributed-*`` (None
    without them), as the JAX package builds them.  Raises, before any
    file is read, for more cards than are visible."""
    import torch

    from ..parallel.mesh import make_grid_mesh, make_mesh
    from ..train.trainer import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    # --devices 0 means every device, as in the JAX package
    n_dev = args.devices or (torch.cuda.device_count() if cuda else 1)
    tile_mesh = make_mesh(n_dev, None if cuda else [device] * n_dev) \
        if n_dev > 1 else None
    if not (args.distributed_train or args.distributed_predict):
        return tile_mesh, None
    if args.grid:
        dx, dy = (int(v) for v in args.grid.lower().split("x"))
        return tile_mesh, make_grid_mesh(
            dx, dy, None if cuda else [device] * (dx * dy))
    return tile_mesh, tile_mesh or make_mesh(
        n_dev, None if cuda else [device] * n_dev)


def run_segment(args) -> int:
    """Read the input (or load the cached graph plane), build features,
    graph and tiles, fit, predict and write.  ``run_segment.last_run``
    keeps the walls of the last call by stage (read, features + graph,
    save-graph, or load-graph in their place; fit, predict, write), its
    pipeline (None when the graph came from the cache), its graph and its
    trainer."""
    tile_mesh, mesh = (None, None) if args.prepare_only else _meshes(args)

    import numpy as np

    from ..data.partition import (
        build_tiling, make_fit_tiles, make_predict_tiles,
    )
    from ..data.writer import SegmentationWriter
    from ..pipeline import ISTPipeline, PipelineConfig
    from ..train.trainer import SeggerTrainer, TrainConfig

    reg = _registry()
    pipe_kwargs = reg.collect(args, _PIPELINE_NAMES)
    train_kwargs = reg.collect(args, _TRAIN_NAMES)
    out_dir = Path(args.output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.debug:
        with open(out_dir / "params.json", "w") as f:
            json.dump({**pipe_kwargs, **train_kwargs}, f, indent=2,
                      default=str)

    walls = {}
    cfg = PipelineConfig(**pipe_kwargs)
    cache = Path(args.graph_cache) if args.graph_cache else None
    pipeline = None
    t0 = time.perf_counter()
    if cache is not None and (cache / "plane" / "tx_gene.npy").exists():
        # a phased run: the cached plane is memmapped (edge arrays and
        # tile indexes page from disk), nothing is read or built
        from ..data.assemble import load_host_graph_plane

        graph = load_host_graph_plane(cache / "plane")
        gene_names = np.load(cache / "gene_names.npy", allow_pickle=False)
        tree = build_tiling(
            graph, nodes_per_tile=cfg.tiling_nodes_per_tile,
            mode=cfg.tiling_mode, side_length=cfg.tiling_side_length,
        )
        walls["load-graph"] = time.perf_counter() - t0
    else:
        from ..io import get_preprocessor

        pp_kwargs = (
            {"nucleus_strategy": args.nucleus_strategy}
            if args.nucleus_strategy != "vendor" else {}
        )
        pp = get_preprocessor(
            args.input_directory, platform=args.platform, **pp_kwargs
        )
        bd, polys = pp.boundaries
        if args.low_memory:
            from ..data.columnar import ColumnarTranscripts

            tx = ColumnarTranscripts.from_chunks(
                pp.iter_transcripts(), spool=out_dir / "transcripts_spool")
        else:
            tx = pp.transcripts
        walls["read"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pipeline = ISTPipeline(tx, bd, polys, cfg)
        pipeline.load()
        graph, tree = pipeline.graph, pipeline.tree
        gene_names = pipeline.adata.var.index.to_numpy().astype(str)
        walls["features + graph"] = time.perf_counter() - t0
        if cache is not None:
            from ..data.assemble import save_host_graph_plane

            t0 = time.perf_counter()
            cache.mkdir(parents=True, exist_ok=True)
            save_host_graph_plane(graph, cache / "plane")
            np.save(cache / "gene_names.npy", gene_names)
            walls["save-graph"] = time.perf_counter() - t0
    run_segment.last_run = {"walls": walls, "pipeline": pipeline,
                            "graph": graph, "trainer": None}
    if args.prepare_only:
        print("Graph prepared"
              + (f"; cached to {cache}" if cache is not None else ""))
        return 0

    trainer = SeggerTrainer(
        graph, TrainConfig(**train_kwargs), device=args.device,
        mesh=tile_mesh,
    )
    run_segment.last_run["trainer"] = trainer
    grid = mesh.dims if mesh is not None and args.grid else None
    t0 = time.perf_counter()
    if args.distributed_train:
        trainer.fit_whole_slide(mesh, grid=grid)
    else:
        fit_tiles = make_fit_tiles(
            graph, tree, margin=cfg.tiling_margin_training,
        )
        trainer.fit(fit_tiles)
    walls["fit"] = time.perf_counter() - t0

    if args.debug:
        # debug artifacts for stage-isolated re-runs
        # (reference: writer.py:280-292)
        from ..train.checkpoint import save_checkpoint

        debug_dir = out_dir / "debug"
        debug_dir.mkdir(exist_ok=True)
        save_checkpoint(
            debug_dir / "checkpoint.npz",
            trainer.model,
            trainer.optimizer,
            config={**pipe_kwargs, **train_kwargs},
        )
        if pipeline is not None:
            pipeline.adata.write_h5ad(debug_dir / "adata_debug.h5ad")

    writer = SegmentationWriter(
        out_dir, save_anndata=not args.no_anndata, debug=args.debug
    )
    t0 = time.perf_counter()
    if args.low_memory and not args.distributed_predict:
        predict_tiles = make_predict_tiles(
            graph, tree, margin=cfg.tiling_margin_prediction,
        )
        # the streaming path: an online max-merge into dense row-addressed
        # arrays (O(n_rows) host memory), categorical cell ids throughout
        best_sim, best_enc = trainer.predict_streaming(predict_tiles)
        walls["predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gene_by_row = np.zeros(best_sim.size, np.int32)
        gene_by_row[graph.tx_index] = graph.tx_gene
        writer.write_dense(
            best_sim, best_enc, gene_by_row,
            cell_ids=graph.bd_cell_id, gene_names=gene_names,
        )
    else:
        if args.distributed_predict:
            predictions = trainer.predict_whole_slide(mesh, grid=grid)
        else:
            predictions = trainer.predict(make_predict_tiles(
                graph, tree, margin=cfg.tiling_margin_prediction,
            ))
        walls["predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        writer.write(
            predictions,
            cell_ids=graph.bd_cell_id,
            gene_names=gene_names,
            # the h5ad export reads a DataFrame: --low-memory and
            # plane-cached runs skip it (the parquet is written either way)
            transcripts=(pipeline.transcripts if pipeline is not None
                         and not args.low_memory else None),
        )
    walls["write"] = time.perf_counter() - t0
    # training history as CSV (CSVLogger analogue, cli/segment.py:394)
    if trainer.history:
        import pandas as pd

        pd.DataFrame(trainer.history).to_csv(
            out_dir / "metrics.csv", index=False
        )
    logger.info("segment walls (s): %s", walls)
    print(f"Segmentation written to {out_dir}")
    return 0


run_segment.last_run = None
