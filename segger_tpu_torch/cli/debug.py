"""`segger-tpu-torch debug`: re-run pipeline stages from saved artifacts
(reference: src/segger/cli/debug.py:15-47,
src/segger/debug/segmentation.py, src/segger/debug/prediction.py).

  segment-only — recompute the assignment table from pickled predictions
                 (+ the debug adata for cell ids)
  predict-only — restore model params from a checkpoint and re-run
                 prediction over the dataset, on CUDA unless
                 ``--device cpu`` is given

The port's copy of ``segger_tpu.cli.debug``.  A checkpoint of either
package restores in the other (train/checkpoint.py).
"""
from __future__ import annotations

from pathlib import Path

from .segment import add_device_argument


def add_debug_parser(sub):
    p = sub.add_parser("debug", help="Stage-isolated debug re-runs")
    dsub = p.add_subparsers(dest="debug_command", required=True)

    seg = dsub.add_parser(
        "segment-only",
        help="Re-run transcript assignment from pickled predictions",
    )
    seg.add_argument("-d", "--debug-directory", required=True,
                     help="The <output>/debug directory of a --debug run")
    seg.add_argument("-o", "--output-directory", required=True)
    seg.set_defaults(func=run_segment_only)

    pre = dsub.add_parser(
        "predict-only",
        help="Restore a checkpoint and re-run prediction",
    )
    pre.add_argument("-i", "--input-directory", required=True)
    pre.add_argument("-c", "--checkpoint", required=True)
    pre.add_argument("-o", "--output-directory", required=True)
    pre.add_argument("--platform", default=None)
    add_device_argument(pre)
    pre.set_defaults(func=run_predict_only)
    return p


def run_segment_only(args) -> int:
    import pickle

    from ..compat.anndata_lite import read_h5ad
    from ..data.writer import SegmentationWriter

    debug_dir = Path(args.debug_directory)
    with open(debug_dir / "predictions.pkl", "rb") as f:
        predictions = pickle.load(f)
    ad = read_h5ad(debug_dir / "adata_debug.h5ad")
    cell_ids = ad.obs.index.to_numpy().astype(str)
    gene_names = ad.var.index.to_numpy().astype(str)

    writer = SegmentationWriter(args.output_directory, save_anndata=False)
    writer.write(predictions, cell_ids=cell_ids, gene_names=gene_names)
    print(f"Re-segmented to {args.output_directory}")
    return 0


def run_predict_only(args) -> int:
    from ..io import get_preprocessor
    from ..pipeline import ISTPipeline, PipelineConfig
    from ..train.trainer import SeggerTrainer, TrainConfig, resolve_device
    from ..train.checkpoint import load_checkpoint
    from ..data.partition import make_predict_tiles
    from ..data.writer import SegmentationWriter
    import json

    resolve_device(args.device)
    meta = json.loads(Path(args.checkpoint).with_suffix(".json").read_text())
    cfg_dict = meta.get("config", {})
    pipe_keys = set(PipelineConfig.__dataclass_fields__)
    train_keys = set(TrainConfig.__dataclass_fields__)
    pipe_cfg = PipelineConfig(
        **{k: v for k, v in cfg_dict.items() if k in pipe_keys}
    )
    train_cfg = TrainConfig(
        **{k: v for k, v in cfg_dict.items() if k in train_keys}
    )

    pp = get_preprocessor(args.input_directory, platform=args.platform)
    bd, polys = pp.boundaries
    pipeline = ISTPipeline(pp.transcripts, bd, polys, pipe_cfg)
    pipeline.load()

    # the model is sized from the graph: no template tile is needed
    trainer = SeggerTrainer(pipeline.graph, train_cfg, device=args.device)
    params, _ = load_checkpoint(args.checkpoint, trainer.model)
    trainer.load_params(params)
    tiles = make_predict_tiles(
        pipeline.graph, pipeline.tree,
        margin=pipe_cfg.tiling_margin_prediction,
    )
    predictions = trainer.predict(tiles)
    writer = SegmentationWriter(args.output_directory, save_anndata=False)
    writer.write(
        predictions,
        cell_ids=pipeline.graph.bd_cell_id,
        gene_names=pipeline.adata.var.index.to_numpy().astype(str),
    )
    print(f"Prediction re-run written to {args.output_directory}")
    return 0
