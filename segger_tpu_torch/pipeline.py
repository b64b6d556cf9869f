"""End-to-end segmentation pipeline: the datamodule+trainer orchestration.

The analogue of the reference's ``ISTDataModule`` + Lightning ``Trainer``
wiring (reference: src/segger/data/data_module.py:71-384,
src/segger/cli/segment.py:336-413), and the port's copy of
``segger_tpu.pipeline``: standardize inputs, build features and the
whole-slide graph on the host, tile it, train and predict on the GPU
(``SeggerTrainer``), and write the assignment table.

The transcripts are a standardized DataFrame or, for slides too large
for one (the out-of-core path), a
:class:`~segger_tpu_torch.data.columnar.ColumnarTranscripts` table whose
columns may be disk-backed memmaps.  ``ISTPipeline.run`` trains and
predicts on CUDA unless it is given ``device="cpu"``, and raises when
no CUDA device is present.
``ISTPipeline.walls`` holds each stage's host seconds (features, graph,
tiling, fit, predict, write).
"""
from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Literal, Optional

import numpy as np
import pandas as pd

from .compat.anndata_lite import AnnDataLite
from .data.assemble import (
    HostGraph, build_host_graph, build_host_graph_columnar,
)
from .data.columnar import ColumnarTranscripts, anndata_from_columnar
from .data.features import setup_features, setup_features_from_anndata
from .data.partition import build_tiling, make_fit_tiles, make_predict_tiles
from .data.writer import SegmentationWriter
from .geometry.morphology import polygon_props
from .io.fields import StandardBoundaryFields, StandardTranscriptFields
from .train.trainer import SeggerTrainer, TrainConfig, resolve_device
from .utils_profiling import substage

logger = logging.getLogger(__name__)


@dataclass
class PipelineConfig:
    """Data-side knobs (defaults follow ISTDataModule,
    reference: data_module.py:135-161)."""

    cells_representation_mode: Literal["pca", "morphology"] = "pca"
    cells_embedding_size: int = 128
    cells_min_counts: int = 10
    cells_clusters_n_neighbors: int = 10
    cells_clusters_resolution: float = 2.0
    genes_min_counts: int = 100
    genes_clusters_n_neighbors: int = 5
    genes_clusters_resolution: float = 2.0
    transcripts_graph_max_k: int = 5
    transcripts_graph_max_dist: float = 5.0
    segmentation_graph_mode: Literal["nucleus", "cell"] = "nucleus"
    prediction_graph_mode: Literal["nucleus", "cell", "uniform"] = "cell"
    prediction_graph_max_k: int = 3
    prediction_graph_buffer_ratio: float = 0.05
    tiling_mode: Literal["adaptive", "square"] = "adaptive"
    tiling_nodes_per_tile: int = 50_000
    tiling_side_length: float = 250.0
    tiling_margin_training: float = 20.0
    tiling_margin_prediction: float = 20.0
    gene_corr_reference_path: Optional[Path] = None
    gene_missing_strategy: Literal["error", "remove", "fill"] = "error"
    seed: int = 0


class ISTPipeline:
    """Holds the standardized data + derived graph/tiling and drives
    train/predict/write."""

    def __init__(
        self,
        transcripts,
        boundaries: pd.DataFrame,
        polygons: dict,
        config: Optional[PipelineConfig] = None,
    ):
        """``transcripts``: a standardized DataFrame, or a
        :class:`ColumnarTranscripts` table for out-of-core slides (typed
        arrays or disk-backed memmaps instead of object columns);
        ``polygons``: (cell_id, boundary_type) -> (V, 2) vertex array."""
        if not isinstance(transcripts, (pd.DataFrame, ColumnarTranscripts)):
            raise TypeError(
                "ISTPipeline takes a standardized transcript DataFrame or a "
                f"ColumnarTranscripts table; got {type(transcripts).__name__}")
        self.cfg = PipelineConfig() if config is None else config
        self.tx_f = StandardTranscriptFields()
        self.bd_f = StandardBoundaryFields()
        self.transcripts = transcripts
        self.boundaries = boundaries
        self.polygons = polygons
        self.adata: Optional[AnnDataLite] = None
        self.graph: Optional[HostGraph] = None
        self.tree = None
        self.trainer: Optional[SeggerTrainer] = None
        self.walls: Dict[str, float] = {}

    @contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.walls[name] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def load(self):
        """Feature + graph construction (reference: data_module.py:171-286)."""
        cfg, tx_f, bd_f = self.cfg, self.tx_f, self.bd_f
        tx = self.transcripts
        columnar = isinstance(tx, ColumnarTranscripts)

        # segmentation compartment mask (data_module.py:184-200)
        if cfg.segmentation_graph_mode == "nucleus":
            compartments = [tx_f.nucleus_value]
        elif cfg.segmentation_graph_mode == "cell":
            compartments = [tx_f.nucleus_value, tx_f.cytoplasmic_value]
        else:
            raise ValueError(
                f"Unrecognized segmentation graph mode: "
                f"'{cfg.segmentation_graph_mode}'."
            )
        if columnar:
            seg_mask = np.isin(np.asarray(tx.compartment),
                               np.asarray(compartments, np.int8))
            seg_mask &= np.asarray(tx.cell_code) >= 0
        else:
            seg_mask = np.asarray(
                tx[tx_f.compartment].isin(compartments).to_numpy()
            ).copy()
            seg_mask &= tx[tx_f.cell_id].notna().to_numpy()

        gene_corr_reference = None
        if cfg.gene_corr_reference_path is not None:
            from .compat.anndata_lite import read_h5ad

            gene_corr_reference = read_h5ad(cfg.gene_corr_reference_path)

        morph = None
        if cfg.cells_representation_mode == "morphology":
            items = [
                (cid, poly)
                for (cid, btype), poly in self.polygons.items()
                if btype == bd_f.cell_value
            ]
            morph = polygon_props([p for _, p in items])
            morph.index = [c for c, _ in items]

        logger.info("setup_features on %d masked transcripts",
                    int(seg_mask.sum()))
        feature_kwargs = dict(
            cells_embedding_size=cfg.cells_embedding_size,
            cells_min_counts=cfg.cells_min_counts,
            cells_clusters_n_neighbors=cfg.cells_clusters_n_neighbors,
            cells_clusters_resolution=cfg.cells_clusters_resolution,
            genes_min_counts=cfg.genes_min_counts,
            genes_clusters_n_neighbors=cfg.genes_clusters_n_neighbors,
            genes_clusters_resolution=cfg.genes_clusters_resolution,
            compute_morphology=(
                cfg.cells_representation_mode == "morphology"
            ),
            gene_corr_reference=gene_corr_reference,
            gene_missing_strategy=cfg.gene_missing_strategy,
            morphology_props=morph,
            seed=cfg.seed,
        )
        with self._stage("features"):
            if columnar:
                with substage("features.count_matrix", items=tx.n):
                    ad0 = anndata_from_columnar(tx, mask=seg_mask)
                self.adata = setup_features_from_anndata(
                    ad0, **feature_kwargs)
            else:
                self.adata = setup_features(
                    transcripts=tx[seg_mask],
                    boundaries=self.boundaries,
                    cell_column=tx_f.cell_id,
                    **feature_kwargs,
                )

        # prediction polygons: mode-matching boundary type
        pred_type = (
            bd_f.cell_value
            if cfg.prediction_graph_mode == "cell"
            else bd_f.nucleus_value
        )
        poly_items = [
            (cid, poly)
            for (cid, btype), poly in self.polygons.items()
            if btype == pred_type
        ]

        logger.info("building whole-slide graph")
        graph_kwargs = dict(
            adata=self.adata,
            segmentation_mask=seg_mask,
            cells_embedding_key=(
                "X_pca"
                if cfg.cells_representation_mode == "pca"
                else "X_morphology"
            ),
            transcripts_graph_max_k=cfg.transcripts_graph_max_k,
            transcripts_graph_max_dist=cfg.transcripts_graph_max_dist,
            prediction_graph_mode=cfg.prediction_graph_mode,
            prediction_graph_max_k=cfg.prediction_graph_max_k,
            prediction_graph_buffer_ratio=cfg.prediction_graph_buffer_ratio,
            polygons=[p for _, p in poly_items] or None,
            polygon_cell_ids=np.array([c for c, _ in poly_items])
            if poly_items
            else None,
        )
        with self._stage("graph"):
            if columnar:
                self.graph = build_host_graph_columnar(tx, **graph_kwargs)
            else:
                self.graph = build_host_graph(transcripts=tx,
                                              **graph_kwargs)

        logger.info("tiling (%s, %d nodes/tile)", cfg.tiling_mode,
                    cfg.tiling_nodes_per_tile)
        with self._stage("tiling"):
            self.tree = build_tiling(
                self.graph,
                nodes_per_tile=cfg.tiling_nodes_per_tile,
                mode=cfg.tiling_mode,
                side_length=cfg.tiling_side_length,
            )
        return self

    # ------------------------------------------------------------------
    def run(
        self,
        output_directory,
        train_config: Optional[TrainConfig] = None,
        save_anndata: bool = True,
        debug: bool = False,
        device=None,
    ) -> pd.DataFrame:
        """fit + predict + write (reference: cli/segment.py:336-413).
        ``device=None`` trains and predicts on CUDA and raises without
        it, before any host work; ``device="cpu"`` runs the plain
        versions of the kernels."""
        resolve_device(device)
        if train_config is None:
            train_config = TrainConfig()
        if self.graph is None:
            self.load()
        trainer = SeggerTrainer(self.graph, train_config, device=device)
        self.trainer = trainer
        with self._stage("fit"):
            trainer.fit(make_fit_tiles(
                self.graph, self.tree,
                margin=self.cfg.tiling_margin_training,
            ))
        with self._stage("predict"):
            predictions = trainer.predict(make_predict_tiles(
                self.graph, self.tree,
                margin=self.cfg.tiling_margin_prediction,
            ))
        with self._stage("write"):
            writer = SegmentationWriter(
                output_directory, save_anndata=save_anndata, debug=debug
            )
            seg = writer.write(
                predictions,
                cell_ids=self.graph.bd_cell_id,
                gene_names=self.adata.var.index.to_numpy().astype(str),
                # the h5ad export reads a DataFrame; a columnar run skips
                # it (the assignment table is written either way)
                transcripts=(
                    self.transcripts
                    if isinstance(self.transcripts, pd.DataFrame) else None
                ),
            )
        return seg
