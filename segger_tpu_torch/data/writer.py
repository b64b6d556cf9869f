"""Segmentation output writer: transcript-to-cell assignment table with
per-gene similarity thresholds, parquet + h5ad outputs.

Re-implements the reference's ``ISTSegmentationWriter``
(reference: src/segger/data/writer.py:19-292) on pandas/pyarrow; the
port's copy of ``segger_tpu.data.writer``:

  - concatenate per-batch predictions, map cell encodings to cell ids,
    dedupe transcripts predicted in multiple halo tiles by max similarity
  - per-gene threshold = min(Yen, Li) on each gene's similarity histogram
    (sampled to 10M; Li capped at 250 iterations), median backfill for
    genes that fail to converge
  - ``segger_segmentation.parquet`` and optionally ``segger_anndata.h5ad``
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import pandas as pd

from ..io.fields import TrainingTranscriptFields
from ..utils_profiling import substage
from .features import anndata_from_transcripts
from .threshold import threshold_yen, threshold_li

logger = logging.getLogger(__name__)

_SAMPLE_CAP = 10_000_000  # reference: writer.py:215


@substage("write.thresholds")
def compute_gene_thresholds(
    sim: np.ndarray,
    gene: np.ndarray,
    seed: int = 0,
) -> "tuple[dict, list, float]":
    """Per-gene similarity threshold = min(Yen, Li) with median backfill
    (reference: writer.py:206-253).

    Operates on flat arrays of ASSIGNED transcripts (one pass of
    sort-based grouping — no pandas groupby object churn); shared by the
    DataFrame writer and the dense/streaming writer.

    Returns (thresholds, failed_genes, median_threshold).
    """
    rng = np.random.default_rng(seed)
    thresholds, failed = {}, []
    if sim.size:
        order = np.argsort(gene, kind="stable")
        sg = gene[order]
        bounds = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1], True])
        for s, e in zip(bounds[:-1], bounds[1:]):
            g = int(sg[s])
            arr = sim[order[s:e]]
            if arr.size > _SAMPLE_CAP:
                arr = rng.choice(arr, _SAMPLE_CAP, replace=False)
            try:
                tye = threshold_yen(arr)
                tli = threshold_li(arr, max_iter=250)
                thresholds[g] = min(tye, tli)
            except StopIteration:
                failed.append(g)
    global_thr = (
        float(np.quantile(list(thresholds.values()), 0.5))
        if thresholds
        else 0.0
    )
    for g in failed:
        thresholds[g] = global_thr
    return thresholds, failed, global_thr


@substage("write.assign")
def assign_dense(
    best_sim: np.ndarray,
    best_enc: np.ndarray,
    gene_by_row: np.ndarray,
    cell_ids: np.ndarray,
    gene_names: Optional[np.ndarray] = None,
    seed: int = 0,
) -> pd.DataFrame:
    """Dense-array variant of :func:`assign_transcripts_to_cells` for the
    streaming predict path (``SeggerTrainer.predict_streaming``).

    ``best_sim``/``best_enc`` are row_index-ADDRESSED arrays (the
    streamed max-merge already performed the reference's cross-tile
    dedupe, writer.py:199-204): ``best_enc[r] == -2`` marks rows never
    predicted; ``-1`` marks predicted-but-unassigned.  ``gene_by_row``
    maps row_index -> gene code.  The returned frame uses CATEGORICAL
    cell ids (dictionary-encoded in parquet) instead of object strings —
    at 10^8 transcripts the object column alone costs ~60 B/row.
    """
    tx_f = TrainingTranscriptFields()
    rows = np.flatnonzero(best_enc != -2)
    sim = best_sim[rows]
    enc = best_enc[rows]
    gene = gene_by_row[rows].astype(np.int32)

    assigned = enc >= 0
    thresholds, failed, global_thr = compute_gene_thresholds(
        sim[assigned].astype(np.float64), gene[assigned], seed
    )

    # sorted-key lookup (gene codes may include -1 = unknown gene, so a
    # dense table indexed by code would wrap)
    failed_set = set(failed)
    keys = np.array(sorted(thresholds), np.int64)
    vals = np.array([thresholds[k] for k in keys], np.float64)
    conv = np.array([k not in failed_set for k in keys], bool)
    if keys.size:
        pos = np.clip(np.searchsorted(keys, gene), 0, keys.size - 1)
        matched = keys[pos] == gene
        thr_col = np.where(matched, vals[pos], global_thr)
        conv_col = matched & conv[pos]
    else:
        thr_col = np.full(gene.size, global_thr)
        conv_col = np.zeros(gene.size, bool)

    df = pd.DataFrame(
        {
            tx_f.row_index: rows.astype(np.int64),
            "segger_similarity": sim.astype(np.float64),
            tx_f.feature: gene.astype(np.int64),
            "segger_cell_id": pd.Categorical.from_codes(
                np.where(assigned, enc, -1).astype(np.int64),
                categories=pd.Index(np.asarray(cell_ids)),
            ),
            "similarity_threshold": thr_col,
            "converged": conv_col,
        }
    )
    if gene_names is not None:
        df["segger_gene"] = pd.Categorical.from_codes(
            gene.astype(np.int64),
            categories=pd.Index(np.asarray(gene_names)),
        )
    return df


@substage("write.assign")
def assign_transcripts_to_cells(
    predictions: Dict[str, np.ndarray],
    cell_ids: np.ndarray,
    gene_names: Optional[np.ndarray] = None,
    seed: int = 0,
) -> pd.DataFrame:
    """Build the segmentation table (reference: writer.py:131-265).

    Parameters
    ----------
    predictions : dict with flat arrays ``row_index``, ``cell_encoding``,
        ``similarity``, ``gene`` (as returned by ``SeggerTrainer.predict``).
    cell_ids : (n_cells,) str — cell id per cell encoding.
    gene_names : optional (n_genes,) str for the output table.
    """
    tx_f = TrainingTranscriptFields()
    # dedupe cross-tile duplicates by max similarity (writer.py:199-204)
    # — NumPy-first: a pandas multi-key sort of the pre-dedupe table
    # makes several whole-table copies (GBs of churn at 50M+
    # transcripts, docs/runs/xenium_50m_outofcore.json); one lexsort +
    # boolean first-per-group never materializes the duplicated frame
    ri = np.asarray(predictions["row_index"], np.int64)
    sim = np.asarray(predictions["similarity"], np.float64)
    order = np.lexsort((-sim, ri))          # row asc, similarity desc
    first = np.empty(order.size, bool)
    if order.size:
        first[0] = True
        first[1:] = ri[order[1:]] != ri[order[:-1]]
    sel = order[first]
    enc = np.asarray(predictions["cell_encoding"], np.int64)[sel]
    df = pd.DataFrame(
        {
            tx_f.row_index: ri[sel],
            "segger_similarity": sim[sel],
            tx_f.feature: np.asarray(
                predictions["gene"], np.int64
            )[sel],
        }
    )

    # map encodings to ids; -1 (unassigned) -> null
    assigned = enc >= 0
    cell_id_col = np.full(len(df), None, dtype=object)
    cell_id_col[assigned] = np.asarray(cell_ids)[enc[assigned]]
    df["segger_cell_id"] = cell_id_col

    # per-gene thresholds (writer.py:206-253); median backfill inside
    sel = df[df["segger_cell_id"].notna()]
    thresholds, failed, global_thr = compute_gene_thresholds(
        sel["segger_similarity"].to_numpy(np.float64),
        sel[tx_f.feature].to_numpy(np.int64),
        seed,
    )

    thr = df[tx_f.feature].map(thresholds)
    df["similarity_threshold"] = thr.fillna(global_thr)
    # converged marks a genuinely fitted per-gene threshold: genes that
    # never entered the fit (zero assigned transcripts -> median
    # backfill via fillna) are NOT converged, same as Li failures
    df["converged"] = (
        df[tx_f.feature].isin(thresholds) & ~df[tx_f.feature].isin(failed)
    )
    if gene_names is not None:
        df["segger_gene"] = np.asarray(gene_names)[
            df[tx_f.feature].to_numpy()
        ]
    return df.reset_index(drop=True)


class SegmentationWriter:
    """End-of-prediction writer (reference: writer.py:19-129)."""

    def __init__(
        self,
        output_directory,
        save_anndata: bool = True,
        debug: bool = False,
    ):
        self.output_directory = Path(output_directory)
        self.output_directory.mkdir(parents=True, exist_ok=True)
        self.save_anndata = save_anndata
        self.debug = debug
        if debug:
            (self.output_directory / "debug").mkdir(exist_ok=True)

    def write(
        self,
        predictions: Dict[str, np.ndarray],
        cell_ids: np.ndarray,
        gene_names: np.ndarray,
        transcripts: Optional[pd.DataFrame] = None,
    ) -> pd.DataFrame:
        if self.debug:
            import pickle

            with open(
                self.output_directory / "debug" / "predictions.pkl", "wb"
            ) as f:
                pickle.dump(predictions, f)

        seg = assign_transcripts_to_cells(
            predictions, cell_ids, gene_names
        )
        with substage("write.parquet"):
            out = seg.drop(columns=[TrainingTranscriptFields().feature])
            out.to_parquet(
                self.output_directory / "segger_segmentation.parquet"
            )
        if self.save_anndata and transcripts is not None:
            self.write_anndata(seg, transcripts)
        return seg

    def write_dense(
        self,
        best_sim: np.ndarray,
        best_enc: np.ndarray,
        gene_by_row: np.ndarray,
        cell_ids: np.ndarray,
        gene_names: Optional[np.ndarray] = None,
    ) -> pd.DataFrame:
        """Streaming-path writer: dense row_index-addressed predictions
        (from ``SeggerTrainer.predict_streaming``) -> segmentation
        parquet.  No object columns are ever built — cell ids stay
        dictionary-encoded from allocation to parquet."""
        seg = assign_dense(
            best_sim, best_enc, gene_by_row, cell_ids, gene_names
        )
        with substage("write.parquet"):
            out = seg.drop(columns=[TrainingTranscriptFields().feature])
            out.to_parquet(
                self.output_directory / "segger_segmentation.parquet"
            )
        return seg

    def write_anndata(self, seg: pd.DataFrame, transcripts: pd.DataFrame):
        """Above-threshold transcripts -> cell x gene h5ad
        (reference: writer.py:86-129)."""
        tx_f = TrainingTranscriptFields()
        kept = seg[
            seg["segger_similarity"] >= seg["similarity_threshold"]
        ]
        merged = kept.merge(
            transcripts[
                [tx_f.row_index, tx_f.x, tx_f.y, tx_f.feature]
            ].rename(columns={tx_f.feature: "segger_gene_name"}),
            on=tx_f.row_index,
            how="left",
        )
        adata = anndata_from_transcripts(
            merged,
            feature_column="segger_gene_name",
            cell_id_column="segger_cell_id",
            score_column="segger_similarity",
            coordinate_columns=[tx_f.x, tx_f.y],
        )
        adata.write_h5ad(self.output_directory / "segger_anndata.h5ad")
