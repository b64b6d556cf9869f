"""Whole-slide heterogeneous graph container (host side).

:class:`HostGraph` holds two node sets and three edge sets as NumPy
arrays; tiling slices it.  Its builder from vendor tables waits for a
later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class HostGraph:
    """Whole-slide graph: two node sets + three edge sets, NumPy SoA."""

    # transcripts (graph order)
    tx_gene: np.ndarray        # (N,) int32 gene encoding (-1: unknown gene)
    tx_pos: np.ndarray         # (N, 2) float32
    tx_cluster: np.ndarray     # (N,) int32 gene cluster (-1 unknown)
    tx_index: np.ndarray       # (N,) int64 row_index
    tx_cell_encoding: np.ndarray  # (N,) int64 vendor cell encoding (-1 none)

    # boundaries (feature-table order == cell_encoding order)
    bd_x: np.ndarray           # (M, F) float32 PCA / morphology embedding
    bd_pos: np.ndarray         # (M, 2) float32 centroids
    bd_cluster: np.ndarray     # (M,) int32 cluster (-1 none)
    bd_index: np.ndarray       # (M,) int64 cell encoding (0..M-1)
    bd_cell_id: np.ndarray     # (M,) str vendor cell id

    # edges (COO)
    tt_src: np.ndarray
    tt_dst: np.ndarray
    sg_src: np.ndarray         # supervision tx -> bd
    sg_dst: np.ndarray
    cand_src: np.ndarray       # prediction candidates tx -> bd
    cand_dst: np.ndarray

    # model-side supplementary data
    gene_embedding: np.ndarray  # (n_genes, F) pretrained gene embedding
    tx_similarity: np.ndarray   # gene cluster similarity (Cg, Cg)
    bd_similarity: np.ndarray   # cell cluster similarity (Cb, Cb)

    @property
    def n_tx(self) -> int:
        return len(self.tx_gene)

    @property
    def n_bd(self) -> int:
        return len(self.bd_index)

    @property
    def n_genes(self) -> int:
        return len(self.gene_embedding)
