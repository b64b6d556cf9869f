"""Whole-slide heterogeneous graph assembly (host side).

The analogue of the reference's ``setup_heterodata``
(reference: src/segger/data/utils/heterodata.py:18-164): joins
gene/cell encodings + clusters onto transcripts, orders boundaries by
feature-table order, and builds the three edge types as COO arrays in a
NumPy structure-of-arrays :class:`HostGraph`; tiling slices it.
:func:`build_host_graph` takes a standardized DataFrame,
:func:`build_host_graph_columnar` a columnar table (the out-of-core
path).  A graph is saved as one ``.npz`` or as a memmappable plane, one
``.npy`` per field, in the JAX package's layout: a plane written by
either package loads in the other.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import pandas as pd

from ..compat.anndata_lite import AnnDataLite
from ..io.fields import TrainingTranscriptFields
from ..utils_profiling import substage
from .neighbors_host import (
    prediction_graph,
    segmentation_graph,
    transcripts_graph,
)


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


def build_host_graph(
    transcripts: pd.DataFrame,
    adata: AnnDataLite,
    segmentation_mask: np.ndarray,
    cells_embedding_key: str = "X_pca",
    transcripts_graph_max_k: int = 5,
    transcripts_graph_max_dist: float = 5.0,
    prediction_graph_mode: str = "cell",
    prediction_graph_max_k: int = 3,
    prediction_graph_buffer_ratio: float = 0.05,
    polygons: Optional[list] = None,
    polygon_cell_ids: Optional[np.ndarray] = None,
) -> HostGraph:
    """Assemble the whole-slide graph.

    ``polygons`` (+ their cell ids) are required for 'cell'/'nucleus'
    prediction modes; 'uniform' uses centroids only.
    """
    tx_f = TrainingTranscriptFields()

    # gene encoding / cluster join (heterodata.py:50-69); genes filtered
    # out of the feature table map to -1 and are dropped from the graph
    gene_enc = pd.Series(
        adata.var[tx_f.gene_encoding].to_numpy(), index=adata.var.index
    )
    gene_clu = pd.Series(
        np.asarray(adata.var["phenograph_cluster"]), index=adata.var.index
    )
    feats = transcripts[tx_f.feature].astype(str)
    tx_gene = feats.map(gene_enc).fillna(-1).to_numpy(np.int64)
    keep = tx_gene >= 0
    transcripts = transcripts[keep].reset_index(drop=True)
    segmentation_mask = np.asarray(segmentation_mask)[keep]
    tx_gene = tx_gene[keep]
    tx_cluster = (
        feats[keep].map(gene_clu).fillna(-1).to_numpy(np.int64)
    )

    # cell encoding join for masked transcripts (heterodata.py:71-95)
    cell_enc = pd.Series(
        adata.obs[tx_f.cell_encoding].to_numpy(), index=adata.obs.index
    )
    vendor = transcripts[tx_f.cell_id].astype("string")
    joined = vendor.map(cell_enc)
    tx_cell_encoding = np.where(
        segmentation_mask & joined.notna().to_numpy(),
        joined.fillna(-1).to_numpy(np.float64),
        -1,
    ).astype(np.int64)

    tx_pos = transcripts[[tx_f.x, tx_f.y]].to_numpy(np.float32)
    tx_index = transcripts[tx_f.row_index].to_numpy(np.int64)

    # boundary nodes in feature-table (cell_encoding) order
    # (heterodata.py:104-134)
    bd_x = np.asarray(adata.obsm[cells_embedding_key], dtype=np.float32)
    bd_pos = np.asarray(adata.obsm["X_spatial"], dtype=np.float32)
    bd_cluster = np.asarray(
        adata.obs["phenograph_cluster"], dtype=np.int64
    )
    bd_index = adata.obs[tx_f.cell_encoding].to_numpy(np.int64)
    bd_cell_id = adata.obs.index.to_numpy().astype(str)

    # edges
    with substage("graph.tx_knn", items=tx_pos.shape[0]):
        tt_src, tt_dst = transcripts_graph(
            tx_pos, max_k=transcripts_graph_max_k,
            max_dist=transcripts_graph_max_dist,
        )
    sg_src, sg_dst = segmentation_graph(tx_cell_encoding, segmentation_mask)

    if prediction_graph_mode in ("cell", "nucleus"):
        if polygons is None or polygon_cell_ids is None:
            raise ValueError(
                f"prediction_graph_mode='{prediction_graph_mode}' needs "
                "polygons + polygon_cell_ids"
            )
        # order polygons by boundary (cell_encoding) order; cells without
        # a polygon get no candidates
        by_id = {cid: p for cid, p in zip(polygon_cell_ids, polygons)}
        poly_list, poly_rows = [], []
        for row, cid in enumerate(bd_cell_id):
            p = by_id.get(cid)
            if p is not None:
                poly_list.append(np.asarray(p))
                poly_rows.append(row)
        with substage("graph.prediction", items=tx_pos.shape[0]):
            cand_src, cand_poly = prediction_graph(
                tx_pos, bd_pos, mode=prediction_graph_mode,
                max_k=prediction_graph_max_k,
                buffer_ratio=prediction_graph_buffer_ratio,
                polygons=poly_list,
            )
        poly_rows = np.asarray(poly_rows, dtype=np.int64)
        cand_dst = poly_rows[cand_poly]
    else:
        with substage("graph.prediction", items=tx_pos.shape[0]):
            cand_src, cand_dst = prediction_graph(
                tx_pos, bd_pos, mode="uniform",
                max_k=prediction_graph_max_k,
            )

    # supplementary model data
    gene_embedding = np.asarray(adata.varm["X_corr"], dtype=np.float32)
    tx_similarity = np.asarray(
        adata.uns["gene_cluster_similarities"], dtype=np.float32
    )
    bd_similarity = np.asarray(
        adata.uns["cell_cluster_similarities"], dtype=np.float32
    )

    return HostGraph(
        tx_gene=tx_gene.astype(np.int32),
        tx_pos=tx_pos,
        tx_cluster=tx_cluster.astype(np.int32),
        tx_index=tx_index,
        tx_cell_encoding=tx_cell_encoding,
        bd_x=bd_x,
        bd_pos=bd_pos,
        bd_cluster=bd_cluster.astype(np.int32),
        bd_index=bd_index,
        bd_cell_id=bd_cell_id,
        tt_src=tt_src,
        tt_dst=tt_dst,
        sg_src=sg_src,
        sg_dst=sg_dst,
        cand_src=cand_src,
        cand_dst=cand_dst,
        gene_embedding=gene_embedding,
        tx_similarity=tx_similarity,
        bd_similarity=bd_similarity,
    )


def build_host_graph_columnar(
    cols,
    adata: AnnDataLite,
    segmentation_mask: np.ndarray,
    cells_embedding_key: str = "X_pca",
    transcripts_graph_max_k: int = 5,
    transcripts_graph_max_dist: float = 5.0,
    prediction_graph_mode: str = "cell",
    prediction_graph_max_k: int = 3,
    prediction_graph_buffer_ratio: float = 0.05,
    polygons: Optional[list] = None,
    polygon_cell_ids: Optional[np.ndarray] = None,
) -> HostGraph:
    """Assemble the whole-slide graph from a
    :class:`segger_tpu_torch.data.columnar.ColumnarTranscripts` table.

    Same semantics as :func:`build_host_graph` (the pandas path) with
    every per-row string join replaced by an integer lookup table over
    the columnar vocabularies: O(vocab) Python, O(N) array work, no
    object columns.  This is the out-of-core entry: ``cols`` columns
    may be disk-backed memmaps.  (The reference's setup_heterodata,
    src/segger/data/utils/heterodata.py:18-164, joins with pandas maps
    over the whole table, held in RAM.)
    """
    tx_f = TrainingTranscriptFields()

    # vocab-code -> feature-table encoding lookup arrays (O(G)/O(C))
    gene_enc_by_name = {
        g: int(e) for g, e in zip(
            adata.var.index.to_numpy().astype(str),
            adata.var[tx_f.gene_encoding].to_numpy(),
        )
    }
    gene_clu_by_name = {
        g: int(c) for g, c in zip(
            adata.var.index.to_numpy().astype(str),
            np.asarray(adata.var["phenograph_cluster"]),
        )
    }
    g_map = np.full(len(cols.gene_names), -1, np.int64)
    g_clu = np.full(len(cols.gene_names), -1, np.int64)
    for code, name in enumerate(cols.gene_names):
        e = gene_enc_by_name.get(str(name))
        if e is not None:
            g_map[code] = e
            g_clu[code] = gene_clu_by_name[str(name)]

    cell_enc_by_id = {
        c: int(e) for c, e in zip(
            adata.obs.index.to_numpy().astype(str),
            adata.obs[tx_f.cell_encoding].to_numpy(),
        )
    }
    c_map = np.full(len(cols.cell_ids) + 1, -1, np.int64)  # [-1] = none
    for code, cid in enumerate(cols.cell_ids):
        e = cell_enc_by_id.get(str(cid))
        if e is not None:
            c_map[code] = e

    tx_gene = g_map[np.asarray(cols.gene_code)]
    keep = tx_gene >= 0
    tx_gene = tx_gene[keep]
    tx_cluster = g_clu[np.asarray(cols.gene_code)[keep]]
    seg_mask = np.asarray(segmentation_mask)[keep]
    cell_code = np.asarray(cols.cell_code)[keep]
    tx_cell_encoding = np.where(seg_mask, c_map[cell_code], -1)

    tx_pos = np.stack(
        [np.asarray(cols.x)[keep], np.asarray(cols.y)[keep]], axis=1
    ).astype(np.float32)
    tx_index = np.asarray(cols.row_index)[keep]

    bd_x = np.asarray(adata.obsm[cells_embedding_key], dtype=np.float32)
    bd_pos = np.asarray(adata.obsm["X_spatial"], dtype=np.float32)
    bd_cluster = np.asarray(adata.obs["phenograph_cluster"], dtype=np.int64)
    bd_index = adata.obs[tx_f.cell_encoding].to_numpy(np.int64)
    bd_cell_id = adata.obs.index.to_numpy().astype(str)

    with substage("graph.tx_knn", items=tx_pos.shape[0]):
        tt_src, tt_dst = transcripts_graph(
            tx_pos, max_k=transcripts_graph_max_k,
            max_dist=transcripts_graph_max_dist,
        )
    sg_src, sg_dst = segmentation_graph(tx_cell_encoding, seg_mask)

    if prediction_graph_mode in ("cell", "nucleus"):
        if polygons is None or polygon_cell_ids is None:
            raise ValueError(
                f"prediction_graph_mode='{prediction_graph_mode}' needs "
                "polygons + polygon_cell_ids"
            )
        by_id = {cid: p for cid, p in zip(polygon_cell_ids, polygons)}
        poly_list, poly_rows = [], []
        for row, cid in enumerate(bd_cell_id):
            p = by_id.get(cid)
            if p is not None:
                poly_list.append(np.asarray(p))
                poly_rows.append(row)
        with substage("graph.prediction", items=tx_pos.shape[0]):
            cand_src, cand_poly = prediction_graph(
                tx_pos, bd_pos, mode=prediction_graph_mode,
                max_k=prediction_graph_max_k,
                buffer_ratio=prediction_graph_buffer_ratio,
                polygons=poly_list,
            )
        poly_rows = np.asarray(poly_rows, dtype=np.int64)
        cand_dst = poly_rows[cand_poly]
    else:
        with substage("graph.prediction", items=tx_pos.shape[0]):
            cand_src, cand_dst = prediction_graph(
                tx_pos, bd_pos, mode="uniform",
                max_k=prediction_graph_max_k,
            )

    gene_embedding = np.asarray(adata.varm["X_corr"], dtype=np.float32)
    tx_similarity = np.asarray(
        adata.uns["gene_cluster_similarities"], dtype=np.float32
    )
    bd_similarity = np.asarray(
        adata.uns["cell_cluster_similarities"], dtype=np.float32
    )

    return HostGraph(
        tx_gene=tx_gene.astype(np.int32),
        tx_pos=tx_pos,
        tx_cluster=tx_cluster.astype(np.int32),
        tx_index=tx_index.astype(np.int64),
        tx_cell_encoding=tx_cell_encoding.astype(np.int64),
        bd_x=bd_x,
        bd_pos=bd_pos,
        bd_cluster=bd_cluster.astype(np.int32),
        bd_index=bd_index,
        bd_cell_id=bd_cell_id,
        tt_src=tt_src,
        tt_dst=tt_dst,
        sg_src=sg_src,
        sg_dst=sg_dst,
        cand_src=cand_src,
        cand_dst=cand_dst,
        gene_embedding=gene_embedding,
        tx_similarity=tx_similarity,
        bd_similarity=bd_similarity,
    )


def save_host_graph(graph: HostGraph, path) -> None:
    """Persist a whole-slide HostGraph as one .npz (graph caching: the
    host build is minutes to hours at whole-slide scale and
    deterministic, so phased runs, prepared on the CPU and trained on
    the GPU, reload instead of rebuilding)."""
    np.savez_compressed(
        path,
        **{f.name: np.asarray(getattr(graph, f.name))
           for f in fields(HostGraph)},
    )


def load_host_graph(path) -> HostGraph:
    """Inverse of :func:`save_host_graph`."""
    with np.load(path, allow_pickle=False) as z:
        return HostGraph(**{f.name: z[f.name] for f in fields(HostGraph)})


def save_host_graph_plane(
    graph: HostGraph, dir_path, with_edge_groups: bool = True
) -> None:
    """Persist a HostGraph as a *memmappable plane*: one uncompressed
    ``.npy`` per field in a directory (``np.savez`` members cannot be
    memmapped), plus the three per-edge-type tile indexes
    (stable-argsort ``order`` + ``indptr``, the
    :class:`segger_tpu_torch.data.partition._EdgeGroups` arrays)
    computed once here on the prepare host.

    With :func:`load_host_graph_plane(..., mmap=True)` the run phase
    holds no O(E) arrays in anonymous RAM: edge arrays and their tile
    indexes are paged from disk per tile, which keeps run-phase memory
    sublinear in transcripts (the reference's scale note:
    src/segger/data/utils/neighbors.py:159).
    """
    os.makedirs(dir_path, exist_ok=True)
    for f in fields(HostGraph):
        np.save(
            os.path.join(dir_path, f.name + ".npy"),
            np.ascontiguousarray(np.asarray(getattr(graph, f.name))),
        )
    if with_edge_groups:
        for name, key, n_keys in (
            ("tt", graph.tt_dst, graph.n_tx),
            ("sg", graph.sg_dst, graph.n_bd),
            ("cand", graph.cand_src, graph.n_tx),
        ):
            order = np.argsort(key, kind="stable")
            counts = np.bincount(key, minlength=n_keys)
            indptr = np.concatenate(
                [np.zeros(1, np.int64), np.cumsum(counts)]
            )
            np.save(os.path.join(dir_path, f"_eg_{name}_order.npy"), order)
            np.save(
                os.path.join(dir_path, f"_eg_{name}_indptr.npy"), indptr
            )


def load_host_graph_plane(dir_path, mmap: bool = True) -> HostGraph:
    """Load a :func:`save_host_graph_plane` directory.

    ``mmap=True`` maps every array read-only from disk (touched pages
    are reclaimable page cache, not anonymous RAM) and pre-seeds the
    tile edge-group index from the plane so the run phase never
    materializes O(E) working sets.  The graph is also flagged for
    transient tile-edge extraction (see partition._tile_edges).
    """
    mode = "r" if mmap else None

    def _ld(name):
        return np.load(
            os.path.join(dir_path, name + ".npy"),
            mmap_mode=mode, allow_pickle=False,
        )

    g = HostGraph(**{f.name: _ld(f.name) for f in fields(HostGraph)})
    if os.path.exists(os.path.join(dir_path, "_eg_tt_order.npy")):
        from .partition import _EdgeGroups

        g.__dict__["_edge_groups_cache"] = {
            name: _EdgeGroups.from_arrays(
                _ld(f"_eg_{name}_order"), _ld(f"_eg_{name}_indptr")
            )
            for name in ("tt", "sg", "cand")
        }
    if mmap:
        g.__dict__["_transient_tile_edges"] = True
    return g
