"""Feature engineering: count matrix, normalization, PCA embeddings,
phenograph clusters, and cluster-similarity matrices.

Re-implements the reference's AnnData pipeline
(reference: src/segger/data/utils/anndata.py:18-312) on
:class:`..compat.anndata_lite.AnnDataLite`; the port's copy of
``segger_tpu.data.features``, with the port's own PCA (``.pca``, what
scikit-learn's ``PCA`` computes) in place of scikit-learn's:

  - ``anndata_from_transcripts``: (cell, gene) sparse counts + centroids
  - ``setup_features``: median-library normalization on cells with >=
    ``cells_min_counts``; gene embeddings = PCA of the gene-gene
    correlation matrix (optionally from an external scRNA reference with
    error/remove strategies for missing genes); cell embeddings = PCA fit
    on filtered cells, transform on all; phenograph clusters for cells and
    genes; cluster-cosine-similarity matrices; integer encodings.

Intentional fix vs the reference: cluster-similarity matrices here are
indexed by cluster id over clusters 0..C-1 *excluding* the -1
"unclustered" label.  The reference builds them over
``torch.unique(clusters)`` which, when -1 is present, shifts every row by
one relative to the cluster ids used to index them in ``TripletLoss``
(anndata.py:105-128 vs triplet_loss.py:116-118) — an off-by-one we do not
replicate.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
from scipy import sparse as sp

from ..compat.anndata_lite import AnnDataLite
from ..io.fields import TrainingTranscriptFields
from ..utils_profiling import substage
from .clustering import phenograph
from .pca import PCA


def anndata_from_transcripts(
    tx: pd.DataFrame,
    feature_column: str,
    cell_id_column: str,
    score_column: Optional[str] = None,
    coordinate_columns: Optional[list] = None,
) -> AnnDataLite:
    """Sparse (cell x gene) counts from a transcript table
    (reference: anndata.py:18-102)."""
    tx = tx[tx[cell_id_column].notna()]
    cells, sid = np.unique(tx[cell_id_column].to_numpy().astype(str),
                           return_inverse=True)
    genes, fid = np.unique(tx[feature_column].to_numpy().astype(str),
                           return_inverse=True)
    X = sp.coo_matrix(
        (np.ones(len(tx), dtype=np.float32), (sid, fid)),
        shape=(len(cells), len(genes)),
    ).tocsr()
    ad = AnnDataLite(
        X,
        obs=pd.DataFrame(index=cells),
        var=pd.DataFrame(index=genes),
    )
    if score_column is not None:
        vals = tx[score_column].to_numpy().astype(np.float64)
        tot = sp.coo_matrix((vals, (sid, fid)), shape=X.shape).tocsr()
        cnt = X.copy()
        mean = tot.copy()
        mean.data = tot.data / cnt.data
        ad.layers[f"{score_column}_scores"] = mean
    if coordinate_columns is not None:
        coords = np.stack(
            [
                np.bincount(sid, weights=tx[c].to_numpy())
                / np.bincount(sid)
                for c in coordinate_columns
            ],
            axis=1,
        )
        ad.obsm["X_spatial"] = coords
    return ad


def cluster_cosine_similarity(
    embedding: np.ndarray, clusters: np.ndarray
) -> np.ndarray:
    """(C, C) cosine-similarity of per-cluster mean normalized embeddings
    for clusters 0..C-1 (reference math: anndata.py:105-128; see module
    docstring for the indexing fix).

    Entry [c, d] = mean pairwise cosine between members of c and d
    (means of unit vectors are NOT renormalized — diagonal < 1 for
    diffuse clusters).  This matches the reference exactly
    (anndata.py:128, ``means @ means.T`` on normalized rows); the
    triplet/metric losses consume these values as soft targets, so the
    convention must match."""
    clusters = np.asarray(clusters)
    keep = clusters >= 0
    c = int(clusters[keep].max()) + 1 if keep.any() else 0
    emb = np.asarray(embedding, dtype=np.float64)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
    means = np.zeros((c, emb.shape[1]))
    for ci in range(c):
        m = clusters == ci
        if m.any():
            means[ci] = emb[m].mean(axis=0)
    return (means @ means.T).astype(np.float32)


def _normalise(ad: AnnDataLite, cells_min_counts: int) -> AnnDataLite:
    """Median-library-size normalization on filtered cells
    (anndata.py:185-191)."""
    n_counts = np.asarray(ad.X.sum(axis=1)).ravel()
    ad.obs = ad.obs.copy()
    ad.obs["n_counts"] = n_counts
    ad.obs["filtered"] = n_counts >= cells_min_counts
    target = np.median(n_counts[ad.obs["filtered"].to_numpy()]) if ad.obs[
        "filtered"
    ].any() else 1.0
    scale = np.where(n_counts > 0, target / np.maximum(n_counts, 1e-12), 0.0)
    norm = sp.diags(scale) @ ad.X
    # f32: the f64 promotion from the diag product would double the
    # dense PCA working set (cells x genes) at whole-slide scale
    ad.layers["norm"] = norm.tocsr().astype(np.float32)
    return ad


def setup_features(
    transcripts: pd.DataFrame,
    boundaries: Optional[pd.DataFrame],
    cell_column: str,
    cells_embedding_size: int = 128,
    cells_min_counts: int = 10,
    cells_clusters_n_neighbors: int = 10,
    cells_clusters_resolution: float = 2.0,
    genes_min_counts: int = 100,
    genes_clusters_n_neighbors: int = 5,
    genes_clusters_resolution: float = 2.0,
    compute_morphology: bool = False,
    gene_corr_reference: Optional[AnnDataLite] = None,
    gene_missing_strategy: str = "error",
    morphology_props: Optional[pd.DataFrame] = None,
    seed: int = 0,
) -> AnnDataLite:
    """Full feature pipeline (reference: anndata.py:131-312)."""
    tx_fields = TrainingTranscriptFields()
    ad = anndata_from_transcripts(
        transcripts,
        tx_fields.feature,
        cell_column,
        coordinate_columns=[tx_fields.x, tx_fields.y],
    )
    return setup_features_from_anndata(
        ad,
        cells_embedding_size=cells_embedding_size,
        cells_min_counts=cells_min_counts,
        cells_clusters_n_neighbors=cells_clusters_n_neighbors,
        cells_clusters_resolution=cells_clusters_resolution,
        genes_min_counts=genes_min_counts,
        genes_clusters_n_neighbors=genes_clusters_n_neighbors,
        genes_clusters_resolution=genes_clusters_resolution,
        compute_morphology=compute_morphology,
        gene_corr_reference=gene_corr_reference,
        gene_missing_strategy=gene_missing_strategy,
        morphology_props=morphology_props,
        seed=seed,
    )


def setup_features_from_anndata(
    ad: AnnDataLite,
    cells_embedding_size: int = 128,
    cells_min_counts: int = 10,
    cells_clusters_n_neighbors: int = 10,
    cells_clusters_resolution: float = 2.0,
    genes_min_counts: int = 100,
    genes_clusters_n_neighbors: int = 5,
    genes_clusters_resolution: float = 2.0,
    compute_morphology: bool = False,
    gene_corr_reference: Optional[AnnDataLite] = None,
    gene_missing_strategy: str = "error",
    morphology_props: Optional[pd.DataFrame] = None,
    seed: int = 0,
) -> AnnDataLite:
    """Everything in :func:`setup_features` after the count matrix —
    the entry point for callers whose counts come from elsewhere than a
    whole-slide DataFrame.  All work below is O(cells x genes),
    independent of the transcript count."""
    tx_fields = TrainingTranscriptFields()

    # deterministic ordering (anndata.py:182)
    obs_order = np.argsort(ad.obs.index.to_numpy())
    var_order = np.argsort(ad.var.index.to_numpy())
    ad = ad.subset(obs_order, var_order)

    ad.layers["counts"] = ad.X.copy()

    # gene count filter + normalization (anndata.py:197-200)
    gene_counts = np.asarray(ad.X.sum(axis=0)).ravel()
    ad = ad.subset(var_idx=gene_counts >= genes_min_counts)
    ad = _normalise(ad, cells_min_counts)

    # gene-gene correlation source (anndata.py:203-245)
    if gene_corr_reference is not None:
        ref = gene_corr_reference
        ref_genes = set(ref.var.index.astype(str))
        missing = sorted(set(ad.var.index.astype(str)) - ref_genes)
        if missing:
            msg = (
                f"{len(missing)} genes are in the data but not in the "
                f"gene correlation reference: {missing[:5]}..."
            )
            if gene_missing_strategy == "error":
                raise ValueError(msg)
            elif gene_missing_strategy == "remove":
                import warnings

                warnings.warn(msg + " Removing them.")
                keep = np.asarray(~ad.var.index.isin(missing))
                ad = ad.subset(var_idx=keep)
                ad = _normalise(ad, cells_min_counts)
            elif gene_missing_strategy == "fill":
                # beyond-reference: the reference leaves this branch
                # NotImplementedError (anndata.py:228).  Fill = append
                # zero-count columns for the missing genes to the
                # REFERENCE matrix, so the data keeps every gene and
                # the missing ones get zero correlation rows (their
                # PCA embedding is driven by the other genes' loadings
                # at a zero correlation profile).
                import warnings

                warnings.warn(msg + " Filling with zero columns.")
                n_miss = len(missing)
                zeros = sp.csr_matrix(
                    (ref.X.shape[0], n_miss), dtype=ref.X.dtype
                )
                X_ext = sp.hstack([ref.X, zeros]).tocsr()
                var_ext = pd.concat(
                    [ref.var,
                     pd.DataFrame(index=pd.Index(missing))],
                )
                ref = AnnDataLite(X_ext, obs=ref.obs, var=var_ext)
            else:
                raise ValueError(
                    f"Unknown gene_missing_strategy: {gene_missing_strategy}"
                )
        ref_idx = {g: i for i, g in enumerate(ref.var.index.astype(str))}
        cols = [ref_idx[g] for g in ad.var.index.astype(str)]
        ref_sub = ref.subset(var_idx=np.asarray(cols))
        ref_sub = _normalise(ref_sub, cells_min_counts)
        # reference parity: the gene-gene correlation uses ALL reference
        # cells (anndata.py:243 ``counts = ref.layers['norm']``), not
        # just the >= cells_min_counts filtered subset the no-reference
        # branch uses — intentional asymmetry carried over faithfully
        counts = ref_sub.layers["norm"]
    else:
        counts = ad.layers["norm"][ad.obs["filtered"].to_numpy()]

    # gene embeddings: PCA of the gene-gene correlation matrix
    # (anndata.py:247-252)
    dense = np.asarray(counts.todense()) if sp.issparse(counts) else counts
    with np.errstate(invalid="ignore", divide="ignore"):
        C = np.corrcoef(dense.T)
    C = np.nan_to_num(C, nan=0.0, posinf=1.0, neginf=-1.0)
    n_genes = ad.n_vars
    g_comp = min(cells_embedding_size, n_genes)
    ad.varm["X_corr"] = PCA(
        n_components=g_comp, random_state=seed
    ).fit_transform(C).astype(np.float32)

    # cell embeddings: PCA fit on filtered cells, transform all
    # (anndata.py:254-258)
    filt = ad.obs["filtered"].to_numpy()
    with substage("features.pca_cells", items=ad.n_obs):
        norm_dense = np.asarray(ad.layers["norm"].todense())
        c_comp = min(cells_embedding_size, int(filt.sum()), n_genes)
        model = PCA(n_components=c_comp, random_state=seed)
        model.fit(norm_dense[filt])
        ad.obsm["X_pca"] = model.transform(norm_dense).astype(np.float32)

    # cell clusters on filtered cells (anndata.py:261-270)
    cell_clusters = phenograph(
        ad.obsm["X_pca"][filt],
        n_neighbors=cells_clusters_n_neighbors,
        resolution=cells_clusters_resolution,
        min_size=min(100, max(1, int(filt.sum() // 20))),
        seed=seed,
    )
    all_clusters = np.full(ad.n_obs, -1, dtype=np.int64)
    all_clusters[filt] = cell_clusters
    ad.obs["phenograph_cluster"] = all_clusters

    ad.uns["cell_cluster_similarities"] = cluster_cosine_similarity(
        ad.obsm["X_pca"], all_clusters
    )

    # gene clusters from the correlation embedding (anndata.py:278-291)
    gene_clusters = phenograph(
        ad.varm["X_corr"],
        n_neighbors=genes_clusters_n_neighbors,
        resolution=genes_clusters_resolution,
        min_size=-1,
        seed=seed,
    )
    ad.var["phenograph_cluster"] = gene_clusters
    ad.uns["gene_cluster_similarities"] = cluster_cosine_similarity(
        ad.varm["X_corr"], gene_clusters
    )

    # integer encodings (anndata.py:293-294)
    ad.obs[tx_fields.cell_encoding] = np.arange(ad.n_obs, dtype=np.int64)
    ad.var[tx_fields.gene_encoding] = np.arange(ad.n_vars, dtype=np.int64)

    if compute_morphology:
        if morphology_props is None:
            raise ValueError(
                "compute_morphology=True requires morphology_props "
                "(per-cell shape features indexed by cell_id)"
            )
        # reindex (not .loc): cells whose polygon was dropped by
        # geometry repair still appear in the transcript-derived obs
        # index — they get zero morphology rather than a KeyError
        props = morphology_props.reindex(ad.obs.index)
        n_missing = int(props.isna().any(axis=1).sum())
        if n_missing:
            import warnings

            warnings.warn(
                f"{n_missing} cells lack a valid cell polygon; their "
                "morphology features are zero-filled."
            )
            props = props.fillna(0.0)
        for col in props.columns:
            ad.obs[col] = props[col].to_numpy()
        ad.obsm["X_morphology"] = props.to_numpy(dtype=np.float32)
    return ad
