"""Contamination QC: per-transcript posterior over {self, neighbor,
background} molecule sources.

The port's copy of ``segger_tpu/validation/contamination.py``, on
pandas and SciPy over the port's ``compat.anndata_lite.AnnDataLite``
(host-only: no tensor, no device):

  - neighbor cell-type frequency table per cell (SciPy's KDTree kNN,
    optional distance cap)
  - reference likelihood L[type, gene] = pct-positive x mean-expression
    from a CellxGene-style expression summary
  - alpha-weighted normalized posteriors stored as sparse layers
    (q_self / q_neighbor / q_background) + percent_contamination per cell
  - donor -> host contamination flow matrix
  - the reference grouping and the expression summary

The expression summary tables are plain pandas DataFrames with columns
``cell_type_name, gene_name, pc, me, n, n_cells_cell_type``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import scipy.sparse as sp

from ..compat.anndata_lite import AnnDataLite


def map_with_default(
    keys, mapping: Dict[str, int], default: int = -1,
    dtype=np.int32,
) -> np.ndarray:
    """Integer ids for keys with a default for misses."""
    return np.array(
        [mapping.get(str(k), default) for k in keys], dtype=dtype
    )


def get_neighbor_frequencies(
    ad: AnnDataLite,
    k: int,
    col: str,
    obsm: str = "X_spatial",
    normalize: bool = True,
    key_added: str = "neighbor_frequencies",
    max_distance: Optional[float] = None,
) -> pd.DataFrame:
    """Neighbor cell-type frequencies per cell (SciPy's KDTree kNN).

    As in the JAX package, the query set equals the fit set, so each
    cell counts itself among its k neighbors: the own-type frequency
    includes a 1/k self contribution, and calculate_contamination zeroes
    the host-type column downstream."""
    from scipy.spatial import KDTree

    X = np.asarray(ad.obsm[obsm], dtype=np.float64)
    n = X.shape[0]
    kq = min(k, n)
    tree = KDTree(X)
    dists, idx = tree.query(X, k=kq, workers=-1)
    if kq == 1:
        dists, idx = dists[:, None], idx[:, None]

    labels, cell_types = pd.factorize(
        pd.Series(np.asarray(ad.obs[col])), sort=True
    )
    n_types = len(cell_types)

    host = np.repeat(np.arange(n, dtype=np.int32), kq)
    neigh = idx.ravel()
    dd = dists.ravel()
    if max_distance is not None:
        m = dd <= max_distance
        host, neigh = host[m], neigh[m]
    cols_ = labels[neigh].astype(np.int32)
    keep = cols_ >= 0
    host, cols_ = host[keep], cols_[keep]
    mat = sp.csr_matrix(
        (np.ones(host.size, np.float64), (host, cols_)),
        shape=(n, n_types),
    )
    if normalize:
        sums = np.asarray(mat.sum(1)).ravel()
        sums[sums == 0] = 1.0
        mat = mat.multiply(1.0 / sums[:, None]).tocsr()

    df = pd.DataFrame(
        mat.toarray(), index=ad.obs.index, columns=list(cell_types)
    )
    ad.obsm[key_added] = df
    return df


def _reference_maps(reference: pd.DataFrame, ct_key: str, gene_key: str):
    ct_map = {
        ct: i for i, ct in enumerate(sorted(reference[ct_key].unique()))
    }
    gn_map = {
        g: i for i, g in enumerate(sorted(reference[gene_key].unique()))
    }
    return ct_map, gn_map


def calculate_contamination(
    adata: AnnDataLite,
    reference: pd.DataFrame,
    *,
    counts_layer: str,
    spatial_key: str,
    cell_type_key: str,
    n_neighbors: int = 10,
    max_neighbor_distance: float = 20,
    alpha_self: float = 0.8,
    alpha_neighbor: float = 0.15,
    alpha_background: float = 0.05,
    reference_cell_type_key: str = "cell_type_name",
    reference_gene_name_key: str = "gene_name",
    eps: float = 1e-6,
    contam_cutoff: float = 0.5,
) -> None:
    """Add q_self/q_neighbor/q_background sparse layers + the
    percent_contamination obs column (reference: contamination.py:102-219).
    """
    get_neighbor_frequencies(
        adata,
        k=n_neighbors,
        max_distance=max_neighbor_distance,
        col=cell_type_key,
        obsm=spatial_key,
        normalize=True,
        key_added="neighbor_frequencies",
    )
    neigh_df: pd.DataFrame = adata.obsm["neighbor_frequencies"]

    ct_map, gn_map = _reference_maps(
        reference, reference_cell_type_key, reference_gene_name_key
    )
    n_types, n_genes = len(ct_map), len(gn_map)

    # likelihood L[type, gene] = pc * me + eps (contamination.py:144-148)
    L = np.full((n_types, n_genes), eps, dtype=np.float32)
    ct_ids = map_with_default(
        reference[reference_cell_type_key], ct_map
    )
    g_ids = map_with_default(reference[reference_gene_name_key], gn_map)
    pc = reference.get(
        "pc", pd.Series(np.ones(len(reference)))
    ).to_numpy()
    me = reference.get(
        "me", pd.Series(np.ones(len(reference)))
    ).to_numpy()
    L[ct_ids, g_ids] = pc * me + eps

    neigh_df = neigh_df.reindex(columns=list(ct_map.keys()),
                                fill_value=0.0)
    neigh = neigh_df.to_numpy(dtype=np.float32)

    # ambient prior from host-type abundance (contamination.py:153-154)
    A = (
        pd.Series(np.asarray(adata.obs[cell_type_key]))
        .value_counts(normalize=True)
        .reindex(ct_map.keys(), fill_value=0.0)
        .to_numpy()
    )

    X = adata.layers[counts_layer].tocoo()
    rows, cols, vals = X.row, X.col, X.data

    host_ct_idx = map_with_default(
        np.asarray(adata.obs[cell_type_key]).astype(str), ct_map
    )[rows]
    gene_idx = map_with_default(adata.var.index, gn_map)[cols]
    missing_gene = gene_idx == -1

    # per-transcript source likelihoods (contamination.py:169-179).
    # Cells whose type is absent from the reference (host_ct_idx == -1)
    # get P_self = eps — NOT L[-1, g], which would silently read the
    # last reference type's row
    missing_type = host_ct_idx < 0
    P_self = np.where(
        missing_gene | missing_type,
        eps,
        L[np.maximum(host_ct_idx, 0), gene_idx],
    )
    nv = neigh[rows].copy()
    valid = (~missing_gene) & (~missing_type)
    iv = np.nonzero(valid)[0]
    if iv.size:
        nv[iv, host_ct_idx[iv]] = 0.0
    # one (n_types, nnz) gather serves both terms; einsum avoids the
    # transposed copy (the gather is the dominant allocation here)
    Lg = L[:, gene_idx]
    P_neigh = np.einsum("nt,tn->n", nv, Lg) + eps
    P_back = A @ Lg + eps

    q_self = alpha_self * P_self
    q_neigh = alpha_neighbor * P_neigh
    q_back = alpha_background * P_back
    denom = q_self + q_neigh + q_back
    q_self, q_neigh, q_back = (
        q_self / denom, q_neigh / denom, q_back / denom
    )
    q_self[missing_gene] = 0
    q_neigh[missing_gene] = 0
    q_back[missing_gene] = 0

    shape = adata.layers[counts_layer].shape
    for name, q in (
        ("q_self", q_self),
        ("q_neighbor", q_neigh),
        ("q_background", q_back),
    ):
        adata.layers[name] = sp.coo_matrix(
            (q, (rows, cols)), shape=shape
        ).tocsr()

    # contaminated counts + percent (contamination.py:205-219)
    contam_mask = q_self < contam_cutoff
    contam_mask[missing_gene] = False
    contam_vals = np.where(contam_mask, vals, 0.0)
    adata.layers["contamination"] = sp.coo_matrix(
        (contam_vals, (rows, cols)), shape=shape
    ).tocsr()
    contam_counts = np.bincount(
        rows[contam_mask], weights=vals[contam_mask],
        minlength=adata.n_obs,
    )
    total_counts = np.bincount(rows, weights=vals, minlength=adata.n_obs)
    adata.obs["percent_contamination"] = (
        100.0 * contam_counts / np.maximum(total_counts, 1)
    )


def contamination_flow(
    ad: AnnDataLite,
    reference: pd.DataFrame,
    *,
    cell_type_key: str,
    counts_layer: str,
    contamination_layer: str = "contamination",
    reference_cell_type_key: str = "cell_type_name",
    reference_gene_name_key: str = "gene_name",
) -> pd.DataFrame:
    """Donor -> host contamination flow matrix
    (reference: contamination.py:221-290)."""
    if contamination_layer not in ad.layers:
        raise ValueError("contamination layer missing in AnnData")

    donor_types = reference[reference_cell_type_key].unique()
    genes_ref = reference[reference_gene_name_key].unique()
    d_map = {ct: i for i, ct in enumerate(donor_types)}
    g_map = {g: i for i, g in enumerate(genes_ref)}

    # W[gene, donor] row-normalized
    W = np.zeros((len(genes_ref), len(donor_types)), dtype=np.float32)
    d_ids = map_with_default(reference[reference_cell_type_key], d_map)
    g_ids = map_with_default(reference[reference_gene_name_key], g_map)
    pc = reference.get("pc", pd.Series(np.zeros(len(reference)))).to_numpy()
    me = reference.get("me", pd.Series(np.zeros(len(reference)))).to_numpy()
    W[g_ids, d_ids] = pc * me
    row_sum = W.sum(1, keepdims=True)
    row_sum[row_sum == 0] = 1.0
    W /= row_sum

    gene_idx_ad = map_with_default(ad.var.index, g_map)
    keep_gene = gene_idx_ad >= 0
    if not np.any(keep_gene):
        raise ValueError("No shared genes between AnnData and reference")

    C = ad.layers[contamination_layer].tocsr()[:, keep_gene]
    W_sub = W[gene_idx_ad[keep_gene], :]
    contrib = np.asarray(C @ W_sub)

    libsize = np.asarray(
        ad.layers[counts_layer].sum(1)
    ).ravel().astype(np.float32)
    libsize[libsize == 0] = 1.0
    percent = 100.0 * (contrib / libsize[:, None])

    host_lab = pd.Series(np.asarray(ad.obs[cell_type_key]).astype(str))
    host_types = host_lab.unique()
    h_map = {ct: i for i, ct in enumerate(host_types)}
    host_idx = host_lab.map(h_map).to_numpy()

    flow = np.zeros((len(donor_types), len(host_types)))
    cell_counts = np.bincount(host_idx, minlength=len(host_types))
    for d in range(len(donor_types)):
        sums = np.bincount(
            host_idx, weights=percent[:, d], minlength=len(host_types)
        )
        flow[d] = sums / np.maximum(cell_counts, 1)

    out = pd.DataFrame(flow, index=donor_types, columns=host_types)
    out.index.name = "source"
    out.columns.name = "host"
    return out


def group_reference(
    reference: pd.DataFrame,
    grouping: Dict[str, str],
    *,
    cell_type_name_col: str = "cell_type_name",
    gene_name_col: str = "gene_name",
    percent_col: str = "pc",
    mean_expr_col: str = "me",
    n_cells_col: str = "n_cells_cell_type",
    n_pos_cells_col: str = "n",
) -> pd.DataFrame:
    """Aggregate reference rows into user-defined cell-type groups
    (reference: contamination.py:293-353).

    Reference-parity note: n_cells sums only over rows PRESENT in the
    summary (types with zero positive cells for a gene contribute no
    row), exactly as the reference's group_by().agg(pl.sum) does —
    percent-positive can therefore be overestimated for genes missing
    from part of a group.  Build the summary with
    ``expression_summary_from_anndata(..., keep_zeros=True)`` if every
    (type, gene) pair must be represented."""
    ref = reference.copy()
    ref[cell_type_name_col] = ref[cell_type_name_col].map(
        lambda x: grouping.get(x, x)
    )
    ref["weighted_expr"] = ref[mean_expr_col] * ref[n_pos_cells_col]
    agg = (
        ref.groupby([cell_type_name_col, gene_name_col], as_index=False)
        .agg(
            **{
                n_cells_col: (n_cells_col, "sum"),
                n_pos_cells_col: (n_pos_cells_col, "sum"),
                "expr_sum": ("weighted_expr", "sum"),
            }
        )
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        agg[mean_expr_col] = np.where(
            agg[n_pos_cells_col] > 0,
            agg["expr_sum"] / agg[n_pos_cells_col], 0.0,
        )
        agg[percent_col] = np.where(
            agg[n_cells_col] > 0,
            agg[n_pos_cells_col] / agg[n_cells_col], 0.0,
        )
    return agg.drop(columns=["expr_sum"])


def expression_summary_from_anndata(
    ad: AnnDataLite,
    cell_type_col: str,
    raw_layer: str,
    min_counts: int = 2,
    target_sum: float = 1e4,
    keep_zeros: bool = False,
) -> pd.DataFrame:
    """CellxGene-style expression summary
    (reference: contamination.py:355-407): normalize to ``target_sum``,
    log1p, zero entries below ``min_counts`` raw, then per-(type, gene)
    positive-cell count ``n``, mean expression in positive cells ``me``,
    cells per type ``n_cells_cell_type``, percent positive ``pc``.

    ``keep_zeros=True`` emits a row for EVERY (type, gene) pair (n=0
    rows included) so that :func:`group_reference`'s summed n_cells
    denominators stay exact for genes absent from part of a group."""
    raw = ad.layers[raw_layer].tocsr().astype(np.float64)
    libsize = np.asarray(raw.sum(1)).ravel()
    scale = np.where(libsize > 0, target_sum / np.maximum(libsize, 1e-12),
                     0.0)
    norm = sp.diags(scale) @ raw
    norm.data = np.log1p(norm.data)
    # CellxGene filter: only entries with raw counts >= min_counts
    mask = raw.copy()
    mask.data = (mask.data >= min_counts).astype(np.float64)
    norm = norm.multiply(mask).tocsr()

    labels, types = pd.factorize(
        pd.Series(np.asarray(ad.obs[cell_type_col]).astype(str)),
        sort=True,
    )
    n_types = len(types)
    ind = sp.csr_matrix(
        (np.ones(len(labels)), (labels, np.arange(len(labels)))),
        shape=(n_types, len(labels)),
    )
    sums = np.asarray((ind @ norm).todense())            # (T, G)
    pos = norm.copy()
    pos.data = (pos.data > 0).astype(np.float64)
    n_pos = np.asarray((ind @ pos).todense())            # (T, G)
    n_cells = np.bincount(labels, minlength=n_types)

    rows = []
    genes = ad.var.index.to_numpy().astype(str)
    for t in range(n_types):
        nz = (
            np.arange(n_pos.shape[1])
            if keep_zeros
            else np.nonzero(n_pos[t] > 0)[0]
        )
        for g in nz:
            rows.append(
                (
                    str(types[t]),
                    genes[g],
                    int(n_pos[t, g]),
                    sums[t, g] / n_pos[t, g] if n_pos[t, g] else 0.0,
                    int(n_cells[t]),
                )
            )
    out = pd.DataFrame(
        rows,
        columns=["cell_type_name", "gene_name", "n", "me",
                 "n_cells_cell_type"],
    )
    out["pc"] = out["n"] / out["n_cells_cell_type"]
    return out
