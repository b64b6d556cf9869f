"""Segmentation quality metrics: transcript-assignment agreement against
a reference labeling.

The port's copy of ``segger_tpu/metrics/segment.py``, on NumPy, pandas
and SciPy.  The JAX package's ``assignment_ari`` calls scikit-learn's
``adjusted_rand_score``; the port forms the adjusted Rand index itself
from the contingency table (the GPU machine has no scikit-learn), with
scikit-learn's special case: 1.0 when no pair of transcripts is together
in one partition and apart in the other.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import pandas as pd
from scipy import sparse as sp


def _align(pred: pd.Series, truth: pd.Series):
    """Join two row_index-indexed cell-id series on common transcripts."""
    common = pred.index.intersection(truth.index)
    return pred.loc[common], truth.loc[common]


def _assigned(pred: pd.Series, truth: pd.Series, unassigned=None):
    """The aligned series where both have a cell (and neither is
    ``unassigned``)."""
    p, t = _align(pred, truth)
    keep = p.notna() & t.notna()
    if unassigned is not None:
        keep &= (p != unassigned) & (t != unassigned)
    return p[keep], t[keep]


def _pair_counts(p: pd.Series, t: pd.Series) -> Tuple[float, float, float,
                                                       int]:
    """``(sum C(n_ij, 2), sum C(a_i, 2), sum C(b_j, 2), n)`` of the
    contingency table ``n_ij`` of two labelings (cell ids compared as
    strings), with ``a`` its row sums (``p``'s cells) and ``b`` its
    column sums (``t``'s)."""
    _, pi = np.unique(p.to_numpy().astype(str), return_inverse=True)
    _, ti = np.unique(t.to_numpy().astype(str), return_inverse=True)
    n = len(pi)
    C = sp.coo_matrix(
        (np.ones(n), (pi.ravel(), ti.ravel())),
        shape=(pi.max() + 1, ti.max() + 1),
    ).tocsr()
    a = np.asarray(C.sum(axis=1)).ravel()
    b = np.asarray(C.sum(axis=0)).ravel()

    def pairs(x):
        return (x * (x - 1) / 2).sum()

    return pairs(C.data), pairs(a), pairs(b), n


def assignment_accuracy(pred: pd.Series, truth: pd.Series) -> float:
    """Fraction of commonly-indexed transcripts assigned to the same
    cell id (only meaningful when both labelings share an id space)."""
    p, t = _align(pred, truth)
    if len(p) == 0:
        return float("nan")
    return float((p.to_numpy() == t.to_numpy()).mean())


def assignment_f1(
    pred: pd.Series, truth: pd.Series, unassigned=None
) -> float:
    """Pairwise F1 over co-assignment: two transcripts are a "pair" when
    they share a cell.  Works across different cell-id spaces; from the
    contingency table: precision is the share of ``pred``'s pairs that
    are also pairs in ``truth``, recall the converse."""
    p, t = _assigned(pred, truth, unassigned)
    if len(p) == 0:
        return float("nan")
    tp, pred_pairs, truth_pairs, _ = _pair_counts(p, t)
    if pred_pairs == 0 or truth_pairs == 0:
        return float("nan")
    precision = tp / pred_pairs
    recall = tp / truth_pairs
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def assignment_ari(
    pred: pd.Series, truth: pd.Series, unassigned=None
) -> float:
    """Adjusted Rand index between the two transcript partitions, in
    float64: ``(index - expected) / (max - expected)`` with ``index =
    sum C(n_ij, 2)``, ``expected = sum C(a_i, 2) sum C(b_j, 2) /
    C(n, 2)`` and ``max`` the mean of the two row and column sums.  NaN
    when no transcript is left; 1.0 when no pair is in disagreement (both
    partitions one cell, both all singletons, or equal)."""
    p, t = _assigned(pred, truth, unassigned)
    if len(p) == 0:
        return float("nan")
    index, sum_a, sum_b, n = _pair_counts(p, t)
    if sum_a == index and sum_b == index:
        return 1.0
    expected = sum_a * sum_b / (n * (n - 1) / 2)
    top = (sum_a + sum_b) / 2
    return float((index - expected) / (top - expected))


def cluster_purity(pred: pd.Series, truth: pd.Series) -> float:
    """Mean per-predicted-cell purity: the fraction of its transcripts
    coming from its majority truth cell."""
    p, t = _assigned(pred, truth)
    df = pd.DataFrame({"p": p, "t": t})
    if df.empty:
        return float("nan")
    purities = df.groupby("p")["t"].agg(
        lambda s: s.value_counts().iloc[0] / len(s)
    )
    return float(purities.mean())


def segmentation_report(
    segmentation: pd.DataFrame,
    truth: pd.Series,
    row_index: str = "row_index",
    cell_column: str = "segger_cell_id",
    similarity_column: str = "segger_similarity",
    threshold_column: str = "similarity_threshold",
) -> Dict[str, float]:
    """Summary metrics for a segger segmentation table against a
    ground-truth transcript->cell series (indexed by row_index)."""
    pred = segmentation.set_index(row_index)[cell_column]
    out = {
        "n_transcripts": int(len(segmentation)),
        "fraction_assigned": float(pred.notna().mean()),
        "accuracy": assignment_accuracy(pred, truth),
        "f1": assignment_f1(pred, truth),
        "ari": assignment_ari(pred, truth),
        "purity": cluster_purity(pred, truth),
    }
    if (
        similarity_column in segmentation
        and threshold_column in segmentation
    ):
        kept = segmentation[
            segmentation[similarity_column]
            >= segmentation[threshold_column]
        ]
        pred_thr = kept.set_index(row_index)[cell_column]
        out["fraction_above_threshold"] = float(
            len(kept) / max(len(segmentation), 1)
        )
        out["f1_above_threshold"] = assignment_f1(pred_thr, truth)
    return out
