"""Histogram thresholding: Yen's maximum-correlation and Li's
minimum-cross-entropy methods.

Replaces skimage's ``threshold_yen`` / ``threshold_li``
(used by the reference writer: src/segger/data/writer.py:233-236,
src/segger/data/utils/threshold.py:3-11).  Implemented from the published
algorithms:

  - Yen (1995): maximize TC(t) = 2 ln(P(t)(1-P(t))) - ln(P2(t) P2'(t))
    over the normalized histogram's cumulative first/second moments.
  - Li & Tam (1998) iterative minimum cross entropy:
    t_{k+1} = (mu_b(t_k) - mu_f(t_k)) / (ln mu_b(t_k) - ln mu_f(t_k))
    on data shifted to be positive.
"""
from __future__ import annotations

import numpy as np


def threshold_yen(values: np.ndarray, nbins: int = 256) -> float:
    values = np.asarray(values, dtype=np.float64).ravel()
    lo, hi = values.min(), values.max()
    if hi <= lo:
        return float(lo)
    hist, edges = np.histogram(values, bins=nbins, range=(lo, hi))
    centers = (edges[:-1] + edges[1:]) / 2
    p = hist / hist.sum()
    P = np.cumsum(p)
    P2 = np.cumsum(p ** 2)
    P2r = np.cumsum(p[::-1] ** 2)[::-1]
    eps = 1e-30
    # criterion at cut t: background = bins <= t, foreground = bins > t
    # — the foreground second moment must EXCLUDE bin t (P2r[t+1]), the
    # same pairing skimage uses (P1_sq[:-1] with P2_sq[1:]); including
    # bin t skews the argmax near concentrated mass
    Pt, P2t, P2rt = P[:-1], P2[:-1], P2r[1:]
    crit = (
        2.0 * np.log(np.clip(Pt * (1.0 - Pt), eps, None))
        - np.log(np.clip(P2t * P2rt, eps, None))
    )
    valid = (Pt > 0) & (Pt < 1)
    if not valid.any():
        return float(centers[len(centers) // 2])
    crit = np.where(valid, crit, -np.inf)
    return float(centers[int(np.argmax(crit))])


def threshold_li(
    values: np.ndarray,
    max_iter: int = 250,
    tol: float | None = None,
) -> float:
    """Li's iterative threshold; raises ``StopIteration`` when the
    iteration fails to converge within ``max_iter`` (matching the
    reference's custom callback contract,
    src/segger/data/utils/threshold.py:3-11)."""
    values = np.asarray(values, dtype=np.float64).ravel()
    lo, hi = values.min(), values.max()
    if hi <= lo:
        return float(lo)
    # shift to positive domain (log of means requires > 0)
    shift = lo
    v = values - shift
    hi_s = hi - shift
    if tol is None:
        tol = hi_s * 1e-6

    t = v.mean()
    for _ in range(max_iter):
        below = v[v <= t]
        above = v[v > t]
        mu_b = below.mean() if below.size else 0.0
        mu_f = above.mean() if above.size else hi_s
        mu_b = max(mu_b, hi_s * 1e-9)
        mu_f = max(mu_f, hi_s * 1e-9)
        if abs(np.log(mu_b) - np.log(mu_f)) < 1e-12:
            return float(t + shift)
        t_next = (mu_b - mu_f) / (np.log(mu_b) - np.log(mu_f))
        if abs(t_next - t) < tol:
            return float(t_next + shift)
        t = t_next
    raise StopIteration("threshold_li failed to converge")
