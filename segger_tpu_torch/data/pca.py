"""Principal component analysis of a dense array, as scikit-learn's ``PCA``
computes it.

The JAX package calls ``sklearn.decomposition.PCA(n_components,
random_state=seed)`` for the gene-correlation and the cell embeddings
(``segger_tpu/data/features.py``).  This module is the port's copy of
what that call computes for a dense float array, in NumPy and SciPy, so
that the feature stage runs where scikit-learn is not installed:

  - the ``svd_solver="auto"`` choice: ``covariance_eigh`` when
    ``n_features <= 1000`` and ``n_samples >= 10 * n_features``;
    ``full`` when ``max(shape) <= 500``; ``randomized`` when
    ``n_components < 0.8 * min(shape)``; else ``full``
  - the solvers: the eigendecomposition of the covariance
    (``numpy.linalg.eigh``), the LAPACK SVD of the centered data
    (``scipy.linalg.svd``), and the randomized SVD with scikit-learn's
    stream (``RandomState(seed).normal`` test matrix, 10 oversamples,
    ``n_iter`` 7 or 4, LU-normalized power iterations, transposed when
    the data are wide)
  - the sign rule (each component's largest-magnitude loading is
    positive) and the centering after the projection in ``transform``

The arithmetic runs in the input's dtype where it is float32, else
float64, as scikit-learn's does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import linalg


def svd_flip_v(u: Optional[np.ndarray], vt: np.ndarray):
    """Sign correction on the rows of ``vt`` (scikit-learn's
    ``svd_flip(u, v, u_based_decision=False)``): the largest-magnitude
    entry of each row becomes positive, and ``u``'s columns follow."""
    signs = np.sign(vt[np.arange(vt.shape[0]),
                       np.argmax(np.abs(vt), axis=1)])
    if u is not None:
        u *= signs[np.newaxis, :]
    vt *= signs[:, np.newaxis]
    return u, vt


def _range_finder(a: np.ndarray, size: int, n_iter: int,
                  rng: np.random.RandomState) -> np.ndarray:
    """Orthonormal basis approximating the range of ``a`` (scikit-learn's
    ``_randomized_range_finder`` with the 'auto' normalizer)."""
    q = rng.normal(size=(a.shape[1], size))
    if a.dtype == np.float32:
        q = q.astype(np.float32, copy=False)
    if n_iter <= 2:
        def normalize(x):
            return x
    else:
        def normalize(x):
            return linalg.lu(x, permute_l=True, check_finite=False)[0]
    for _ in range(n_iter):
        q = normalize(a @ q)
        q = normalize(a.T @ q)
    return linalg.qr(a @ q, mode="economic", check_finite=False)[0]


def randomized_svd(m: np.ndarray, n_components: int, seed: int):
    """Truncated SVD of ``m`` (scikit-learn's ``_randomized_svd`` with 10
    oversamples, ``n_iter='auto'``, ``transpose='auto'`` and no sign
    flip)."""
    rng = np.random.RandomState(seed)
    n_samples, n_features = m.shape
    n_iter = 7 if n_components < 0.1 * min(m.shape) else 4
    transpose = n_samples < n_features
    if transpose:
        m = m.T
    q = _range_finder(m, n_components + 10, n_iter, rng)
    u_hat, s, vt = linalg.svd(q.T @ m, full_matrices=False,
                              lapack_driver="gesdd")
    u = q @ u_hat
    if transpose:
        return vt[:n_components, :].T, s[:n_components], \
            u[:, :n_components].T
    return u[:, :n_components], s[:n_components], vt[:n_components, :]


def choose_solver(shape: Tuple[int, int], n_components: int) -> str:
    """scikit-learn's ``svd_solver='auto'`` choice for a dense array."""
    n_samples, n_features = shape
    if n_features <= 1_000 and n_samples >= 10 * n_features:
        return "covariance_eigh"
    if max(shape) <= 500:
        return "full"
    if 1 <= n_components < 0.8 * min(shape):
        return "randomized"
    return "full"


class PCA:
    """``PCA(n_components, random_state=seed)`` for dense arrays: ``fit``,
    ``transform`` and ``fit_transform``, with scikit-learn's
    ``components_`` and ``mean_`` and the chosen ``svd_solver_``."""

    def __init__(self, n_components: int, random_state: int = 0):
        self.n_components = int(n_components)
        self.random_state = random_state

    def _fit(self, x: np.ndarray):
        x = np.asarray(x)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        n_samples, n_features = x.shape
        k = self.n_components
        if not 1 <= k <= min(n_samples, n_features):
            raise ValueError(
                f"n_components={k} must be between 1 and "
                f"min(n_samples, n_features)={min(n_samples, n_features)}")
        solver = choose_solver(x.shape, k)
        self.svd_solver_ = solver
        self.mean_ = np.mean(x, axis=0)
        u = None
        if solver == "covariance_eigh":
            # the covariance from the Gram matrix, centered afterwards
            c = x.T @ x
            c -= n_samples * self.mean_.reshape(-1, 1) \
                * self.mean_.reshape(1, -1)
            c /= n_samples - 1
            evals, evecs = np.linalg.eigh(c)
            evals, evecs = np.flip(evals, axis=0), np.flip(evecs, axis=1)
            evals[evals < 0.0] = 0.0
            s = np.sqrt(evals * (n_samples - 1))
            _, vt = svd_flip_v(None, evecs.T)
        else:
            xc = x.copy()
            xc -= self.mean_
            if solver == "full":
                u, s, vt = linalg.svd(xc, full_matrices=False)
            else:
                u, s, vt = randomized_svd(xc, k, self.random_state)
            u, vt = svd_flip_v(u, vt)
        self.components_ = np.array(vt[:k], copy=True)
        return u, s, x

    def fit(self, x: np.ndarray) -> "PCA":
        self._fit(x)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        out = x @ self.components_.T
        out -= self.mean_.reshape(1, -1) @ self.components_.T
        return out

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        u, s, x = self._fit(x)
        if u is None:                   # covariance_eigh has no U
            return self.transform(x)
        k = self.n_components
        u = u[:, :k]
        u *= s[:k]
        return u
