"""A minimal AnnData-compatible container with h5ad read/write.

The reference stores cell-by-gene features in `anndata.AnnData` and writes
`.h5ad` outputs (reference: src/segger/data/utils/anndata.py:18-102,
src/segger/data/writer.py:122-129).  The full anndata package is not a
dependency of segger-tpu; this module provides the subset the framework
needs — X (CSR or dense), obs/var DataFrames, obsm/varm/uns/layers dicts —
and serializes it in the standard AnnData on-disk schema (encoding-type
annotated HDF5 groups) so external tools (scanpy, squidpy, SpatialData)
can read the outputs.

``h5py`` is imported only by :meth:`AnnDataLite.write_h5ad` and
:func:`read_h5ad`; without it they raise the ``ImportError`` that names
it, and everything else here works.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import pandas as pd
from scipy import sparse as sp


class AnnDataLite:
    """obs x var annotated matrix (subset of the anndata API)."""

    def __init__(
        self,
        X,
        obs: Optional[pd.DataFrame] = None,
        var: Optional[pd.DataFrame] = None,
        obsm: Optional[Dict[str, np.ndarray]] = None,
        varm: Optional[Dict[str, np.ndarray]] = None,
        uns: Optional[Dict] = None,
        layers: Optional[Dict] = None,
    ):
        self.X = X
        n, g = X.shape
        self.obs = obs if obs is not None else pd.DataFrame(index=range(n))
        self.var = var if var is not None else pd.DataFrame(index=range(g))
        assert len(self.obs) == n and len(self.var) == g
        self.obsm = obsm or {}
        self.varm = varm or {}
        self.uns = uns or {}
        self.layers = layers or {}

    @property
    def shape(self):
        return self.X.shape

    @property
    def n_obs(self):
        return self.X.shape[0]

    @property
    def n_vars(self):
        return self.X.shape[1]

    def copy(self) -> "AnnDataLite":
        X = self.X.copy()
        return AnnDataLite(
            X,
            self.obs.copy(),
            self.var.copy(),
            {k: np.array(v) for k, v in self.obsm.items()},
            {k: np.array(v) for k, v in self.varm.items()},
            dict(self.uns),
            {k: v.copy() for k, v in self.layers.items()},
        )

    def subset(self, obs_idx=None, var_idx=None) -> "AnnDataLite":
        """Positional subsetting along obs and/or var."""
        oi = np.arange(self.n_obs) if obs_idx is None else np.asarray(obs_idx)
        vi = np.arange(self.n_vars) if var_idx is None else np.asarray(var_idx)
        if oi.dtype == bool:
            oi = np.where(oi)[0]
        if vi.dtype == bool:
            vi = np.where(vi)[0]
        X = self.X[oi][:, vi] if sp.issparse(self.X) else self.X[np.ix_(oi, vi)]
        return AnnDataLite(
            X,
            self.obs.iloc[oi],
            self.var.iloc[vi],
            {k: np.asarray(v)[oi] for k, v in self.obsm.items()},
            {k: np.asarray(v)[vi] for k, v in self.varm.items()},
            dict(self.uns),
            {
                k: (v[oi][:, vi] if sp.issparse(v) else v[np.ix_(oi, vi)])
                for k, v in self.layers.items()
            },
        )

    # ------------------------------------------------------------------
    # h5ad serialization (AnnData on-disk schema v0.1 subset)
    # ------------------------------------------------------------------
    def write_h5ad(self, path) -> None:
        import h5py

        path = Path(path)
        with h5py.File(path, "w") as f:
            f.attrs["encoding-type"] = "anndata"
            f.attrs["encoding-version"] = "0.1.0"
            _write_matrix(f, "X", self.X)
            _write_dataframe(f, "obs", self.obs)
            _write_dataframe(f, "var", self.var)
            for group, mapping in [
                ("obsm", self.obsm),
                ("varm", self.varm),
                ("layers", self.layers),
                ("uns", self.uns),
            ]:
                g = f.create_group(group)
                g.attrs["encoding-type"] = "dict"
                g.attrs["encoding-version"] = "0.1.0"
                for k, v in mapping.items():
                    if isinstance(v, (np.ndarray, list)):
                        _write_array(g, k, np.asarray(v))
                    elif sp.issparse(v):
                        _write_matrix(g, k, v)
                    elif isinstance(v, (str, int, float, np.integer, np.floating)):
                        g[k] = v
                    elif v is None:
                        continue  # anndata also drops None uns entries
                    elif not isinstance(v, dict):
                        import warnings

                        warnings.warn(
                            f"write_h5ad: dropping {group}[{k!r}] of "
                            f"unsupported type {type(v).__name__} — it "
                            "will be missing after a read round-trip"
                        )
                        continue
                    elif isinstance(v, dict):
                        sub = g.create_group(k)
                        sub.attrs["encoding-type"] = "dict"
                        sub.attrs["encoding-version"] = "0.1.0"
                        for kk, vv in v.items():
                            if isinstance(vv, (np.ndarray, list)):
                                _write_array(sub, kk, np.asarray(vv))
                            else:
                                sub[kk] = vv


def read_h5ad(path) -> AnnDataLite:
    """Read an h5ad written by :meth:`AnnDataLite.write_h5ad` or by the
    anndata package (common-subset support: CSR/CSC/dense X, obs/var
    with string/numeric/categorical columns, array obsm/varm/layers)."""
    import h5py

    with h5py.File(path, "r") as f:
        X = _read_matrix(f["X"])
        obs = _read_dataframe(f["obs"])
        var = _read_dataframe(f["var"])

        def read_map(name):
            out = {}
            if name in f:
                for k, v in f[name].items():
                    if isinstance(v, h5py.Group):
                        enc = v.attrs.get("encoding-type", "")
                        if enc in ("csr_matrix", "csc_matrix"):
                            out[k] = _read_matrix(v)
                        elif enc == "dict":
                            out[k] = {
                                kk: _read_value(vv) for kk, vv in v.items()
                            }
                        else:
                            out[k] = _read_dataframe(v)
                    else:
                        out[k] = _read_value(v)
            return out

        return AnnDataLite(
            X, obs, var,
            obsm=read_map("obsm"),
            varm=read_map("varm"),
            uns=read_map("uns"),
            layers=read_map("layers"),
        )


# ----------------------------------------------------------------------
# low-level helpers
# ----------------------------------------------------------------------
def _write_array(g, name, arr: np.ndarray):
    import h5py

    if arr.dtype.kind in ("U", "O"):
        dt = h5py.string_dtype(encoding="utf-8")
        d = g.create_dataset(name, data=arr.astype(object), dtype=dt)
        d.attrs["encoding-type"] = "string-array"
    else:
        d = g.create_dataset(name, data=arr)
        d.attrs["encoding-type"] = "array"
    d.attrs["encoding-version"] = "0.2.0"
    return d


def _write_matrix(f, name, X):
    if sp.issparse(X):
        X = X.tocsr()
        g = f.create_group(name)
        g.attrs["encoding-type"] = "csr_matrix"
        g.attrs["encoding-version"] = "0.1.0"
        g.attrs["shape"] = np.array(X.shape, dtype=np.int64)
        g.create_dataset("data", data=X.data)
        g.create_dataset("indices", data=X.indices.astype(np.int32))
        g.create_dataset("indptr", data=X.indptr.astype(np.int32))
    else:
        _write_array(f, name, np.asarray(X))


def _read_matrix(node):
    import h5py

    if isinstance(node, h5py.Group):
        shape = tuple(node.attrs["shape"])
        data = node["data"][...]
        indices = node["indices"][...]
        indptr = node["indptr"][...]
        cls = (
            sp.csc_matrix
            if node.attrs.get("encoding-type") == "csc_matrix"
            else sp.csr_matrix
        )
        return cls((data, indices, indptr), shape=shape)
    return node[...]


def _read_value(v):
    val = v[...] if hasattr(v, "shape") and v.shape != () else v[()]
    if hasattr(val, "dtype") and val.dtype.kind == "O":
        val = val.astype(str)
    elif isinstance(val, bytes):
        val = val.decode()
    return val


def _write_dataframe(f, name, df: pd.DataFrame):
    import h5py

    g = f.create_group(name)
    g.attrs["encoding-type"] = "dataframe"
    g.attrs["encoding-version"] = "0.2.0"
    g.attrs["_index"] = "_index"
    g.attrs["column-order"] = np.array(
        [str(c) for c in df.columns], dtype=h5py.string_dtype()
    )
    _write_array(g, "_index", df.index.to_numpy().astype(str))
    for col in df.columns:
        vals = df[col]
        if isinstance(vals.dtype, pd.CategoricalDtype):
            sub = g.create_group(str(col))
            sub.attrs["encoding-type"] = "categorical"
            sub.attrs["encoding-version"] = "0.2.0"
            sub.attrs["ordered"] = False
            _write_array(sub, "categories",
                         vals.cat.categories.to_numpy().astype(str))
            sub.create_dataset("codes", data=vals.cat.codes.to_numpy())
        else:
            arr = vals.to_numpy()
            if arr.dtype == bool:
                d = g.create_dataset(str(col), data=arr)
                d.attrs["encoding-type"] = "array"
                d.attrs["encoding-version"] = "0.2.0"
            else:
                _write_array(g, str(col), arr)


def _read_dataframe(g) -> pd.DataFrame:
    import h5py

    index_key = g.attrs.get("_index", "_index")
    idx = g[index_key][...]
    if idx.dtype.kind == "O":
        idx = idx.astype(str)
    cols = {}
    order = [c for c in g.attrs.get("column-order", []) ]
    order = [c.decode() if isinstance(c, bytes) else str(c) for c in order]
    keys = order or [k for k in g.keys() if k != index_key]
    for k in keys:
        if k == index_key or k not in g:
            continue
        node = g[k]
        if isinstance(node, h5py.Group):  # categorical
            cats = node["categories"][...]
            if cats.dtype.kind == "O":
                cats = cats.astype(str)
            codes = node["codes"][...]
            cols[k] = pd.Categorical.from_codes(codes, categories=cats)
        else:
            v = node[...]
            if v.dtype.kind == "O":
                v = v.astype(str)
            cols[k] = v
    return pd.DataFrame(cols, index=idx)
