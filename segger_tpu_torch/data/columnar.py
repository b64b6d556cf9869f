"""Compact columnar transcript representation for out-of-core slides.

The port's copy of ``segger_tpu.data.columnar``.  A pandas DataFrame's
object columns (gene name, vendor cell id, one Python string per row)
cost about 50-60 B a row each, which at the 10^7-10^8 transcripts of a
whole slide is tens to hundreds of GB of host memory.
:class:`ColumnarTranscripts` stores the same information as six typed
arrays plus two small vocabularies:

    x, y         float32            (8 B/row)
    gene_code    int32  -> gene_names[g]          (4 B/row)
    cell_code    int32  -> cell_ids[c], -1 = none (4 B/row)
    compartment  int8   (StandardTranscriptFields values)  (1 B/row)
    row_index    int64  original vendor row ids   (8 B/row)

25 B/row: 100M transcripts = 2.5 GB resident, or about 0 when ``spool``
puts the arrays in disk-backed memmaps.  Constructors accept a whole
DataFrame, an iterator of DataFrame chunks (streaming standardization:
``io.preprocessor.iter_transcripts``), or a previously spooled
directory; a spool written by either package opens in the other.

Everything downstream consumes plain arrays: feature accumulation
(:func:`anndata_from_columnar`: chunked bincount, no per-row Python),
graph assembly
(:func:`segger_tpu_torch.data.assemble.build_host_graph_columnar`),
tiling, training, prediction.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Optional

import numpy as np
import pandas as pd

from ..io.fields import StandardTranscriptFields

_SPOOL_COLS = ("x", "y", "gene_code", "cell_code", "compartment",
               "row_index")
_SPOOL_DTYPES = {
    "x": np.float32, "y": np.float32, "gene_code": np.int32,
    "cell_code": np.int32, "compartment": np.int8, "row_index": np.int64,
}


@dataclass
class ColumnarTranscripts:
    """Typed-array transcript table (see module docstring)."""

    x: np.ndarray            # (N,) float32
    y: np.ndarray            # (N,) float32
    gene_code: np.ndarray    # (N,) int32 into gene_names (>= 0 always)
    cell_code: np.ndarray    # (N,) int32 into cell_ids (-1 = unassigned)
    compartment: np.ndarray  # (N,) int8
    row_index: np.ndarray    # (N,) int64
    gene_names: np.ndarray   # (G,) str
    cell_ids: np.ndarray     # (C,) str

    def __len__(self) -> int:
        return self.x.shape[0]

    @property
    def n(self) -> int:
        return self.x.shape[0]

    # ------------------------------------------------------------------
    @staticmethod
    def from_dataframe(
        df: pd.DataFrame,
        fields: Optional[StandardTranscriptFields] = None,
    ) -> "ColumnarTranscripts":
        """One-shot conversion (convenience; for large inputs prefer
        :meth:`from_chunks` over a streaming reader)."""
        return ColumnarTranscripts.from_chunks([df], fields)

    @staticmethod
    def from_chunks(
        chunks: Iterable[pd.DataFrame],
        fields: Optional[StandardTranscriptFields] = None,
        spool: Optional[os.PathLike] = None,
    ) -> "ColumnarTranscripts":
        """Streaming conversion: vocabularies build incrementally and
        each chunk's object columns are freed before the next loads.

        ``spool``: directory for disk-backed column memmaps — peak RSS
        stays O(chunk) + O(vocab) regardless of N.
        """
        f = fields or StandardTranscriptFields()
        gene_vocab: dict = {}
        cell_vocab: dict = {}
        parts = {c: [] for c in _SPOOL_COLS}
        spool_dir = Path(spool) if spool is not None else None
        writers = {}
        written = 0

        def emit(name, arr):
            if spool_dir is None:
                parts[name].append(arr)
            else:
                writers[name].write(
                    np.ascontiguousarray(arr, _SPOOL_DTYPES[name]).tobytes()
                )

        if spool_dir is not None:
            spool_dir.mkdir(parents=True, exist_ok=True)
            writers = {
                c: open(spool_dir / f"{c}.bin", "wb") for c in _SPOOL_COLS
            }

        for df in chunks:
            n = len(df)
            if n == 0:
                continue
            genes = df[f.feature].to_numpy().astype(str)
            gcodes = _encode(genes, gene_vocab)
            cells_raw = df[f.cell_id]
            # vendor "unassigned" spellings: NaN/None or empty string
            valid = np.asarray(cells_raw.notna().to_numpy()).copy()
            cells = cells_raw.to_numpy().astype(str)
            valid &= cells != ""
            ccodes = np.full(n, -1, np.int32)
            if valid.any():
                ccodes[valid] = _encode(cells[valid], cell_vocab)
            emit("x", df[f.x].to_numpy(np.float32))
            emit("y", df[f.y].to_numpy(np.float32))
            emit("gene_code", gcodes)
            emit("cell_code", ccodes)
            emit("compartment", df[f.compartment].to_numpy(np.int8))
            if f.row_index in df.columns:
                ri = df[f.row_index].to_numpy(np.int64)
            else:
                ri = np.arange(written, written + n, dtype=np.int64)
            emit("row_index", ri)
            written += n

        gene_names = _vocab_array(gene_vocab)
        cell_ids = _vocab_array(cell_vocab)
        if spool_dir is not None:
            for w in writers.values():
                w.close()
            np.save(spool_dir / "gene_names.npy", gene_names)
            np.save(spool_dir / "cell_ids.npy", cell_ids)
            return ColumnarTranscripts.open_spool(spool_dir)
        cols = {
            c: (np.concatenate(parts[c]) if parts[c]
                else np.zeros(0, _SPOOL_DTYPES[c]))
            for c in _SPOOL_COLS
        }
        return ColumnarTranscripts(
            gene_names=gene_names, cell_ids=cell_ids, **cols
        )

    @staticmethod
    def open_spool(spool: os.PathLike) -> "ColumnarTranscripts":
        """Re-open a spooled directory; columns come back as read-only
        memmaps (pages load on demand)."""
        spool = Path(spool)
        cols = {}
        for c in _SPOOL_COLS:
            cols[c] = np.memmap(
                spool / f"{c}.bin", dtype=_SPOOL_DTYPES[c], mode="r"
            )
        return ColumnarTranscripts(
            gene_names=np.load(spool / "gene_names.npy",
                               allow_pickle=False),
            cell_ids=np.load(spool / "cell_ids.npy", allow_pickle=False),
            **cols,
        )

    # ------------------------------------------------------------------
    def iter_slices(self, chunk: int = 4_000_000) -> Iterator[slice]:
        for start in range(0, self.n, chunk):
            yield slice(start, min(start + chunk, self.n))


def _encode(values: np.ndarray, vocab: dict) -> np.ndarray:
    """Map string values to stable int codes, growing ``vocab``."""
    uniq, inv = np.unique(values, return_inverse=True)
    lut = np.empty(len(uniq), np.int32)
    for i, v in enumerate(uniq):
        code = vocab.get(v)
        if code is None:
            code = len(vocab)
            vocab[v] = code
        lut[i] = code
    return lut[inv]


def _vocab_array(vocab: dict) -> np.ndarray:
    out = np.empty(len(vocab), dtype=object)
    for v, c in vocab.items():
        out[c] = v
    return out.astype(str)


# ----------------------------------------------------------------------
# feature accumulation
# ----------------------------------------------------------------------
def anndata_from_columnar(
    cols: ColumnarTranscripts,
    mask: Optional[np.ndarray] = None,
    chunk: int = 4_000_000,
):
    """Sparse (cell x gene) counts + mean spatial coordinates from a
    columnar table: the streaming equivalent of
    :func:`segger_tpu_torch.data.features.anndata_from_transcripts`
    (reference semantics: anndata.py:18-102).

    Matches the DataFrame path exactly: only rows with an assigned cell
    (and ``mask``, if given) count; obs/var indexes are the SORTED
    unique cell ids / gene names among those rows.  Accumulation is
    chunked bincount — O(chunk) peak memory on the transcript axis.
    """
    from scipy import sparse as sp

    from ..compat.anndata_lite import AnnDataLite

    G = len(cols.gene_names)
    C = len(cols.cell_ids)
    empty = sp.coo_matrix((C, G), dtype=np.float32).tocsr()
    sx = np.zeros(C, np.float64)
    sy = np.zeros(C, np.float64)
    ntx = np.zeros(C, np.int64)
    present_g = np.zeros(G, bool)

    blocks = []
    for sl in cols.iter_slices(chunk):
        cc = np.asarray(cols.cell_code[sl])
        keep = cc >= 0
        if mask is not None:
            keep &= np.asarray(mask[sl])
        if not keep.any():
            continue
        cc = cc[keep].astype(np.int64)
        gc = np.asarray(cols.gene_code[sl])[keep].astype(np.int64)
        present_g[gc] = True
        blocks.append(sp.coo_matrix(
            (np.ones(cc.size, np.float32), (cc, gc)), shape=(C, G)
        ).tocsr())
        np.add.at(sx, cc, np.asarray(cols.x[sl], np.float64)[keep])
        np.add.at(sy, cc, np.asarray(cols.y[sl], np.float64)[keep])
        np.add.at(ntx, cc, 1)
        # keep the block list shallow: merge periodically
        if len(blocks) >= 8:
            blocks = [sum(blocks[1:], blocks[0])]
    X = sum(blocks[1:], blocks[0]) if blocks else empty

    present_c = ntx > 0
    # sorted-by-name order (anndata_from_transcripts: np.unique)
    c_rows = np.where(present_c)[0]
    g_cols = np.where(present_g)[0]
    c_order = c_rows[np.argsort(cols.cell_ids[c_rows])]
    g_order = g_cols[np.argsort(cols.gene_names[g_cols])]
    X = X[c_order][:, g_order]

    ad = AnnDataLite(
        X.tocsr(),
        obs=pd.DataFrame(index=cols.cell_ids[c_order]),
        var=pd.DataFrame(index=cols.gene_names[g_order]),
    )
    coords = np.stack(
        [sx[c_order] / ntx[c_order], sy[c_order] / ntx[c_order]], axis=1
    )
    ad.obsm["X_spatial"] = coords
    return ad
