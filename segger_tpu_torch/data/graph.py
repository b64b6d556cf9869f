"""Static-shape heterogeneous tile graphs.

A :class:`TileGraph` is one spatial tile: padded node arrays, padded-CSR
adjacency and validity masks.  On the host its arrays are NumPy (as
:func:`segger_tpu_torch.data.partition.extract_tile` builds them);
:meth:`TileGraph.to` moves them to a device as torch tensors.  Stacking B
tiles on a leading axis gives a batch.

Node packing invariant: valid nodes occupy the leading rows
(0..n_valid-1) of every per-node array; padding rows follow.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from ..ops.padded_csr import PaddedCSR, as_tensor


@dataclass
class TileGraph:
    """One spatial tile of the transcript/boundary graph.

    Shapes (per tile): Ntx transcripts, Nbd boundaries, padded widths K*.
    """

    # -- transcript ('tx') nodes
    tx_gene: Any      # (Ntx,)  int32 gene encoding
    tx_pos: Any       # (Ntx,2) float32 spatial coordinates
    tx_cluster: Any   # (Ntx,)  int32 gene cluster
    tx_index: Any     # (Ntx,)  int32 global transcript row index
    tx_valid: Any     # (Ntx,)  bool  real node (not padding)
    tx_interior: Any  # (Ntx,)  bool  inside tile-minus-margin

    # -- boundary ('bd') nodes
    bd_x: Any         # (Nbd,Fbd) float32 cell embedding
    bd_pos: Any       # (Nbd,2)   float32 centroid
    bd_cluster: Any   # (Nbd,)    int32 cell cluster
    bd_index: Any     # (Nbd,)    int32 global cell encoding
    bd_valid: Any     # (Nbd,)    bool
    bd_interior: Any  # (Nbd,)    bool

    # -- adjacency (padded CSR, keyed by aggregation destination)
    tt: PaddedCSR     # tx->tx 'neighbors'   (rows: tx)
    tb: PaddedCSR     # tx->bd 'belongs'     (rows: bd)
    cand: PaddedCSR   # tx->bd candidates    (rows: tx, idx: bd rows)

    # -- supervision edges as padded COO
    sg_src: Any       # (Esg,) int32 tx row
    sg_dst: Any       # (Esg,) int32 bd row
    sg_mask: Any      # (Esg,) bool

    # optional bd->tx 'contains' adjacency (dormant in the reference)
    bt: Optional[PaddedCSR] = None

    # optional transpose tables (src-keyed slot positions) for the
    # scatter-free backward; their presence also selects the fused
    # degree-bucketed edge stage, as in the JAX package
    tt_t: Optional[PaddedCSR] = None
    tb_t: Optional[PaddedCSR] = None

    # degree bucketing of the tt edge stage: rows [0, tt_n_lo) have tt
    # in-degree <= tt_k_lo (data/partition.py::apply_degree_bucketing);
    # tt_n_lo == 0 disables.  Rows [0, tt_n_xlo) further have in-degree
    # <= tt_k_xlo; tt_lo_t then covers only rows [tt_n_xlo, tt_n_lo).
    tt_lo_t: Optional[PaddedCSR] = None
    tt_hi_t: Optional[PaddedCSR] = None
    tt_n_lo: int = 0
    tt_k_lo: int = 0
    tt_xlo_t: Optional[PaddedCSR] = None
    tt_n_xlo: int = 0
    tt_k_xlo: int = 0

    # True for halo-sharded tiles whose tables address an extended
    # node space (parallel/_build_common.py, for training)
    transposes_extended: bool = False

    # host-precomputed triplet-sampler block structure
    tx_sampler_sorted: Any = None
    tx_sampler_counts: Any = None
    bd_sampler_sorted: Any = None
    bd_sampler_counts: Any = None

    @property
    def n_tx(self) -> int:
        return self.tx_gene.shape[-1]

    @property
    def n_bd(self) -> int:
        return self.bd_x.shape[-2]

    def n_edges(self):
        """Total valid message-passing edges (tt + tb [+ bt])."""
        e = self.tt.mask.sum() + self.tb.mask.sum()
        if self.bt is not None:
            e = e + self.bt.mask.sum()
        return e

    def replace(self, **kw) -> "TileGraph":
        return dataclasses.replace(self, **kw)

    def map_arrays(self, fn: Callable) -> "TileGraph":
        """Apply ``fn`` to every array (CSR fields included); static
        ints, flags and absent tables stay as they are."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, PaddedCSR):
                kw[f.name] = PaddedCSR(fn(v.idx), fn(v.mask))
            elif v is None or isinstance(v, (bool, int)):
                kw[f.name] = v
            else:
                kw[f.name] = fn(v)
        return TileGraph(**kw)

    def to(self, device) -> "TileGraph":
        """All arrays as torch tensors on ``device``."""
        return self.map_arrays(lambda a: as_tensor(a, device))


def pad_axis(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``a`` to length ``n`` with ``fill``; raises on
    overflow (truncating would drop valid nodes or edges)."""
    if a.shape[0] == n:
        return a
    if a.shape[0] > n:
        raise ValueError(
            f"pad_axis: array of length {a.shape[0]} exceeds target "
            f"{n} — bucket sized too small for this tile"
        )
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)
