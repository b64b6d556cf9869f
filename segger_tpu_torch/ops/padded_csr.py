"""Padded-CSR: the sparse-graph layout of the port.

For every destination node, up to K source indices plus a validity mask.
Row-wise masked reductions replace scatter ops: masked row softmax for
GATv2 attention, gather + masked row sum for aggregation, masked row
max/argmax for the prediction assignment.

The host converters are NumPy and produce tables byte for byte equal to
the JAX package's (``segger_tpu/ops/padded_csr.py``); on the device the
same dataclass holds torch tensors (:meth:`PaddedCSR.to`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


def as_tensor(a, device) -> torch.Tensor:
    """A NumPy array or tensor as a tensor on ``device`` (dtype kept)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclass
class PaddedCSR:
    """A fixed-shape neighbor table for one edge type.

    idx : (N_dst, K) int32 source-node indices; in range (0) where invalid.
    mask : (N_dst, K) bool, True where the slot holds a real edge.

    NumPy arrays on the host, torch tensors after :meth:`to`.
    """

    idx: Any
    mask: Any

    @property
    def n_dst(self) -> int:
        return self.idx.shape[0]

    @property
    def k(self) -> int:
        return self.idx.shape[1]

    @property
    def n_edges(self):
        """Valid slots: a 0-d tensor for tensors, a NumPy scalar on the
        host."""
        return self.mask.sum()

    def to(self, device) -> "PaddedCSR":
        return PaddedCSR(as_tensor(self.idx, device),
                         as_tensor(self.mask, device))


def coo_to_padded_csr(
    dst: np.ndarray,
    src: np.ndarray,
    n_dst: int,
    k: Optional[int] = None,
    pad_to_multiple: int = 1,
) -> PaddedCSR:
    """COO edge list -> padded-CSR table keyed on ``dst`` (host side).

    ``k`` defaults to the max in-degree; edges beyond ``k`` per
    destination are dropped.  ``pad_to_multiple`` rounds ``k`` up.
    """
    dst = np.asarray(dst, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    if dst.size == 0:
        kk = max(k or 1, 1)
        kk = -(-kk // pad_to_multiple) * pad_to_multiple
        return PaddedCSR(
            idx=np.zeros((n_dst, kk), dtype=np.int32),
            mask=np.zeros((n_dst, kk), dtype=bool),
        )

    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    # position of each edge within its destination's block
    counts = np.bincount(dst_s, minlength=n_dst)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(dst_s.size) - offsets[dst_s]

    max_deg = int(counts.max()) if counts.size else 0
    if k is None:
        k = max(max_deg, 1)
    k = max(int(k), 1)
    width = -(-k // pad_to_multiple) * pad_to_multiple

    keep = pos < k
    idx = np.zeros((n_dst, width), dtype=np.int32)
    mask = np.zeros((n_dst, width), dtype=bool)
    idx[dst_s[keep], pos[keep]] = src_s[keep].astype(np.int32)
    mask[dst_s[keep], pos[keep]] = True
    return PaddedCSR(idx=idx, mask=mask)


def transpose_csr(
    csr: PaddedCSR, n_src: int, k: Optional[int] = None,
    pad_to_multiple: int = 1,
) -> PaddedCSR:
    """Transpose table: for each source node, the flat slot positions
    (dst * K + k) of the edges it feeds (host side).  Raises if ``k`` is
    below the max out-degree (a truncated table drops gradients)."""
    idx = np.asarray(csr.idx)
    mask = np.asarray(csr.mask)
    n_dst, kk = idx.shape
    flat_pos = np.arange(n_dst * kk, dtype=np.int64)[mask.ravel()]
    srcs = idx.ravel()[mask.ravel()].astype(np.int64)
    if k is not None and srcs.size:
        max_out = int(np.bincount(srcs, minlength=n_src).max())
        if k < max_out:
            raise ValueError(
                f"transpose width k={k} < max out-degree {max_out}: "
                "a truncated transpose table drops gradients"
            )
    return coo_to_padded_csr(
        srcs, flat_pos, n_dst=n_src, k=k,
        pad_to_multiple=pad_to_multiple,
    )


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def padded_csr_to_coo(csr: PaddedCSR) -> tuple:
    """Inverse of :func:`coo_to_padded_csr` (host side): ``(dst, src)``
    int64 arrays of the valid edges in row-major order.  A table of
    tensors is read back to the host first."""
    idx, mask = _host(csr.idx), _host(csr.mask)
    n_dst, k = idx.shape
    rows = np.repeat(np.arange(n_dst, dtype=np.int64), k).reshape(n_dst, k)
    return rows[mask], idx[mask].astype(np.int64)


def pad_rows(csr: PaddedCSR, n_dst: int) -> PaddedCSR:
    """The table padded to ``n_dst`` rows with all-invalid rows (host
    side); ``csr`` itself when it has that many rows already."""
    idx, mask = _host(csr.idx), _host(csr.mask)
    cur = idx.shape[0]
    if cur >= n_dst:
        return csr
    pad = ((0, n_dst - cur), (0, 0))
    return PaddedCSR(idx=np.pad(idx, pad), mask=np.pad(mask, pad))
