"""Sparse ops over the padded-CSR layout, and candidate scoring.

Row-wise masked reductions replace the scatter ops of the reference's hot
loop (torch_scatter / PyG segment ops).  Indices are clipped into range,
as ``jnp.take(..., mode="clip")`` does in the JAX package.  The COO
segment ops, SpMM / SDDMM and the differentiable gathers are the JAX
package's public helpers; no main path calls them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .padded_csr import PaddedCSR
from .score import score_max

_NEG_INF = -1e30


def csr_gather(x_src: torch.Tensor, csr: PaddedCSR) -> torch.Tensor:
    """Source features per destination row: (N_src, F) -> (N_dst, K, F).
    Invalid slots gather an in-range row; callers mask."""
    return x_src[csr.idx.long().clamp(0, x_src.shape[0] - 1)]


def _slot_rows(x_src: torch.Tensor, csr: PaddedCSR) -> torch.Tensor:
    """:func:`csr_gather` through ``index_select``, whose backward adds
    the slots' cotangent rows with ``index_add_``.  The padded slots all
    name row 0, and the backward of plain indexing adds those duplicates
    one after another: 393.8 ms for ``csr_spmm``'s on phase 13's table
    of ``chip_smoke.py`` (NVIDIA H100 80GB HBM3, 700 W)."""
    idx = csr.idx.long().clamp(0, x_src.shape[0] - 1)
    return x_src.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *x_src.shape[1:])


def csr_spmm(x_src: torch.Tensor, csr: PaddedCSR,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-destination (weighted) neighbor sum of (N_src, F) rows:
    (N_dst, F), or (N_dst, H, F) for (N_dst, K, H) weights; ``weights``
    (N_dst, K) gives (N_dst, F).  Masked slots add nothing."""
    g = _slot_rows(x_src, csr)                       # (N_dst, K, F)
    m = csr.mask
    if weights is None:
        return torch.where(m[..., None], g, 0).sum(dim=1)
    dt = torch.promote_types(weights.dtype, g.dtype)
    g = g.to(dt)
    if weights.dim() == 2:
        w = torch.where(m, weights, 0).to(dt)
        return torch.matmul(w[:, None, :], g)[:, 0]
    w = torch.where(m[..., None], weights, 0).to(dt)
    return torch.matmul(w.transpose(1, 2), g)            # (N_dst, H, F)


def csr_sddmm(x_src: torch.Tensor, x_dst: torch.Tensor,
              csr: PaddedCSR) -> torch.Tensor:
    """Per-edge dot products ``x_dst[i] . x_src[j]``: (N_dst, K), zero on
    masked slots.  The float32 products are summed in float64 and
    rounded once, so the result does not hang on the order of the sum
    (a CUDA and a CPU run agree within one rounding)."""
    prod = _slot_rows(x_src, csr).float() * x_dst.float()[:, None, :]
    e = prod.sum(dim=-1, dtype=torch.float64).to(x_dst.dtype)
    return torch.where(csr.mask, e, 0)


def row_gather_1d(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``table[pos]`` for a 1-D table of m entries, 0 where ``pos`` lies
    outside [0, m).

    The JAX package gathers 128-wide rows of the table padded to a
    multiple of 128 (a TPU workaround), which gives the same values for
    ``pos`` in [0, ceil(m / 128) * 128): the table, then 0 in the pad.
    Elsewhere it differs, and the port does not follow it: at ``pos`` past
    the pad JAX gives NaN for a float table (the lowest value for a
    signed integer one), and a negative ``pos`` wraps by whole 128-wide
    rows from the end."""
    m = table.shape[0]
    if m == 0:
        return table.new_zeros(pos.shape)
    inside = (pos >= 0) & (pos < m)
    return torch.where(inside, table[pos.long().clamp(0, m - 1)], 0)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        grad = g.new_zeros((ctx.n, *g.shape[1:]))
        return grad.index_add_(0, idx.long(), g), None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``x[idx]`` (``idx`` in [0, N)) whose backward is the
    segment sum of the cotangent rows per source row, in the cotangent's
    dtype; rows nothing gathers get 0.  The JAX package sums by sort,
    cumsum and searchsorted, since scatters serialise on a TPU; here it is
    ``index_add_``."""
    return _TakeRows.apply(x, idx)


def _trailing(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``m`` with ones appended to its shape up to ``like``'s rank."""
    return m.reshape(*m.shape, *[1] * (like.dim() - m.dim()))


class _CsrGatherT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_src, idx, mask, t_idx, t_mask):
        ctx.save_for_backward(mask, t_idx, t_mask)
        return csr_gather(x_src, PaddedCSR(idx, mask))

    @staticmethod
    def backward(ctx, g):
        mask, t_idx, t_mask = ctx.saved_tensors
        n_dst, k = mask.shape
        flat = torch.where(_trailing(mask, g), g, 0).reshape(
            n_dst * k, *g.shape[2:])
        rows = flat[t_idx.long().clamp(0, n_dst * k - 1)]   # (N_src, K_T, ..)
        grad = torch.where(_trailing(t_mask, rows), rows, 0).sum(dim=1)
        return grad, None, None, None, None


def csr_gather_t(x_src: torch.Tensor, csr: PaddedCSR,
                 csr_t: PaddedCSR) -> torch.Tensor:
    """:func:`csr_gather` whose backward gathers the cotangent through
    the transpose table ``csr_t`` (``padded_csr.transpose_csr``: per
    source row, the flat ``dst * K + slot`` positions it feeds) and sums
    each source row's valid slots, in the cotangent's dtype: no scatter.
    The cotangent of masked slots is dropped.  Any trailing shape."""
    return _CsrGatherT.apply(x_src, csr.idx, csr.mask, csr_t.idx,
                             csr_t.mask)


def _ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The ids as int64, those outside [0, num_segments) moved to an
    extra segment ``num_segments`` that the callers drop."""
    ids = segment_ids.long()
    inside = (ids >= 0) & (ids < num_segments)
    return torch.where(inside, ids, num_segments)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """COO segment sum, as ``jax.ops.segment_sum``: (num_segments,
    ...) with 0 for an empty segment; rows whose id lies outside [0,
    num_segments) are dropped."""
    out = data.new_zeros((num_segments + 1, *data.shape[1:]))
    return out.index_add(0, _ids(segment_ids, num_segments), data)[:-1]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """COO segment max, as ``jax.ops.segment_max``: -inf for an empty
    segment of floats, the type's lowest value for integers; rows whose
    id lies outside [0, num_segments) are dropped."""
    low = (-torch.inf if data.is_floating_point()
           else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments + 1, *data.shape[1:]), low)
    ids = _trailing(_ids(segment_ids, num_segments), data).expand_as(data)
    return out.scatter_reduce(0, ids, data, "amax")[:-1]


def _jax_gather_ids(segment_ids: torch.Tensor, n: int) -> torch.Tensor:
    """The rows a JAX gather ``x[ids]`` of n rows reads: a negative id
    counts from the end, then every id is clamped into [0, n)."""
    ids = segment_ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """COO segment softmax (the reference's PyG softmax), as the JAX
    package computes it: a segment's non-finite max counts as 0 and its
    denominator is clamped at 1e-30, so a -inf logit alone in its segment
    gives 0.  An id outside [0, num_segments) adds to no segment and
    reads the statistics of the segment JAX's clamped gather reads."""
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0)
    at = _jax_gather_ids(segment_ids, num_segments)
    z = torch.exp(logits - seg_max[at])
    denom = segment_sum(z, segment_ids, num_segments)
    return z / denom[at].clamp(min=1e-30)


def csr_softmax(logits: torch.Tensor, csr: PaddedCSR) -> torch.Tensor:
    """Masked softmax across each destination row of (N_dst, K) or
    (N_dst, K, H) logits; rows with no valid edge give all-zero
    weights."""
    m = csr.mask if logits.dim() == 2 else csr.mask[..., None]
    z = torch.where(m, logits, _NEG_INF)
    z = z - z.amax(dim=1, keepdim=True)
    ez = torch.where(m, torch.exp(z), 0.0)
    return ez / ez.sum(dim=1, keepdim=True).clamp(min=1e-30)


def csr_max(values: torch.Tensor, csr: PaddedCSR):
    """Masked row max and argmax over (N_dst, K) values: the padded-CSR
    form of scatter_max.  Returns ``(max (N_dst,), arg (N_dst,) int32)``
    where ``arg`` is the ``csr.idx`` entry of the first maximal slot, and
    ``(-1e30, -1)`` for rows with no valid slot."""
    z = torch.where(csr.mask, values, _NEG_INF)
    max_val, slot = z.max(dim=1)   # first maximal slot
    picked = csr.idx.gather(1, slot[:, None])[:, 0]
    arg = torch.where(csr.mask.any(dim=1), picked, -1)
    return max_val, arg.to(torch.int32)


def score_candidates(
    emb_tx: torch.Tensor,
    bd_feats: torch.Tensor,
    cand: PaddedCSR,
    bd_index: torch.Tensor,
    dtype: Optional[torch.dtype] = None,
    normalized: bool = False,
):
    """Cosine-score tx->bd candidate edges and take each transcript's
    best candidate: the reference's predict-step similarity +
    scatter_max.

    ``dtype`` (e.g. bfloat16) is the type the rows are gathered in;
    norms and cosines accumulate in float32.  ``normalized``: the rows
    are unit vectors already, so the cosine is the dot product.
    Returns ``(max_sim float32, cell_encoding int32)`` with -1 for
    transcripts without candidates.
    """
    if dtype is not None:
        bd_feats = bd_feats.to(dtype)
        emb_tx = emb_tx.to(dtype)
    if normalized:
        bdn, txn = bd_feats, emb_tx
    else:
        def unit(x):
            x32 = x.float()
            inv = torch.rsqrt((x32 * x32).sum(-1, keepdim=True).clamp(
                min=1e-16))
            return (x32 * inv).to(x.dtype)

        bdn, txn = unit(bd_feats), unit(emb_tx)
    max_sim, slot = score_max(txn, bdn, cand.idx, cand.mask)
    picked = cand.idx.gather(1, slot.clamp(min=0).long()[:, None])[:, 0]
    seg = torch.where(slot >= 0, bd_index[picked.long()], -1)
    return max_sim, seg.to(torch.int32)
