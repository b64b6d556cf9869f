"""Sparse ops over the padded-CSR layout, and candidate scoring.

Row-wise masked reductions replace the scatter ops of the reference's hot
loop (torch_scatter / PyG segment ops).  Indices are clipped into range,
as ``jnp.take(..., mode="clip")`` does in the JAX package.
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
