"""Flat-layout GATv2 edge stage, forward: the plain reference of the
edge stage.

This is ``segger_tpu/ops/edge_stage.py::gatv2_edge_stage_flat`` in its
deterministic form, the path the JAX package takes off the TPU: every
intermediate, the softmax included, stays in the feature dtype.  In
bfloat16 that is not what the TPU kernel computes (it keeps softmax
statistics in float32); ``ops/postgather.py`` holds that arithmetic.

Math (per dst i, slot j, head h, channel c):
    g     = xl[idx]
    p     = g + xr[:, None]
    s     = leaky_relu(p)
    e     = sum_c s_hc * att_hc
    a     = masked softmax_j(e)
    out   = sum_j a_jh * g_jhc
"""
from __future__ import annotations

import torch

from .padded_csr import PaddedCSR

_NEG_INF = -1e30


def _att_blockdiag(att: torch.Tensor) -> torch.Tensor:
    """(H, C) attention vectors -> (H*C, H) block-diagonal matrix, so that
    ``s_flat @ A`` gives per-head logits."""
    heads, ch = att.shape
    eye = torch.eye(heads, dtype=att.dtype, device=att.device)
    return (att[:, :, None] * eye[:, None, :]).reshape(heads * ch, heads)


def gatv2_edge_stage_flat(xl, xr, att, csr: PaddedCSR, config: tuple):
    """xl (N_src, H*C), xr (N_dst, H*C), att (H, C) in one dtype;
    ``config = (heads, negative_slope)``.  Returns (N_dst, H*C)."""
    heads, slope = config
    n_dst, k = csr.idx.shape
    hc = xl.shape[-1]
    ch = hc // heads
    g = xl[csr.idx.reshape(-1).long().clamp(0, xl.shape[0] - 1)]
    p = g + torch.repeat_interleave(xr, k, dim=0)
    slope_t = torch.tensor(slope, dtype=xl.dtype, device=xl.device)
    s = torch.where(p > 0, p, slope_t * p)
    logits = s @ _att_blockdiag(att)                   # (N*K, H)
    m = csr.mask.reshape(n_dst * k, 1)
    z = torch.where(m, logits, _NEG_INF).reshape(n_dst, k, heads)
    z = z - z.amax(dim=1, keepdim=True)
    ez = torch.where(m.reshape(n_dst, k, 1), torch.exp(z), 0.0)
    alpha = (
        ez / ez.sum(dim=1, keepdim=True).clamp(min=1e-30)
    ).reshape(n_dst * k, heads)
    a_exp = torch.repeat_interleave(alpha, ch, dim=1)  # (N*K, HC)
    return (a_exp * g).reshape(n_dst, k, hc).sum(dim=1)
