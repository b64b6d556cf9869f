"""Deterministic GATv2 edge-stage forward: the CUDA kernel
``csrc/edge_stage_fwd.cu`` and its plain PyTorch version.

This is the port of ``segger_tpu/ops/pallas/postgather.py::
_fwd_kernel_nokeep``: for each destination row, the masked per-head
attention softmax over its K source slots and the attention-weighted sum
of the source rows.  The bias is added by the caller (``models/gatv2.py``),
as in the JAX package.

:func:`edge_stage_fwd` launches the kernel for CUDA tensors and raises if
it cannot; for CPU tensors it runs :func:`edge_stage_fwd_reference`, which
repeats the TPU kernel's arithmetic and rounding.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HC = 512


def _check(xl, xr, att, idx, mask, heads):
    hc = xl.shape[-1]
    if xl.dtype not in _DTYPES:
        raise TypeError(f"edge_stage_fwd: feature dtype {xl.dtype} "
                        "is not float32 or bfloat16")
    if xr.dtype != xl.dtype or att.dtype != xl.dtype:
        raise TypeError("edge_stage_fwd: xl, xr and att must share a dtype")
    if idx.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("edge_stage_fwd: idx must be int32, mask bool")
    if xl.dim() != 2 or xr.dim() != 2 or xr.shape[1] != hc:
        raise ValueError("edge_stage_fwd: xl (N_src, HC), xr (N, HC)")
    if idx.dim() != 2 or idx.shape != mask.shape \
            or idx.shape[0] != xr.shape[0] or idx.shape[1] < 1:
        raise ValueError("edge_stage_fwd: idx and mask must be (N, K>=1)")
    if heads < 1 or hc % heads or hc > MAX_HC or tuple(att.shape) != (
            heads, hc // heads):
        raise ValueError(
            f"edge_stage_fwd: needs H*C <= {MAX_HC}, H*C divisible by H "
            f"and att (H, C); got HC={hc}, H={heads}, att {tuple(att.shape)}"
        )
    if xl.shape[0] < 1:
        raise ValueError("edge_stage_fwd: empty source table")


def edge_stage_fwd_reference(xl, xr, att, idx, mask, heads: int,
                             negative_slope: float = 0.2):
    """Plain PyTorch version of the kernel, with the TPU kernel's
    rounding: ``p = g + xr`` and ``s = leaky(p)`` in the feature dtype
    (the slope rounded to it first), logits accumulated in float32,
    softmax statistics in float32, output accumulated in float32 and
    stored in the feature dtype.  Returns ``(out (N, HC), alpha (N, K, H)
    float32)``."""
    _check(xl, xr, att, idx, mask, heads)
    n, k = idx.shape
    hc = xl.shape[-1]
    ch = hc // heads
    g = xl[idx.long().clamp(0, xl.shape[0] - 1)]          # (N, K, HC)
    p = g + xr[:, None, :]
    slope = torch.tensor(negative_slope, dtype=xl.dtype, device=xl.device)
    s = torch.where(p > 0, p, slope * p)
    logits = (
        s.float().view(n, k, heads, ch) * att.float()
    ).sum(-1)                                             # (N, K, H) f32
    m = mask[..., None]
    z = torch.where(m, logits, _NEG_INF)
    z = z - z.amax(dim=1, keepdim=True)
    ez = torch.where(m, torch.exp(z), 0.0)
    alpha = ez / ez.sum(dim=1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum(
        "nkh,nkhc->nhc", alpha, g.float().view(n, k, heads, ch)
    ).reshape(n, hc)
    return out.to(xl.dtype), alpha


def _lib():
    lib = _build.load("edge_stage_fwd")
    fn = lib.sgt_edge_stage_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def edge_stage_fwd(xl, xr, att, idx, mask, heads: int,
                   negative_slope: float = 0.2):
    """Deterministic edge-stage forward.

    xl (N_src, HC), xr (N, HC), att (H, C): float32 or bfloat16, one
    dtype.  idx (N, K) int32 (clipped into [0, N_src)), mask (N, K) bool.
    Returns ``(out (N, HC) in the feature dtype, alpha (N, K, H)
    float32)``; rows with no valid slot give alpha = 0 and out = 0.

    CUDA tensors run the kernel (every launch adds one to
    ``edge_stage_fwd.launches``); CPU tensors run the plain version.
    """
    if xl.device.type == "cpu":
        return edge_stage_fwd_reference(xl, xr, att, idx, mask, heads,
                                        negative_slope)
    if xl.device.type != "cuda":
        raise ValueError(f"edge_stage_fwd: no kernel for {xl.device}")
    _check(xl, xr, att, idx, mask, heads)
    for t in (xr, att, idx, mask):
        if t.device != xl.device:
            raise ValueError("edge_stage_fwd: tensors on different devices")
    xl, xr, att = xl.contiguous(), xr.contiguous(), att.contiguous()
    idx, mask = idx.contiguous(), mask.contiguous()
    n, k = idx.shape
    hc = xl.shape[1]
    out = torch.empty((n, hc), dtype=xl.dtype, device=xl.device)
    alpha = torch.empty((n, k, heads), dtype=torch.float32,
                        device=xl.device)
    if n == 0:
        return out, alpha
    # the slope as the feature dtype holds it (JAX rounds the constant)
    slope = float(torch.tensor(negative_slope, dtype=xl.dtype))
    fn = _lib()
    with torch.cuda.device(xl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(), n, xl.shape[0], k, heads,
                 hc, slope, int(xl.dtype == torch.bfloat16),
                 out.data_ptr(), alpha.data_ptr(), stream)
    if err:
        raise RuntimeError(f"edge_stage_fwd kernel launch failed: "
                           f"CUDA error {err}")
    edge_stage_fwd.launches += 1
    return out, alpha


edge_stage_fwd.launches = 0
