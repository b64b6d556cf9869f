"""Candidate scoring: the CUDA kernel ``csrc/score.cu`` and its plain
PyTorch version.

This is the port of ``segger_tpu/ops/pallas/score.py::_score_kernel``
(``score_max_pallas``): for each transcript row, the float32 dot product
with each of its K candidate rows, the masked max and the first maximal
slot, and ``(-1e30, -1)`` for rows without candidates.  The
slot -> ``cand.idx`` -> ``bd_index`` map stays with the caller
(``ops/gather_agg.py::score_candidates``).

:func:`score_max` launches the kernel for CUDA tensors and raises if it
cannot; for CPU tensors it runs :func:`score_max_reference`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
MAX_F = 512


def _check(tx, bd, idx, mask):
    if tx.dtype not in _DTYPES or bd.dtype != tx.dtype:
        raise TypeError("score_max: tx and bd must share a float32 or "
                        "bfloat16 dtype")
    if idx.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("score_max: idx must be int32, mask bool")
    if tx.dim() != 2 or bd.dim() != 2 or bd.shape[1] != tx.shape[1] \
            or not 0 < tx.shape[1] <= MAX_F:
        raise ValueError(f"score_max: tx (N, F), bd (N_bd, F), "
                         f"0 < F <= {MAX_F}")
    if idx.dim() != 2 or idx.shape != mask.shape \
            or idx.shape[0] != tx.shape[0] or idx.shape[1] < 1:
        raise ValueError("score_max: idx and mask must be (N, K>=1)")
    if bd.shape[0] < 1:
        raise ValueError("score_max: empty candidate table")


def score_max_reference(tx, bd, idx, mask):
    """Plain PyTorch version of the kernel: float32 products and sums,
    masked max, first maximal slot.  Returns ``(max (N,) float32,
    slot (N,) int32)``."""
    _check(tx, bd, idx, mask)
    k = idx.shape[1]
    g = bd[idx.long().clamp(0, bd.shape[0] - 1)].float()   # (N, K, F)
    cos = (g * tx.float()[:, None, :]).sum(-1)
    z = torch.where(mask, cos, _NEG_INF)
    maxv = z.amax(dim=1)
    iota = torch.arange(k, device=tx.device)
    slot = torch.where(z == maxv[:, None], iota, k).amin(dim=1)
    slot = torch.where(mask.any(dim=1), slot, -1)
    return maxv, slot.to(torch.int32)


def _lib():
    lib = _build.load("score")
    fn = lib.sgt_score_max
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def score_max(tx, bd, idx, mask):
    """Masked max dot product and its first slot over candidate rows.

    tx (N, F) and bd (N_bd, F): float32 or bfloat16, one dtype (unit rows
    make it a cosine).  idx (N, K) int32 rows of ``bd`` (clipped into
    range), mask (N, K) bool.  Returns ``(max (N,) float32, slot (N,)
    int32)`` with ``(-1e30, -1)`` for rows without a valid slot.

    CUDA tensors run the kernel (every launch adds one to
    ``score_max.launches``); CPU tensors run the plain version.
    """
    if tx.device.type == "cpu":
        return score_max_reference(tx, bd, idx, mask)
    if tx.device.type != "cuda":
        raise ValueError(f"score_max: no kernel for {tx.device}")
    _check(tx, bd, idx, mask)
    for t in (bd, idx, mask):
        if t.device != tx.device:
            raise ValueError("score_max: tensors on different devices")
    tx, bd = tx.contiguous(), bd.contiguous()
    idx, mask = idx.contiguous(), mask.contiguous()
    n, k = idx.shape
    maxv = torch.empty(n, dtype=torch.float32, device=tx.device)
    slot = torch.empty(n, dtype=torch.int32, device=tx.device)
    if n == 0:
        return maxv, slot
    fn = _lib()
    with torch.cuda.device(tx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tx.data_ptr(), bd.data_ptr(), idx.data_ptr(),
                 mask.data_ptr(), n, bd.shape[0], k, tx.shape[1],
                 int(tx.dtype == torch.bfloat16), maxv.data_ptr(),
                 slot.data_ptr(), stream)
    if err:
        raise RuntimeError(f"score_max kernel launch failed: CUDA error {err}")
    score_max.launches += 1
    return maxv, slot


score_max.launches = 0
