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
from typing import NamedTuple

import torch

from . import _build
from .postgather import _pow2, on_cuda

_NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
MAX_F = 512
_THREADS = 128       # threads a block
_BATCH_WORDS = 32    # gathered chunk words a lane holds at once


class ScoreLaunch(NamedTuple):
    """Launch configuration of ``score.cu``: ``lanes`` per row, each
    holding ``nv`` chunks of ``chunk_bytes``; ``slot_batch`` candidate
    rows gathered at once; ``rows`` per block; ``n_blocks`` blocks; and
    ``vec``: rows move as chunk vectors (else element by element, in the
    same layout)."""
    lanes: int
    chunk_bytes: int
    nv: int
    slot_batch: int
    rows: int
    n_blocks: int
    vec: bool


def _slot_batch(chunk_bytes: int, nv: int) -> int:
    """The candidate rows a lane gathers at once: 32 chunk words in all,
    at least 1 and at most 8 rows (``score.cu::slot_batch``)."""
    return min(8, max(1, _BATCH_WORDS // (chunk_bytes // 4 * nv)))


def score_launch_config(n: int, k: int, f: int, dtype, tx_ptr: int = 0,
                        bd_ptr: int = 0) -> ScoreLaunch:
    """The scoring kernel's layout for an (N, K) candidate table of F-wide
    rows in ``dtype`` whose tx and bd tables start at ``tx_ptr`` and
    ``bd_ptr``.  A row is cut into chunks of 16 bytes (rows of 128 bytes
    or more) or 8 over the fewest power-of-two lanes (at most 32) that
    cover it with two chunks a lane, then into the fewest power-of-two
    chunks a lane; a block of 128 threads serves 128 / lanes rows.  At
    F = 64 in bf16: 4 lanes of two 16-byte chunks, 4 slots a batch, 32
    rows a block.  On an H100 80GB HBM3 at 700 W (``tools/bwd_device_ms.py
    --kernel score``) that took 0.0066 ms at N = 50,000, K = 4, where one
    chunk a lane (8 lanes) took 0.0087 and 8-byte chunks (16 lanes)
    0.0194: the fewer lanes a row, the fewer instructions it spends on its
    idx, ballot and butterflies.  Four chunks a lane (2 lanes) took
    0.0083-0.0096: a round of idx then covers only 2 slots.  The layout,
    and with it the kernel's summation order, follows F and ``dtype``
    alone, never N, K or the pointers; rows that are not whole chunks, or
    tables that do not start on a chunk, move element by element (``vec``
    False) in the same layout."""
    size = 2 if dtype == torch.bfloat16 else 4
    chunk_bytes = 16 if f * size >= 128 else 8
    chunks = -(-f * size // chunk_bytes)
    lanes = min(32, _pow2(-(-chunks // 2)))
    nv = _pow2(-(-chunks // lanes))
    rows = _THREADS // lanes
    vec = (f * size % chunk_bytes == 0 and tx_ptr % chunk_bytes == 0
           and bd_ptr % chunk_bytes == 0)
    return ScoreLaunch(lanes, chunk_bytes, nv, _slot_batch(chunk_bytes, nv),
                       rows, -(-n // rows), vec)


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
            ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    on_cuda("score_max", tx, bd, idx, mask)
    _check(tx, bd, idx, mask)
    tx, bd = tx.contiguous(), bd.contiguous()
    idx, mask = idx.contiguous(), mask.contiguous()
    n, k = idx.shape
    maxv = torch.empty(n, dtype=torch.float32, device=tx.device)
    slot = torch.empty(n, dtype=torch.int32, device=tx.device)
    if n == 0:
        return maxv, slot
    cfg = score_launch_config(n, k, tx.shape[1], tx.dtype, tx.data_ptr(),
                              bd.data_ptr())
    fn = _lib()
    with torch.cuda.device(tx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tx.data_ptr(), bd.data_ptr(), idx.data_ptr(),
                 mask.data_ptr(), n, bd.shape[0], k, tx.shape[1],
                 int(tx.dtype == torch.bfloat16), maxv.data_ptr(),
                 slot.data_ptr(), *cfg[:6], int(cfg.vec), stream)
    if err:
        raise RuntimeError(f"score_max kernel launch failed: CUDA error {err}")
    score_max.launches += 1
    return maxv, slot


score_max.launches = 0
