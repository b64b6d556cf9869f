"""Banded GATv2 edge stage, forward only: the host banding of a
locality-sorted neighbor table (:func:`band_graph`), the CUDA kernel
``csrc/attn_fwd.cu`` (entry ``sgt_banded_edge_stage``) and its plain
PyTorch version.

This is the port of ``segger_tpu/ops/pallas/banded.py``.  When the rows
are sorted so that each 256-row destination block's neighbors fall in one
4,096-row source window (strip-major order, ``data/partition.py::
_strip_major_order``), a block's table can hold window-local indices:
the global source of slot j of row i is ``lo[i // BLOCK] +
idx_local[i, j]``.  Over those sources the op computes the function of
``ops/gatv2_attn.py::gatv2_attention`` in float32.

The TPU kernel copied each block's whole window into a float32 VMEM
scratch, which is why it needed ``N_src >= WINDOW``; the CUDA kernel
stages only the rows that valid slots name, read through L2 (a window is
2 MiB at HC = 128, above the 227 KB of shared memory a block can have),
so it needs no padding of ``xl``.  As the TPU kernel's window was
float32, the op takes float32 only.

:func:`banded_edge_stage` launches the kernel for CUDA tensors (every
launch adds one to ``banded_edge_stage.launches``) and raises if it
cannot; for CPU tensors it runs :func:`banded_edge_stage_reference`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .gatv2_attn import (
    _F, _I, _P, attn_launch_config, check, gatv2_attention_reference,
    load_fn,
)
from .padded_csr import PaddedCSR
from .postgather import _vec_io, on_cuda

BLOCK = 256
WINDOW = 4096
K_BAND = WINDOW // BLOCK  # 16


def band_graph(
    csr: PaddedCSR, n_src: int
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray],
           bool]:
    """Host-side banding: per-block window starts and window-local
    indices.

    Returns ``(lo (N_pad/BLOCK,) int32, idx_local (N_pad, K_BAND) int32,
    mask (N_pad, K_BAND) bool, ok)`` with ``N_pad`` the rows rounded up to
    a multiple of ``BLOCK``.  ``ok`` is False, and the arrays None, when
    the table is wider than ``K_BAND`` or any block's neighbors span more
    than ``WINDOW`` rows.  Rows are assumed already locality-sorted."""
    idx = np.asarray(csr.idx)
    mask = np.asarray(csr.mask)
    n_dst, k = idx.shape
    if k > K_BAND:
        return None, None, None, False
    n_pad = -(-n_dst // BLOCK) * BLOCK
    idx_p = np.zeros((n_pad, K_BAND), np.int32)
    mask_p = np.zeros((n_pad, K_BAND), bool)
    idx_p[:n_dst, :k] = idx
    mask_p[:n_dst, :k] = mask
    n_blocks = n_pad // BLOCK

    lo = np.zeros(n_blocks, np.int32)
    max_lo = max(n_src - WINDOW, 0)
    for b in range(n_blocks):
        blk_idx = idx_p[b * BLOCK:(b + 1) * BLOCK]
        blk_mask = mask_p[b * BLOCK:(b + 1) * BLOCK]
        if blk_mask.any():
            smin = int(blk_idx[blk_mask].min())
            smax = int(blk_idx[blk_mask].max())
            if smax - smin + 1 > WINDOW:
                return None, None, None, False
            lo[b] = min(max(smin, 0), max_lo)
            if smax >= lo[b] + WINDOW:
                lo[b] = min(smax - WINDOW + 1, max_lo)
    local = idx_p - lo.repeat(BLOCK)[:, None]
    local = np.clip(local, 0, WINDOW - 1).astype(np.int32)
    return lo, local, mask_p, True


def _check_band(xl, xr, lo, idx_local, mask, att, bias, heads):
    att = check("banded_edge_stage", xl, xr, idx_local, mask, att, bias,
                heads, dtypes=(torch.float32,))
    n_pad, k = idx_local.shape
    if k != K_BAND or n_pad % BLOCK:
        raise ValueError(f"banded_edge_stage: idx_local must be (N_pad, "
                         f"{K_BAND}) with N_pad % {BLOCK} == 0, got "
                         f"{tuple(idx_local.shape)}")
    if lo.dtype != torch.int32 or tuple(lo.shape) != (n_pad // BLOCK,):
        raise ValueError(f"banded_edge_stage: lo must be ({n_pad // BLOCK},)"
                         f" int32, got {tuple(lo.shape)} {lo.dtype}")
    return att


def banded_edge_stage_reference(xl, xr, lo, idx_local, mask, att, bias,
                                heads: int, slope: float = 0.2):
    """Plain PyTorch version of the kernel: :func:`ops.gatv2_attn.
    gatv2_attention_reference` over the global sources ``lo[i // BLOCK] +
    idx_local[i, j]`` (clipped into ``[0, N_src)``).  Returns ``(N_pad,
    HC)`` float32, padded rows included."""
    att = _check_band(xl, xr, lo, idx_local, mask, att, bias, heads)
    glob = lo.long().repeat_interleave(BLOCK)[:, None] + idx_local.long()
    glob = glob.clamp(0, xl.shape[0] - 1).to(torch.int32)
    return gatv2_attention_reference(xl, xr, glob, mask, att, bias, heads,
                                     slope)


def banded_edge_stage(xl, xr, lo, idx_local, mask, att, bias, heads: int,
                      slope: float = 0.2):
    """Forward edge stage over a banded table (see :func:`band_graph`).

    xl (N_src, HC), xr (N_pad, HC), att (H, C) or (1, H, C), bias (HC,):
    float32.  lo (N_pad/BLOCK,) int32 window starts; idx_local (N_pad,
    K_BAND) int32 and mask (N_pad, K_BAND) bool; N_pad % BLOCK == 0.
    Returns ``out (N_pad, HC)`` float32; rows with no valid slot give the
    bias.

    CUDA tensors run the kernel; CPU tensors the plain version."""
    if xl.device.type == "cpu":
        return banded_edge_stage_reference(xl, xr, lo, idx_local, mask, att,
                                           bias, heads, slope)
    on_cuda("banded_edge_stage", xl, xr, lo, idx_local, mask, att, bias)
    att = _check_band(xl, xr, lo, idx_local, mask, att, bias, heads)
    xl, xr, att = xl.contiguous(), xr.contiguous(), att.contiguous()
    lo, idx_local = lo.contiguous(), idx_local.contiguous()
    mask, bias = mask.contiguous(), bias.contiguous()
    n_pad = idx_local.shape[0]
    hc = xl.shape[1]
    out = torch.empty((n_pad, hc), dtype=xl.dtype, device=xl.device)
    if n_pad == 0:
        return out
    cfg = attn_launch_config(n_pad, K_BAND, hc, heads, xl.dtype)
    vec_io = _vec_io(cfg, hc, xl, xr, out)
    fn = load_fn("sgt_banded_edge_stage",
                 [_P] * 7 + [_I] * 4 + [_F, _P] + [_I] * 9 + [_P])
    with torch.cuda.device(xl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                 bias.data_ptr(), lo.data_ptr(), idx_local.data_ptr(),
                 mask.data_ptr(), n_pad, xl.shape[0], heads, hc,
                 float(slope), out.data_ptr(), *cfg[:7], int(vec_io),
                 cfg.head_lanes if vec_io else 0, stream)
    if err:
        raise RuntimeError(f"banded_edge_stage kernel launch failed: "
                           f"CUDA error {err}")
    banded_edge_stage.launches += 1
    return out


banded_edge_stage.launches = 0
