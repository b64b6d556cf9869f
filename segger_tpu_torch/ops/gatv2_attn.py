"""Fused GATv2 edge attention + aggregation, forward only: the CUDA kernel
``csrc/attn_fwd.cu`` (entry ``sgt_gatv2_attention``) and its plain PyTorch
version.

This is the port of ``segger_tpu/ops/pallas/gatv2_attn.py``: for each
destination row i, over its K source slots,

    s_ijh   = leaky_relu(xl[idx[i,j]] + xr[i])
    e_ijh   = sum_c s_ijhc * att[h,c]
    alpha   = masked softmax_j(e_ijh)
    out_ihc = sum_j alpha_ijh * xl[idx[i,j]]_hc + bias

Unlike the edge stage of ``ops/postgather.py`` (K1), which keeps float32
softmax statistics and returns ``alpha``, this op computes in the feature
dtype throughout, as the TPU kernel does: in bfloat16, ``s``, each
product ``s * att``, each head's logit, ``z = e - max``, ``exp(z)``, the
sum and ``alpha`` are rounded to bfloat16; only the weighted sum
accumulates in float32, to which the float32 bias is added before the
output is rounded to the feature dtype.  Rows with no valid slot give the
bias.  The TPU kernel's source table sat in VMEM under an 8 MB budget
(``fits_vmem``); the CUDA kernel reads it from device memory through L2,
so the port has no such gate.

:func:`gatv2_attention` launches the kernel for CUDA tensors (every
launch adds one to ``gatv2_attention.launches``) and raises if it cannot;
for CPU tensors it runs :func:`gatv2_attention_reference`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .postgather import (
    MAX_HC, SMEM_8_BLOCKS, EdgeLaunch, _launch_config, _vec_io, dtype_slope,
    on_cuda,
)

_NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def attn_launch_config(n: int, k: int, hc: int, heads: int,
                       dtype) -> EdgeLaunch:
    """The attention kernel's launch configuration (``attn_fwd.cu``, both
    entry points) for an (N, K) table of HC-wide rows with H heads in
    ``dtype``, cut as the edge-stage kernels cut a row
    (``postgather._launch_config``): the staged slots share shared memory
    with each row's logits, which become alpha (K*H float32), and its
    valid slots' source rows (K int32).  There is no alpha output and no
    keep multiplier.  The row's layout (lanes, chunk bytes, chunks a lane,
    lanes a head) follows HC, H and ``dtype`` alone, never N or K: rows
    of 256 bytes or more take 16-byte chunks, shorter rows the shared cut.
    So :func:`head_logits` repeats the kernel's summation order from the
    row's shape.

    A block stages at most as many slots of each row as keep eight blocks
    on an SM (:data:`SMEM_8_BLOCKS`): every slot up to K = 12 at HC = 128,
    13 of the slide table's 16 in f32.  A row with more valid slots takes
    them in chunks.  On an H100 the slide table (about 5 valid slots a
    row) took 20 % longer with all 16 staged (six blocks an SM) than with
    8, and K = 12 took 15-20 % longer with 8 staged than with all 12."""
    size = 2 if dtype == torch.bfloat16 else 4
    cfg = _launch_config("gatv2_attention", n, k, hc, heads, dtype,
                         lambda hc_pad: k * heads * 4 + k * 4,
                         wide=hc * size >= 256)
    per_slot = cfg.rows * cfg.lanes * cfg.nv * cfg.chunk_bytes
    fixed = cfg.smem_bytes - cfg.slots * per_slot
    slots = min(cfg.slots, max(1, (SMEM_8_BLOCKS - fixed) // per_slot))
    return cfg._replace(slots=slots, smem_bytes=fixed + slots * per_slot)


def head_logits(prod: torch.Tensor, heads: int, lanes: int,
                vec: int) -> torch.Tensor:
    """(N, K, HC) float32 products -> (N, K, H) float32 per-head sums,
    added in the kernel's order for a row of ``lanes`` lanes holding
    chunks of ``vec`` channels (:func:`attn_launch_config`): channel c
    lies in chunk ``c // (lanes * vec)`` of lane ``(c // vec) % lanes``;
    each lane adds its channels of the head to 0, chunk by chunk and
    channel by channel, then a butterfly over the lanes (offsets
    ``lanes/2, ..., 1``) adds the lanes' sums.  In bfloat16 the sum is
    rounded once and then exponentiated, so a different order could move
    a logit by one bf16 step (up to 6 % in exp at |e| ~ 10); this fixed
    order keeps the kernel and its plain version on the same bf16 logit.
    """
    n, k, hc = prod.shape
    span = lanes * vec
    nv = -(-hc // span)
    ch = hc // heads
    p = F.pad(prod, (0, nv * span - hc)).view(n, k, nv, lanes, vec)
    c = torch.arange(nv * span, device=prod.device).view(nv, lanes, vec)
    head = torch.where(c < hc, c // ch, -1)
    out = []
    for h in range(heads):
        # (N, K, lanes, nv * vec): each lane's channels in its order
        ph = torch.where(head == h, p, 0.0).transpose(2, 3).reshape(
            n, k, lanes, nv * vec)
        part = ph[..., 0]
        for i in range(1, nv * vec):
            part = part + ph[..., i]
        w = lanes
        while w > 1:
            w //= 2
            part = part[..., :w] + part[..., w:2 * w]
        out.append(part[..., 0])
    return torch.stack(out, dim=-1)


def check(name, xl, xr, idx, mask, att, bias, heads, dtypes=_DTYPES):
    """Shapes and types of the attention ops; returns ``att`` as (H, C)."""
    hc = xl.shape[-1] if xl.dim() == 2 else -1
    if xl.dtype not in dtypes:
        raise TypeError(f"{name}: feature dtype {xl.dtype} is not one of "
                        f"{dtypes}")
    if xr.dtype != xl.dtype or att.dtype != xl.dtype:
        raise TypeError(f"{name}: xl, xr and att must share a dtype")
    if bias.dtype not in (torch.float32, xl.dtype):
        raise TypeError(f"{name}: bias must be float32 or the feature dtype")
    if idx.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError(f"{name}: idx must be int32, mask bool")
    if xl.dim() != 2 or xr.dim() != 2 or xr.shape[1] != hc \
            or tuple(bias.shape) != (hc,):
        raise ValueError(f"{name}: xl (N_src, HC), xr (N, HC), bias (HC,)")
    if idx.dim() != 2 or idx.shape != mask.shape \
            or idx.shape[0] != xr.shape[0] or idx.shape[1] < 1:
        raise ValueError(f"{name}: idx and mask must be (N, K>=1)")
    if heads < 1 or hc % heads or hc > MAX_HC \
            or att.numel() != hc or att.shape[-1] != hc // heads:
        raise ValueError(
            f"{name}: needs H*C <= {MAX_HC}, H*C divisible by H and att "
            f"(H, C) or (1, H, C); got HC={hc}, H={heads}, att "
            f"{tuple(att.shape)}")
    if xl.shape[0] < 1:
        raise ValueError(f"{name}: empty source table")
    return att.reshape(heads, hc // heads)


def gatv2_attention_reference(xl, xr, idx, mask, att, bias, heads: int,
                              negative_slope: float = 0.2):
    """Plain PyTorch version of the kernel, with the TPU kernel's rounding
    (module docstring); indices are clipped into ``[0, N_src)``.  Returns
    ``out (N, HC)`` in the feature dtype."""
    att = check("gatv2_attention", xl, xr, idx, mask, att, bias, heads)
    dt = xl.dtype
    n, k = idx.shape
    hc = xl.shape[-1]
    ch = hc // heads
    g = xl[idx.long().clamp(0, xl.shape[0] - 1)]           # (N, K, HC)
    s = g + xr[:, None, :]
    slope = torch.tensor(negative_slope, dtype=dt, device=xl.device)
    s = torch.where(s > 0, s, slope * s)
    prod = (s.view(n, k, heads, ch) * att).view(n, k, hc)   # rounded to dt
    cfg = attn_launch_config(1, 1, hc, heads, dt)
    logits = head_logits(prod.float(), heads, cfg.lanes,
                         cfg.chunk_bytes // xl.element_size()).to(dt)
    m = mask[..., None]
    z = torch.where(m, logits, _NEG_INF)
    z = z - z.amax(dim=1, keepdim=True)
    ez = torch.where(m, torch.exp(z), 0.0)
    alpha = ez / ez.sum(dim=1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("nkh,nkhc->nhc", alpha.float(),
                       g.float().view(n, k, heads, ch)).reshape(n, hc)
    return (out + bias.float()).to(dt)


def load_fn(symbol: str, argtypes):
    """The C entry ``symbol`` of ``attn_fwd.cu``, built at first use."""
    fn = getattr(_build.load("attn_fwd"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def gatv2_attention(xl, xr, idx, mask, att, bias, heads: int,
                    negative_slope: float = 0.2):
    """Fused edge attention + aggregation, forward only.

    xl (N_src, HC), xr (N, HC), att (H, C) or (1, H, C): float32 or
    bfloat16, one dtype; bias (HC,) float32 or that dtype.  idx (N, K)
    int32 (clipped into ``[0, N_src)``), mask (N, K) bool; any K, HC <=
    512 divisible by H.  Returns ``out (N, HC)`` in the feature dtype.

    CUDA tensors run the kernel; CPU tensors the plain version."""
    if xl.device.type == "cpu":
        return gatv2_attention_reference(xl, xr, idx, mask, att, bias, heads,
                                         negative_slope)
    on_cuda("gatv2_attention", xl, xr, idx, mask, att, bias)
    att = check("gatv2_attention", xl, xr, idx, mask, att, bias, heads)
    xl, xr, att = xl.contiguous(), xr.contiguous(), att.contiguous()
    idx, mask = idx.contiguous(), mask.contiguous()
    bias = bias.float().contiguous()
    n, k = idx.shape
    hc = xl.shape[1]
    out = torch.empty((n, hc), dtype=xl.dtype, device=xl.device)
    if n == 0:
        return out
    cfg = attn_launch_config(n, k, hc, heads, xl.dtype)
    vec_io = _vec_io(cfg, hc, xl, xr, out)
    fn = load_fn("sgt_gatv2_attention",
                 [_P] * 6 + [_I] * 5 + [_F, _I, _P] + [_I] * 9 + [_P])
    with torch.cuda.device(xl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                 bias.data_ptr(), idx.data_ptr(), mask.data_ptr(), n,
                 xl.shape[0], k, heads, hc,
                 dtype_slope(negative_slope, xl.dtype),
                 int(xl.dtype == torch.bfloat16), out.data_ptr(), *cfg[:7],
                 int(vec_io), cfg.head_lanes if vec_io else 0, stream)
    if err:
        raise RuntimeError(f"gatv2_attention kernel launch failed: "
                           f"CUDA error {err}")
    gatv2_attention.launches += 1
    return out


gatv2_attention.launches = 0
