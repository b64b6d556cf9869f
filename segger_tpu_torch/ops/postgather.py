"""GATv2 edge stage, forward and backward: the CUDA kernels
``csrc/edge_stage_fwd.cu`` and ``csrc/edge_stage_bwd.cu``, their plain
PyTorch versions, and the autograd function that joins them.

This is the port of ``segger_tpu/ops/pallas/postgather.py``: for each
destination row, the masked per-head attention softmax over its K source
slots and the attention-weighted sum of the source rows (forward), and the
gradients of ``xl``, ``xr``, ``att`` and the keep multipliers from the
stored softmax coefficients (backward).  The bias is added by the caller
(``models/gatv2.py``), as in the JAX package.

Dropout has the JAX package's three modes:

- ``nokeep``: no dropout (``seed=None``, ``keep=None``);
- ``prng``: keep multipliers hashed from two 32-bit seed words and the
  flat position ``row*K*H + slot*H + head`` (``seed=(s0, s1)`` or a
  ``(2,)`` int32 tensor of the words, with ``rate``), bit for bit the
  stream of ``_prng_keep``.  The kernels read the words from device
  memory, as the TPU kernels read theirs from a ref, so a captured CUDA
  graph draws a fresh mask whenever new words are written into the
  tensor before a replay;
- ``keep``: multipliers read from an ``(N, K, H)`` tensor (``keep=``).

:func:`edge_stage_fwd` and :func:`edge_stage_bwd` launch their kernel for
CUDA tensors and raise if they cannot; for CPU tensors they run
:func:`edge_stage_fwd_reference` and :func:`edge_stage_bwd_reference`,
which repeat the TPU kernels' arithmetic and rounding.  Each wrapper
counts its launches per mode in ``.launches`` (a dict).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import _build

_NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HC = 512
MODES = ("nokeep", "prng", "keep")
SMEM_MAX = 232_448       # dynamic shared memory one block may use (H100)
_THREADS = 128           # threads a block of either edge-stage kernel
# blocks of the kernels' grid-stride loops (and the backward's datt
# partials): a count fixed by N alone, so the partial sums, and the
# result, repeat
_ROWS_PER_BLOCK = 4
_MAX_BLOCKS = 4096
# dynamic shared bytes a block may use while eight blocks (the forward
# kernels' __launch_bounds__) share an SM's 233,472, 1 KB each kept
SMEM_8_BLOCKS = 233_472 // 8 - 1024
# the forward's 16-byte chunks on 256-byte rows: from this many rows, and
# while eight blocks share an SM
_WIDE_MIN_ROWS = 2048

# two 32-bit seed words: ints, or a (2,) int32 tensor of their bit
# patterns
Seed = Optional[Union[Sequence[int], torch.Tensor]]


def _mode(seed: Seed, keep) -> str:
    if seed is not None and keep is not None:
        raise ValueError("edge stage: pass a seed or a keep tensor, not both")
    return "prng" if seed is not None else (
        "nokeep" if keep is None else "keep")


def prng_config(rate: float) -> Tuple[int, float]:
    """``(inclusive threshold, multiplier)`` of the hashed dropout, as
    ``postgather.py::_prng_config``: keep iff ``bits & 0x7FFFFFFF <=
    thresh``, so rate 0 keeps everything."""
    keep_p = 1.0 - rate
    if not 0.0 < keep_p <= 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    thresh = min(int(round(keep_p * 2**31)), 2**31) - 1
    return thresh, float(torch.tensor(1.0 / keep_p, dtype=torch.float32))


def seed_words(seed):
    """Two seed words as unsigned 32-bit values: ints for ints, 0-d int64
    tensors (on the seed's device) for a tensor of words."""
    if len(seed) != 2:
        raise ValueError(f"edge stage: seed needs two words, got {seed}")
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32:
            raise TypeError("edge stage: a seed tensor must be int32")
        w = seed.long() & 0xFFFFFFFF
        return w[0], w[1]
    return int(seed[0]) & 0xFFFFFFFF, int(seed[1]) & 0xFFFFFFFF


def seed_tensor(seed, device) -> torch.Tensor:
    """The two seed words as the (2,) int32 tensor on ``device`` that the
    kernels read: a seed tensor as it is (checked), ints as their bit
    patterns."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.shape != (2,) \
                or seed.device != device:
            raise ValueError(f"edge stage: the seed tensor must be (2,) "
                             f"int32 on {device}")
        return seed.contiguous()
    return torch.tensor(seed_int32(seed), dtype=torch.int32, device=device)


def seed_int32(seed: Sequence[int]) -> Tuple[int, int]:
    """Two seed words as the int32 values of their bit patterns, as a
    seed tensor holds them."""
    s0, s1 = (w - (1 << 32) if w >= 1 << 31 else w for w in seed_words(seed))
    return s0, s1


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    m = 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & m
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & m
    return x ^ (x >> 16)


def prng_hash(pos: torch.Tensor, seed) -> torch.Tensor:
    """The 32-bit hash of flat positions (any integer tensor, taken
    modulo 2^32) under the seed words (ints or a tensor of words on
    ``pos``'s device), as int64 in [0, 2^32)."""
    s0, s1 = seed_words(seed)
    m = 0xFFFFFFFF
    x = _fmix32((pos.long() & m) ^ s0)
    return _fmix32(x ^ ((s1 + 0x9E3779B9) & m))


def prng_keep_reference(seed, n: int, k: int, heads: int,
                        rate: float, device="cpu") -> torch.Tensor:
    """``(n, k, heads)`` float32 dropout multipliers of the hashed stream
    (``postgather.py::_prng_keep`` over a whole table)."""
    thresh, inv_keep = prng_config(rate)
    pos = torch.arange(n * k * heads, dtype=torch.int64,
                       device=device).view(n, k, heads)
    if isinstance(seed, torch.Tensor):
        seed = seed.to(pos.device)
    bits = prng_hash(pos, seed) & 0x7FFFFFFF
    return torch.where(bits <= thresh, inv_keep, 0.0).float()


def _check(xl, xr, att, idx, mask, heads, keep=None):
    hc = xl.shape[-1]
    if xl.dtype not in _DTYPES:
        raise TypeError(f"edge stage: feature dtype {xl.dtype} "
                        "is not float32 or bfloat16")
    if xr.dtype != xl.dtype or att.dtype != xl.dtype:
        raise TypeError("edge stage: xl, xr and att must share a dtype")
    if idx.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("edge stage: idx must be int32, mask bool")
    if xl.dim() != 2 or xr.dim() != 2 or xr.shape[1] != hc:
        raise ValueError("edge stage: xl (N_src, HC), xr (N, HC)")
    if idx.dim() != 2 or idx.shape != mask.shape \
            or idx.shape[0] != xr.shape[0] or idx.shape[1] < 1:
        raise ValueError("edge stage: idx and mask must be (N, K>=1)")
    if heads < 1 or hc % heads or hc > MAX_HC or tuple(att.shape) != (
            heads, hc // heads):
        raise ValueError(
            f"edge stage: needs H*C <= {MAX_HC}, H*C divisible by H "
            f"and att (H, C); got HC={hc}, H={heads}, att {tuple(att.shape)}"
        )
    if xl.shape[0] < 1:
        raise ValueError("edge stage: empty source table")
    if keep is not None and tuple(keep.shape) != (*idx.shape, heads):
        raise ValueError(f"edge stage: keep must be (N, K, H), got "
                         f"{tuple(keep.shape)}")


def _keep_c(mode, keep, seed, rate, n, k, heads, dtype, device):
    """The (N, K, H) float32 multipliers the kernels use: the keep tensor
    rounded to the feature dtype (as the TPU kernels read it), the hashed
    stream, or None."""
    if mode == "keep":
        return keep.to(dtype).float()
    if mode == "prng":
        return prng_keep_reference(seed, n, k, heads, rate, device)
    return None


def dtype_slope(negative_slope, dtype) -> float:
    """The slope as the feature dtype holds it (JAX rounds the constant
    of ``slope * p``)."""
    return float(torch.tensor(negative_slope, dtype=dtype))


def edge_stage_fwd_reference(xl, xr, att, idx, mask, heads: int,
                             negative_slope: float = 0.2, seed: Seed = None,
                             rate: float = 0.0, keep=None):
    """Plain PyTorch version of the forward kernel, with the TPU kernel's
    rounding: ``p = g + xr`` and ``s = leaky(p)`` in the feature dtype
    (the slope rounded to it first), logits accumulated in float32,
    softmax statistics in float32, output accumulated in float32 and
    stored in the feature dtype.  Returns ``(out (N, HC), alpha (N, K, H)
    float32)``; alpha is taken before dropout."""
    _check(xl, xr, att, idx, mask, heads, keep)
    mode = _mode(seed, keep)
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
    kc = _keep_c(mode, keep, seed, rate, n, k, heads, xl.dtype, xl.device)
    w = alpha if kc is None else alpha * kc
    out = torch.einsum(
        "nkh,nkhc->nhc", w, g.float().view(n, k, heads, ch)
    ).reshape(n, hc)
    return out.to(xl.dtype), alpha


def edge_stage_bwd_reference(xl, xr, att, idx, mask, alpha, go, heads: int,
                             negative_slope: float = 0.2, seed: Seed = None,
                             rate: float = 0.0, keep=None):
    """Plain PyTorch version of the backward kernel (``_bwd_core``) from
    the forward's ``alpha``, with the TPU kernel's rounding: ``t = G * g``
    in the feature dtype, ``dA`` and ``de`` in float32, ``p`` and ``s`` in
    the feature dtype, ``dg`` and ``dxr`` rounded to it.

    Returns ``(dg (N, K, HC), dxr (N, HC), datt (H, C) float32, dkeep
    (N, K, H) or None)``: dg is exactly zero on masked slots, datt is not
    yet rounded to att's dtype, dkeep exists in keep mode only."""
    _check(xl, xr, att, idx, mask, heads, keep)
    mode = _mode(seed, keep)
    dt = xl.dtype
    n, k = idx.shape
    hc = xl.shape[-1]
    ch = hc // heads
    g = xl[idx.long().clamp(0, xl.shape[0] - 1)]          # (N, K, HC)
    go = go.to(dt)
    t = go[:, None, :] * g
    d_a = t.float().view(n, k, heads, ch).sum(-1)          # (N, K, H)
    kc = _keep_c(mode, keep, seed, rate, n, k, heads, dt, xl.device)
    dalpha = d_a if kc is None else d_a * kc
    inner = (alpha * dalpha).sum(dim=1, keepdim=True)
    de = (alpha * (dalpha - inner)).repeat_interleave(ch, dim=-1)
    p = g + xr[:, None, :]
    pos = p > 0
    slope_t = torch.tensor(negative_slope, dtype=dt, device=xl.device)
    s = torch.where(pos, p, slope_t * p)
    m = mask[..., None]
    datt = torch.where(m, de * s.float(), 0.0).sum(dim=(0, 1))
    leak = torch.where(pos, 1.0, float(negative_slope))
    dp = torch.where(m, de * att.float().reshape(hc) * leak, 0.0)
    dxr = dp.sum(dim=1).to(dt)
    a_eff = alpha if kc is None else alpha * kc
    dg = a_eff.repeat_interleave(ch, dim=-1) * go.float()[:, None, :] + dp
    dg = torch.where(m, dg, 0.0).to(dt)
    dkeep = (alpha * d_a).to(dt) if mode == "keep" else None
    return dg, dxr, datt.view(heads, ch), dkeep


class EdgeLaunch(NamedTuple):
    """Launch configuration of the edge-stage kernels
    (``edge_stage_fwd.cu``, ``edge_stage_bwd.cu``): ``lanes`` per row,
    each holding ``nv`` chunks of ``chunk_bytes``; ``rows`` per block;
    ``slots`` of each row staged in shared memory at a time (K when every
    slot fits); ``smem_bytes`` of dynamic shared memory; ``n_blocks`` in
    the grid; and ``head_lanes``, the lanes of a head when the shape allows
    the kernels' fast path (one chunk a lane, no chunk across two heads, a
    power-of-two lanes per head), else 0."""
    lanes: int
    chunk_bytes: int
    nv: int
    rows: int
    slots: int
    smem_bytes: int
    n_blocks: int
    head_lanes: int


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _launch_config(name, n, k, hc, heads, dtype, row_bytes,
                   wide=False) -> EdgeLaunch:
    """The row-group launch configuration both edge-stage kernels share.
    A row is cut into chunks of 16 bytes (rows of 512 bytes or more, or
    any row when ``wide``) or 8 over a power-of-two number of lanes (at
    most 32); a block holds 128 threads' worth of rows; it stages as many
    slots of each row as fit in :data:`SMEM_MAX` beside
    ``row_bytes(hc_pad)``, the kernel's other shared bytes a row.  The
    block count depends on N alone."""
    size = 2 if dtype == torch.bfloat16 else 4
    chunk_bytes = 16 if wide or hc * size >= 512 else 8
    vec = chunk_bytes // size
    chunks = -(-hc // vec)
    lanes = min(32, _pow2(chunks))
    nv = _pow2(-(-chunks // lanes))
    hc_pad = lanes * nv * vec
    head_lanes = hc // heads // vec
    if not (nv == 1 and (hc // heads) % vec == 0 and head_lanes >= 1
            and _pow2(head_lanes) == head_lanes):
        head_lanes = 0
    rows = _THREADS // lanes
    while True:
        fixed = rows * row_bytes(hc_pad)
        slots = min(k, (SMEM_MAX - fixed) // (rows * hc_pad * size))
        if slots >= 1:
            break
        if rows == 1:
            raise ValueError(f"{name}: K*H = {k * heads} slot-heads "
                             "do not fit in shared memory")
        rows //= 2
    n_blocks = max(1, min(-(-n // _ROWS_PER_BLOCK), _MAX_BLOCKS))
    return EdgeLaunch(lanes, chunk_bytes, nv, rows, slots,
                      fixed + rows * slots * hc_pad * size, n_blocks,
                      head_lanes)


def fwd_launch_config(n: int, k: int, hc: int, heads: int,
                      dtype) -> EdgeLaunch:
    """The forward kernel's launch configuration for an (N, K) table of
    HC-wide rows with H heads in ``dtype``: the staged slots share shared
    memory with each row's logits and alpha*keep (K*H float32 each), its
    valid slots' source rows and each slot's compact index (K int32
    each).

    Rows of 256 to 511 bytes (HC = 128 in bf16) take 16-byte chunks, two
    rows a warp, where the table has :data:`_WIDE_MIN_ROWS` rows or more
    and the 8-row blocks stage every slot with eight blocks an SM: that
    halves the instructions a row's slot costs.  Smaller tables keep
    8-byte chunks, whose shorter lane chain finishes a lone wave sooner,
    and so do larger K, where the wide blocks' staging would halve the
    blocks an SM (on an H100 the wide layout lost 4 % at K = 24 and 10 %
    at 800 rows)."""
    def config(wide):
        return _launch_config("edge_stage_fwd", n, k, hc, heads, dtype,
                              lambda hc_pad: 2 * k * heads * 4 + 2 * k * 4,
                              wide)

    narrow = config(False)
    size = 2 if dtype == torch.bfloat16 else 4
    if narrow.chunk_bytes == 16 or hc * size < 256 or n < _WIDE_MIN_ROWS:
        return narrow
    wide = config(True)
    return wide if wide.slots == k and wide.smem_bytes <= SMEM_8_BLOCKS \
        else narrow


def bwd_launch_config(n: int, k: int, hc: int, heads: int,
                      dtype) -> EdgeLaunch:
    """The backward kernel's launch configuration: the staged slots share
    shared memory with each row's alpha, dA/de and alpha*keep (K*H float32
    each), the datt reduction buffer (HC float32 a row) and the slots'
    source rows (K int32)."""
    return _launch_config("edge_stage_bwd", n, k, hc, heads, dtype,
                          lambda hc_pad: (3 * k * heads + hc_pad) * 4 + k * 4)


def _vec_io(cfg: EdgeLaunch, hc: int, *tensors) -> bool:
    """Rows of whole chunks: hc * size a multiple of the chunk and every
    base aligned to it."""
    return (hc * tensors[0].element_size()) % cfg.chunk_bytes == 0 and all(
        t.data_ptr() % cfg.chunk_bytes == 0 for t in tensors)


def _fn(name, n_ptr_head, n_int, tail):
    lib = _build.load(name)
    fn = getattr(lib, f"sgt_{name}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr_head + [ctypes.c_int] * n_int \
            + tail
        fn.restype = ctypes.c_int
    return fn


def on_cuda(name, xl, *others):
    if xl.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {xl.device}")
    for t in others:
        if t is not None and t.device != xl.device:
            raise ValueError(f"{name}: tensors on different devices")


def _hash_args(mode, seed, rate, device):
    """The seed words' tensor (kept alive by the caller until the launch
    is queued), its address, and the threshold and multiplier."""
    if mode != "prng":
        return None, 0, 0, 1.0
    thresh, inv_keep = prng_config(rate)
    words = seed_tensor(seed, device)
    return words, words.data_ptr(), thresh, inv_keep


def edge_stage_fwd(xl, xr, att, idx, mask, heads: int,
                   negative_slope: float = 0.2, seed: Seed = None,
                   rate: float = 0.0, keep=None):
    """Edge-stage forward.

    xl (N_src, HC), xr (N, HC), att (H, C): float32 or bfloat16, one
    dtype.  idx (N, K) int32 (clipped into [0, N_src)), mask (N, K) bool.
    Dropout: ``seed`` (two 32-bit words, as ints or a (2,) int32 tensor on
    the features' device, which the kernel reads) with ``rate``, or
    ``keep`` (N, K, H) multipliers, or neither.  Returns ``(out (N, HC)
    in the feature dtype, alpha (N, K, H) float32 before dropout)``; rows
    with no valid slot give alpha = 0 and out = 0.

    CUDA tensors run the kernel (every launch adds one to
    ``edge_stage_fwd.launches[mode]``); CPU tensors run the plain version.
    """
    if xl.device.type == "cpu":
        return edge_stage_fwd_reference(xl, xr, att, idx, mask, heads,
                                        negative_slope, seed, rate, keep)
    on_cuda("edge_stage_fwd", xl, xr, att, idx, mask, keep)
    _check(xl, xr, att, idx, mask, heads, keep)
    mode = _mode(seed, keep)
    xl, xr, att = xl.contiguous(), xr.contiguous(), att.contiguous()
    idx, mask = idx.contiguous(), mask.contiguous()
    if keep is not None:
        keep = keep.to(xl.dtype).contiguous()
    n, k = idx.shape
    hc = xl.shape[1]
    out = torch.empty((n, hc), dtype=xl.dtype, device=xl.device)
    alpha = torch.empty((n, k, heads), dtype=torch.float32,
                        device=xl.device)
    if n == 0:
        return out, alpha
    cfg = fwd_launch_config(n, k, hc, heads, xl.dtype)
    vec_io = _vec_io(cfg, hc, xl, xr, out)
    words, seed_ptr, thresh, inv_keep = _hash_args(mode, seed, rate,
                                                   xl.device)
    fn = _fn("edge_stage_fwd", 6, 5, [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_uint32, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 9,
        ctypes.c_void_p])
    with torch.cuda.device(xl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(),
                 0 if keep is None else keep.data_ptr(), n, xl.shape[0], k,
                 heads, hc, dtype_slope(negative_slope, xl.dtype),
                 int(xl.dtype == torch.bfloat16), MODES.index(mode),
                 seed_ptr, thresh, inv_keep, out.data_ptr(), alpha.data_ptr(),
                 *cfg[:7], int(vec_io), cfg.head_lanes if vec_io else 0,
                 stream)
    if err:
        raise RuntimeError(f"edge_stage_fwd kernel launch failed: "
                           f"CUDA error {err}")
    edge_stage_fwd.launches[mode] += 1
    return out, alpha


edge_stage_fwd.launches = dict.fromkeys(MODES, 0)


def edge_stage_bwd(xl, xr, att, idx, mask, alpha, go, heads: int,
                   negative_slope: float = 0.2, seed: Seed = None,
                   rate: float = 0.0, keep=None):
    """Edge-stage backward from the forward's ``alpha`` and the output
    cotangent ``go`` (N, HC); the other arguments as
    :func:`edge_stage_fwd`.  Returns ``(dg (N, K, HC), dxr (N, HC), datt
    (H, C) float32, dkeep (N, K, H) or None)`` as
    :func:`edge_stage_bwd_reference`.

    CUDA tensors run the kernel (every launch adds one to
    ``edge_stage_bwd.launches[mode]``); its datt partials, one per block,
    are summed in a fixed order, so repeated runs agree bit for bit.  CPU
    tensors run the plain version."""
    if xl.device.type == "cpu":
        return edge_stage_bwd_reference(xl, xr, att, idx, mask, alpha, go,
                                        heads, negative_slope, seed, rate,
                                        keep)
    on_cuda("edge_stage_bwd", xl, xr, att, idx, mask, alpha, go, keep)
    _check(xl, xr, att, idx, mask, heads, keep)
    mode = _mode(seed, keep)
    n, k = idx.shape
    hc = xl.shape[1]
    if alpha.dtype != torch.float32 or tuple(alpha.shape) != (n, k, heads):
        raise ValueError("edge_stage_bwd: alpha must be (N, K, H) float32")
    if tuple(go.shape) != (n, hc):
        raise ValueError("edge_stage_bwd: go must be (N, HC)")
    xl, xr, att = xl.contiguous(), xr.contiguous(), att.contiguous()
    idx, mask = idx.contiguous(), mask.contiguous()
    alpha, go = alpha.contiguous(), go.to(xl.dtype).contiguous()
    if keep is not None:
        keep = keep.to(xl.dtype).contiguous()
    dev = xl.device
    dg = torch.empty((n, k, hc), dtype=xl.dtype, device=dev)
    dxr = torch.empty((n, hc), dtype=xl.dtype, device=dev)
    dkeep = (torch.empty((n, k, heads), dtype=xl.dtype, device=dev)
             if mode == "keep" else None)
    if n == 0:
        return dg, dxr, torch.zeros((heads, hc // heads), device=dev), dkeep
    cfg = bwd_launch_config(n, k, hc, heads, xl.dtype)
    datt_part = torch.empty((cfg.n_blocks, hc), dtype=torch.float32,
                            device=dev)
    vec_io = _vec_io(cfg, hc, xl, xr, go, dg, dxr)
    words, seed_ptr, thresh, inv_keep = _hash_args(mode, seed, rate, dev)
    fn = _fn("edge_stage_bwd", 8, 5, [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 9, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xl.data_ptr(), xr.data_ptr(), att.data_ptr(),
                 idx.data_ptr(), mask.data_ptr(), alpha.data_ptr(),
                 0 if keep is None else keep.data_ptr(), go.data_ptr(), n,
                 xl.shape[0], k, heads, hc,
                 dtype_slope(negative_slope, xl.dtype), float(negative_slope),
                 int(xl.dtype == torch.bfloat16), MODES.index(mode),
                 seed_ptr, thresh, inv_keep, dg.data_ptr(), dxr.data_ptr(),
                 datt_part.data_ptr(),
                 0 if dkeep is None else dkeep.data_ptr(), *cfg[:7],
                 int(vec_io), cfg.head_lanes if vec_io else 0, stream)
    if err:
        raise RuntimeError(f"edge_stage_bwd kernel launch failed: "
                           f"CUDA error {err}")
    edge_stage_bwd.launches[mode] += 1
    return dg, dxr, datt_part.sum(dim=0).view(heads, hc // heads), dkeep


edge_stage_bwd.launches = dict.fromkeys(MODES, 0)


def transpose_gather(dg, n_src: int, t_idx, t_mask):
    """``dxl`` (N_src, HC) from ``dg`` (N, K, HC) through the segment's
    transpose table (flat ``dst*K + slot`` positions, as ``_bwd_rule``
    reads ``csr_t``): for each source row, the float32 sum of the dg rows
    of the slots it feeds, in the table's slot order, so it repeats bit
    for bit.  Invalid transpose slots read an appended zero row."""
    n, k, hc = dg.shape
    if t_idx is None:
        raise ValueError("edge stage backward: the segment has no "
                         "transpose table (csr_t)")
    flat = torch.cat([dg.reshape(n * k, hc), dg.new_zeros(1, hc)])
    ti = torch.where(t_mask, t_idx.long(), n * k)
    return flat[ti].float().sum(dim=1).to(dg.dtype)


class EdgeStageFunction(torch.autograd.Function):
    """The edge stage with its kernel backward.

    ``apply(xl, xr, att, keep, idx, mask, t_idx, t_mask, heads,
    negative_slope, seed, rate)`` returns ``out`` (N, HC).  The forward
    saves ``alpha`` (not the gathered rows), the backward regathers; the
    gradients are ``dxl, dxr, datt`` and, in keep mode, ``dkeep``."""

    @staticmethod
    def forward(ctx, xl, xr, att, keep, idx, mask, t_idx, t_mask, heads,
                negative_slope, seed, rate):
        out, alpha = edge_stage_fwd(xl, xr, att, idx, mask, heads,
                                    negative_slope, seed, rate, keep)
        ctx.save_for_backward(xl, xr, att, keep, idx, mask, t_idx, t_mask,
                              alpha)
        ctx.config = (heads, negative_slope, seed, rate)
        return out

    @staticmethod
    def backward(ctx, go):
        xl, xr, att, keep, idx, mask, t_idx, t_mask, alpha = \
            ctx.saved_tensors
        heads, slope, seed, rate = ctx.config
        dg, dxr, datt, dkeep = edge_stage_bwd(
            xl, xr, att, idx, mask, alpha, go, heads, slope, seed, rate, keep)
        dxl = transpose_gather(dg, xl.shape[0], t_idx, t_mask)
        if dkeep is not None:
            dkeep = dkeep.to(keep.dtype)
        return (dxl, dxr, datt.to(att.dtype), dkeep,
                None, None, None, None, None, None, None, None)


def gatv2_edge_stage(xl, xr, att, idx, mask, heads: int,
                     negative_slope: float = 0.2, csr_t=None,
                     seed: Seed = None, rate: float = 0.0, keep=None):
    """The differentiable edge stage (``gatv2_edge_stage_pallas``): ``out``
    (N, HC) in the feature dtype.  ``csr_t`` is the segment's transpose
    table (a ``PaddedCSR`` of flat slot positions) for the ``dxl``
    gather, needed by the backward only; dropout as
    :func:`edge_stage_fwd`."""
    t_idx = t_mask = None
    if csr_t is not None:
        t_idx, t_mask = csr_t.idx, csr_t.mask
    return EdgeStageFunction.apply(xl, xr, att, keep, idx, mask, t_idx,
                                   t_mask, heads, negative_slope, seed, rate)
