"""The attention kernel's launch configuration
(``ops/gatv2_attn.py::attn_launch_config``), which the wrappers of K6 and
K7 hand to ``csrc/attn_fwd.cu``, and the per-head summation order that
its layout sets and ``head_logits`` repeats: checked on the CPU for the
shapes the kernel tests use and for phase 2c's and the slide's shapes."""
import numpy as np
import pytest
import torch

from segger_tpu_torch.ops.gatv2_attn import attn_launch_config, head_logits
from segger_tpu_torch.ops.postgather import (
    SMEM_8_BLOCKS, SMEM_MAX, EdgeLaunch,
)

BF16, F32 = torch.bfloat16, torch.float32
# (HC, H) of tests/test_torch_port_kernels.py's attention cases
TEST_SHAPES = [(128, 2), (32, 1), (48, 3), (36, 3), (512, 8)]
TEST_KS = [1, 4, 13, 16, 40]
# phase 2c (N = 50,000, K 4/8/12/24) and the slide tables (200,192 rows,
# K = 16)
MAIN = [(n, k) for n in (50_000, 200_192) for k in (4, 8, 12, 16, 24)]


def _size(dtype):
    return 2 if dtype == BF16 else 4


def _smem(cfg, k, heads, dtype):
    """Shared bytes: per row K*H f32 logits (then alpha) and K int32
    source rows, then the staged slots."""
    hc_pad = cfg.lanes * cfg.nv * cfg.chunk_bytes // _size(dtype)
    return (cfg.rows * (k * heads * 4 + k * 4)
            + cfg.rows * cfg.slots * hc_pad * _size(dtype))


@pytest.mark.parametrize("k", TEST_KS)
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("hc,heads", TEST_SHAPES)
def test_attn_config_fits_and_covers_the_row(hc, heads, dtype, k):
    cfg = attn_launch_config(700, k, hc, heads, dtype)
    assert isinstance(cfg, EdgeLaunch)
    assert cfg.chunk_bytes == (16 if hc * _size(dtype) >= 256 else 8)
    vec = cfg.chunk_bytes // _size(dtype)
    assert cfg.lanes & (cfg.lanes - 1) == 0 and 1 <= cfg.lanes <= 32
    assert cfg.nv in (1, 2, 4)
    # the lanes' chunks cover the row, with the fewest lanes (up to 32),
    # then the fewest chunks a lane, that do
    assert hc <= cfg.lanes * cfg.nv * vec
    if cfg.nv == 1:
        assert cfg.lanes == 1 or (cfg.lanes // 2) * vec < hc
    else:
        assert cfg.lanes == 32 and 32 * (cfg.nv // 2) * vec < hc
    assert 1 <= cfg.slots <= k
    assert cfg.rows * cfg.lanes == 128
    # the fast path: one chunk a lane, inside one head, 2^m lanes a head
    ch = hc // heads
    lph = ch // vec
    fast = (cfg.nv == 1 and ch % vec == 0 and lph >= 1
            and lph & (lph - 1) == 0)
    assert cfg.head_lanes == (lph if fast else 0)
    assert cfg.smem_bytes == _smem(cfg, k, heads, dtype) <= SMEM_MAX
    # as many slots as keep eight blocks an SM, at least one
    one_more = cfg.smem_bytes + cfg.rows * cfg.lanes * cfg.nv \
        * cfg.chunk_bytes
    assert cfg.slots == 1 or cfg.smem_bytes <= SMEM_8_BLOCKS
    assert cfg.slots == k or one_more > SMEM_8_BLOCKS


@pytest.mark.parametrize("dtype,limit", [(F32, 3), (BF16, 6)])
def test_attn_staging_limit_at_hc_512(dtype, limit):
    """HC = 512, H = 8: every slot staged at the limit; one past it the
    slots go in chunks, both within eight blocks' shared memory."""
    at = attn_launch_config(700, limit, 512, 8, dtype)
    above = attn_launch_config(700, limit + 1, 512, 8, dtype)
    assert at.slots == limit and at.smem_bytes <= SMEM_8_BLOCKS
    assert above.slots < limit + 1 and above.smem_bytes <= SMEM_8_BLOCKS
    assert above.smem_bytes == _smem(above, limit + 1, 8, dtype)
    assert above.rows == at.rows == 4


@pytest.mark.parametrize("n,k", MAIN)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_attn_main_shapes_keep_eight_blocks_an_sm(dtype, n, k):
    """Every slot staged up to K = 12; at K = 16 (the slide) and 24 as
    many as keep eight blocks an SM."""
    cfg = attn_launch_config(n, k, 128, 2, dtype)
    assert cfg.slots == {16: 13, 24: 12 if dtype == BF16 else 13}.get(k, k)
    assert cfg.smem_bytes <= SMEM_8_BLOCKS
    # 256-byte bf16 rows in 16-byte chunks, two rows a warp; 512-byte f32
    # rows one a warp; every head's logit from one butterfly
    assert (cfg.chunk_bytes, cfg.nv) == (16, 1)
    assert (cfg.lanes, cfg.rows, cfg.head_lanes) == (
        (16, 8, 8) if dtype == BF16 else (32, 4, 16))


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("hc,heads", TEST_SHAPES + [(64, 2)])
def test_attn_layout_depends_on_the_row_alone(hc, heads, dtype):
    """The layout follows HC, H and the dtype, never N or K, so the plain
    version can repeat the kernel's order from the row's shape."""
    layouts = {attn_launch_config(n, k, hc, heads, dtype)[:3]
               + (attn_launch_config(n, k, hc, heads, dtype).head_lanes,)
               for n in (1, 700, 2_047, 2_048, 50_000, 200_192)
               for k in TEST_KS}
    assert len(layouts) == 1


@pytest.mark.parametrize("n", [1, 15, 16, 17, 700, 50_000, 200_192, 10**6])
def test_attn_block_count_depends_on_n_alone(n):
    counts = {attn_launch_config(n, k, hc, heads, dtype).n_blocks
              for hc, heads in TEST_SHAPES for dtype in (BF16, F32)
              for k in TEST_KS}
    assert counts == {min(-(-n // 4), 4096)}


def _loop_logits(prod, heads, lanes, vec):
    """The order the source note of attn_fwd.cu states, one scalar at a
    time in float32: each lane adds its channels of the head to 0 (chunk
    by chunk, channel by channel), then a butterfly over the lanes."""
    n, k, hc = prod.shape
    ch = hc // heads
    out = np.zeros((n, k, heads), np.float32)
    for i in range(n):
        for j in range(k):
            for h in range(heads):
                part = [np.float32(0)] * lanes
                for c in range(hc):
                    if c // ch == h:
                        lane = (c // vec) % lanes
                        part[lane] = np.float32(part[lane] + prod[i, j, c])
                off = lanes // 2
                while off:
                    part = [np.float32(part[x] + part[x ^ off])
                            for x in range(lanes)]
                    off //= 2
                out[i, j, h] = part[0]
    return out


@pytest.mark.parametrize("hc,heads", [(128, 2), (48, 3), (32, 1)])
def test_head_logits_repeats_the_kernel_order(hc, heads):
    """Bit for bit in bf16: the bf16 products summed in the layout of
    attn_launch_config, the sum rounded to bf16."""
    rng = np.random.default_rng(hc)
    n, k = 3, 5
    s = torch.from_numpy(rng.normal(size=(n, k, hc)) * 3).to(BF16)
    att = torch.from_numpy(rng.normal(size=(hc,))).to(BF16)
    prod = (s * att).float()                     # each product rounded
    cfg = attn_launch_config(n, k, hc, heads, BF16)
    vec = cfg.chunk_bytes // 2
    got = head_logits(prod, heads, cfg.lanes, vec).to(BF16)
    want = torch.from_numpy(_loop_logits(prod.numpy(), heads, cfg.lanes,
                                         vec)).to(BF16)
    assert got.shape == (n, k, heads) and torch.equal(got, want)
