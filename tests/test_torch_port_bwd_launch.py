"""The edge-stage backward kernel's launch configuration
(``ops/postgather.py::bwd_launch_config``), which the wrapper hands to
``csrc/edge_stage_bwd.cu``: checked on the CPU for every shape the kernel
tests use and for the main path's shapes."""
import pytest
import torch

from segger_tpu_torch.ops.postgather import (
    SMEM_MAX, EdgeLaunch, bwd_launch_config,
)

BF16, F32 = torch.bfloat16, torch.float32
# (HC, H) of tests/test_torch_port_kernels.py's backward cases
TEST_SHAPES = [(128, 2), (48, 3), (36, 3), (512, 8), (32, 2)]
TEST_KS = [1, 4, 12, 13, 24, 25, 40]
# the main path: TrainConfig() width (64 x 2 heads), the tiles' segments
MAIN_KS = [4, 8, 12, 24]


def _size(dtype):
    return 2 if dtype == BF16 else 4


@pytest.mark.parametrize("k", TEST_KS)
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("hc,heads", TEST_SHAPES)
def test_config_fits_and_covers_the_row(hc, heads, dtype, k):
    cfg = bwd_launch_config(700, k, hc, heads, dtype)
    assert cfg.chunk_bytes == (16 if hc * _size(dtype) >= 512 else 8)
    vec = cfg.chunk_bytes // _size(dtype)
    hc_pad = cfg.lanes * cfg.nv * vec
    assert cfg.lanes & (cfg.lanes - 1) == 0 and 1 <= cfg.lanes <= 32
    assert cfg.nv in (1, 2, 4)
    # the lanes' chunks cover the row, with the fewest lanes (up to 32),
    # then the fewest chunks a lane, that do
    assert hc <= hc_pad
    if cfg.nv == 1:
        assert cfg.lanes == 1 or (cfg.lanes // 2) * vec < hc
    else:
        assert cfg.lanes == 32 and 32 * (cfg.nv // 2) * vec < hc
    assert 1 <= cfg.slots <= k
    assert 1 <= cfg.rows and cfg.rows * cfg.lanes <= 128
    # the fast path: one chunk a lane, inside one head, 2^m lanes a head
    ch = hc // heads
    lph = ch // vec
    fast = (cfg.nv == 1 and ch % vec == 0 and lph >= 1
            and lph & (lph - 1) == 0)
    assert cfg.head_lanes == (lph if fast else 0)
    want = (cfg.rows * ((3 * k * heads + hc_pad) * 4 + k * 4)
            + cfg.rows * cfg.slots * hc_pad * _size(dtype))
    assert cfg.smem_bytes == want <= SMEM_MAX


@pytest.mark.parametrize("k", MAIN_KS)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_main_path_shapes_stage_every_slot(dtype, k):
    cfg = bwd_launch_config(12_000, k, 128, 2, dtype)
    assert cfg.slots == k and cfg.head_lanes == 16
    assert cfg.lanes == 32 and cfg.rows == 4
    # four blocks fit on an SM (233,472 shared bytes, 1 KB per block kept)
    assert cfg.smem_bytes <= 233_472 // 4 - 1024


@pytest.mark.parametrize("dtype,limit", [(F32, 26), (BF16, 49)])
def test_staging_limit_at_hc_512(dtype, limit):
    at = bwd_launch_config(700, limit, 512, 8, dtype)
    above = bwd_launch_config(700, limit + 1, 512, 8, dtype)
    assert at.slots == limit
    assert above.slots < limit + 1 and above.smem_bytes <= SMEM_MAX


@pytest.mark.parametrize("n", [1, 15, 16, 17, 700, 12_000, 16_421, 50_000,
                               10**6])
def test_block_count_depends_on_n_alone(n):
    counts = {bwd_launch_config(n, k, hc, heads, dtype).n_blocks
              for hc, heads in TEST_SHAPES for dtype in (BF16, F32)
              for k in TEST_KS}
    assert len(counts) == 1
    (n_blocks,) = counts
    assert 1 <= n_blocks <= 4096
    assert n_blocks == min(-(-n // 4), 4096)


def test_many_slot_heads_shrink_the_block_or_raise():
    cfg = bwd_launch_config(700, 24, 512, 512, F32)
    assert isinstance(cfg, EdgeLaunch)
    assert cfg.rows < 4 and cfg.smem_bytes <= SMEM_MAX and cfg.slots >= 1
    with pytest.raises(ValueError):
        bwd_launch_config(700, 100, 512, 512, F32)
