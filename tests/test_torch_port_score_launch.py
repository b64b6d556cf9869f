"""The scoring kernel's layout (``ops/score.py::score_launch_config``),
which the wrapper of K5 hands to ``csrc/score.cu``: checked on the CPU over
row widths, slot counts, both dtypes and aligned or unaligned tables, and
at the main path's shapes."""
import pytest
import torch

from segger_tpu_torch.ops.score import (
    MAX_F, ScoreLaunch, score_launch_config,
)

BF16, F32 = torch.bfloat16, torch.float32
FS = [1, 33, 64, 128, 512]
KS = [1, 4, 7, 24, 64]
NS = [1, 15, 16, 17, 1_001, 16_128, 50_000, 200_000]
# (tx pointer, bd pointer): both on 256 bytes, tx off by one bf16 / f32
# element, bd off by one
POINTERS = [(4096, 8192), (4098, 8192), (4096, 8196)]


def _size(dtype):
    return 2 if dtype == BF16 else 4


@pytest.mark.parametrize("tx_ptr,bd_ptr", [POINTERS[0], POINTERS[2]],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("f", FS)
def test_score_layout_covers_the_row(f, k, dtype, tx_ptr, bd_ptr):
    cfg = score_launch_config(700, k, f, dtype, tx_ptr, bd_ptr)
    assert isinstance(cfg, ScoreLaunch)
    size = _size(dtype)
    # lanes a row: a power of two that divides the warp
    assert 32 % cfg.lanes == 0
    assert cfg.chunk_bytes == (16 if f * size >= 128 else 8)
    vec = cfg.chunk_bytes // size
    assert cfg.nv in (1, 2, 4)
    # four chunks a lane only on f32 rows of 16-byte chunks, the kernel's
    # only instances with four
    assert cfg.nv < 4 or (dtype == F32 and cfg.chunk_bytes == 16)
    # the lanes' chunks cover the row: the fewest lanes (up to 32) that do
    # with two chunks a lane, then the fewest chunks a lane
    chunks = -(-f * size // cfg.chunk_bytes)
    assert f <= cfg.lanes * cfg.nv * vec and chunks <= cfg.lanes * cfg.nv
    if cfg.lanes < 32:
        assert cfg.nv <= 2 and (cfg.lanes == 1 or cfg.lanes < chunks)
    else:
        assert cfg.nv == 1 or 32 * (cfg.nv // 2) < chunks
    # chunks tile F exactly on aligned tables, or the element path is taken
    whole = f * size % cfg.chunk_bytes == 0
    aligned = (tx_ptr % cfg.chunk_bytes == 0
               and bd_ptr % cfg.chunk_bytes == 0)
    assert cfg.vec == (whole and aligned)
    # rows a block times lanes a row fill the 128-thread block
    assert cfg.rows * cfg.lanes == 128
    # the slot batch: 32 gathered chunk words a lane, 1 to 8 rows
    words = cfg.chunk_bytes // 4 * cfg.nv
    assert 1 <= cfg.slot_batch <= 8
    assert cfg.slot_batch * words <= 32
    assert cfg.slot_batch == 8 or (cfg.slot_batch + 1) * words > 32


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("f", FS + [2, 48, 96, 257])
def test_score_summation_order_follows_f_and_dtype_alone(f, dtype):
    """Lanes a row, chunk bytes and chunks a lane set each lane's channels
    and the butterfly, so the dot product's summation order: the same for
    every K, N and pointer, so equal candidate rows tie exactly whatever
    the slot, and the aligned and unaligned tables sum alike."""
    orders = {score_launch_config(n, k, f, dtype, tx, bd)[:3]
              for n in NS for k in KS for tx, bd in POINTERS}
    assert len(orders) == 1
    slot_batches = {score_launch_config(n, k, f, dtype).slot_batch
                    for n in NS for k in KS}
    assert len(slot_batches) == 1


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("f", FS)
def test_score_grid_covers_n(f, dtype, n):
    """One row a group, every row served once: the last block holds the
    last row, and the grid depends on N and the row width alone."""
    cfgs = {score_launch_config(n, k, f, dtype) for k in KS}
    assert len({c.n_blocks for c in cfgs}) == 1
    cfg = cfgs.pop()
    assert cfg.n_blocks * cfg.rows >= n > (cfg.n_blocks - 1) * cfg.rows


@pytest.mark.parametrize("n,n_blocks", [(16_128, 504), (50_000, 1_563)])
def test_score_main_shapes(n, n_blocks):
    """The predict tile (16,128 x 4) and phase 2's N = 50,000 at F = 64
    (``out_channels``) in bf16: 4 lanes of two 16-byte chunks, eight rows
    a warp, every candidate of K = 4 read in one round and gathered in one
    batch."""
    cfg = score_launch_config(n, 4, 64, BF16, 1 << 20, 1 << 21)
    assert cfg == ScoreLaunch(lanes=4, chunk_bytes=16, nv=2, slot_batch=4,
                              rows=32, n_blocks=n_blocks, vec=True)


def test_score_widest_rows_fit_the_kernel():
    """F = MAX_F: 32 lanes of four f32 chunks (two slots a batch) or two
    bf16 chunks (four slots a batch), the kernel's largest instances."""
    f32 = score_launch_config(10, 4, MAX_F, F32)
    bf16 = score_launch_config(10, 4, MAX_F, BF16)
    assert (f32.lanes, f32.nv, f32.slot_batch) == (32, 4, 2)
    assert (bf16.lanes, bf16.nv, bf16.slot_batch) == (32, 2, 4)
