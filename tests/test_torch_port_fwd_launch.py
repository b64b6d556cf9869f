"""The edge-stage forward kernel's launch configuration
(``ops/postgather.py::fwd_launch_config``), which the wrapper hands to
``csrc/edge_stage_fwd.cu``: checked on the CPU for every shape the kernel
tests use and for the main path's shapes; and the backward's
configuration, which shares its chunk and lane arithmetic, held to the
tuples it gave before the two shared it."""
import pytest
import torch

from segger_tpu_torch.ops.postgather import (
    SMEM_MAX, EdgeLaunch, bwd_launch_config, fwd_launch_config,
)

BF16, F32 = torch.bfloat16, torch.float32
# (HC, H) of tests/test_torch_port_kernels.py's edge-stage cases
TEST_SHAPES = [(128, 2), (48, 3), (36, 3), (512, 8), (32, 2)]
TEST_KS = [1, 4, 12, 13, 24, 25, 40]
# the main path: TrainConfig() width (64 x 2 heads), the tiles' segments
MAIN_KS = [4, 8, 12, 24]


def _size(dtype):
    return 2 if dtype == BF16 else 4


def _fwd_smem(cfg, k, heads, hc_pad, dtype):
    """Shared bytes: per row K*H f32 logits and alpha*keep and K int32
    source rows and compact indices, then the staged slots."""
    return (cfg.rows * (2 * k * heads * 4 + 2 * k * 4)
            + cfg.rows * cfg.slots * hc_pad * _size(dtype))


@pytest.mark.parametrize("k", TEST_KS)
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("hc,heads", TEST_SHAPES)
def test_fwd_config_fits_and_covers_the_row(hc, heads, dtype, k):
    cfg = fwd_launch_config(700, k, hc, heads, dtype)
    assert isinstance(cfg, EdgeLaunch)
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
    assert cfg.smem_bytes == _fwd_smem(cfg, k, heads, hc_pad, dtype)
    assert cfg.smem_bytes <= SMEM_MAX
    # the forward and the backward cut a row alike
    bwd = bwd_launch_config(700, k, hc, heads, dtype)
    assert (cfg.lanes, cfg.chunk_bytes, cfg.nv, cfg.head_lanes,
            cfg.n_blocks) == (bwd.lanes, bwd.chunk_bytes, bwd.nv,
                              bwd.head_lanes, bwd.n_blocks)


@pytest.mark.parametrize("n", [640, 800, 832, 3_024, 5_040, 8_064, 12_000,
                               50_000])
@pytest.mark.parametrize("k", MAIN_KS)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_fwd_main_path_shapes_stage_every_slot(dtype, k, n):
    cfg = fwd_launch_config(n, k, 128, 2, dtype)
    assert cfg.slots == k and cfg.nv == 1
    # bf16 tables of 2,048 rows or more at K <= 12 take 16-byte chunks,
    # two rows a warp; the rest one row a warp
    wide = dtype == BF16 and n >= 2048 and k <= 12
    assert (cfg.lanes, cfg.rows, cfg.head_lanes) == (
        (16, 8, 8) if wide else (32, 4, 16))
    assert cfg.chunk_bytes == (8 if dtype == BF16 and not wide else 16)
    # the blocks that __launch_bounds__(128, 8) asks for share an SM in
    # bf16 (four in f32 at K = 24): 233,472 shared bytes, 1 KB per block
    # kept
    per_sm = 8 if dtype == BF16 or k < 24 else 4
    assert cfg.smem_bytes <= 233_472 // per_sm - 1024


@pytest.mark.parametrize("k,wide", [(1, True), (12, True), (13, False),
                                    (24, False)])
@pytest.mark.parametrize("n,big", [(2_047, False), (2_048, True)])
def test_fwd_wide_chunks_where_eight_blocks_fit(n, big, k, wide):
    """16-byte chunks on 256-byte rows from 2,048 rows on, while the 8-row
    blocks stage every slot eight to an SM; the wide configuration
    differs from the narrow one in the row cut alone."""
    cfg = fwd_launch_config(n, k, 128, 2, BF16)
    narrow = bwd_launch_config(n, k, 128, 2, BF16)
    assert (cfg.chunk_bytes == 16) == (big and wide)
    if cfg.chunk_bytes == 8:
        assert cfg[:3] == narrow[:3] and cfg.head_lanes == narrow.head_lanes
    else:
        assert cfg.smem_bytes <= 233_472 // 8 - 1024
    assert cfg.n_blocks == narrow.n_blocks


@pytest.mark.parametrize("hc,heads,dtype", [(64, 2, BF16), (48, 3, BF16),
                                            (128, 2, F32), (512, 8, BF16),
                                            (36, 3, F32)])
def test_fwd_other_rows_keep_the_shared_cut(hc, heads, dtype):
    """Rows outside 256-511 bytes are cut as the backward cuts them at
    any N."""
    for n in (700, 50_000):
        cfg = fwd_launch_config(n, 12, hc, heads, dtype)
        bwd = bwd_launch_config(n, 12, hc, heads, dtype)
        assert (cfg.lanes, cfg.chunk_bytes, cfg.nv, cfg.head_lanes) == (
            bwd.lanes, bwd.chunk_bytes, bwd.nv, bwd.head_lanes)


@pytest.mark.parametrize("dtype,limit", [(F32, 27), (BF16, 53)])
def test_fwd_staging_limit_at_hc_512(dtype, limit):
    """HC = 512, H = 8: every slot staged at the limit; one past it the
    slots go in chunks, still within shared memory."""
    at = fwd_launch_config(700, limit, 512, 8, dtype)
    above = fwd_launch_config(700, limit + 1, 512, 8, dtype)
    assert at.slots == limit and at.smem_bytes <= SMEM_MAX
    assert above.slots < limit + 1 and above.smem_bytes <= SMEM_MAX
    assert above.rows == at.rows == 4


@pytest.mark.parametrize("n", [1, 15, 16, 17, 700, 12_000, 16_421, 50_000,
                               10**6])
def test_fwd_block_count_depends_on_n_alone(n):
    counts = {fwd_launch_config(n, k, hc, heads, dtype).n_blocks
              for hc, heads in TEST_SHAPES for dtype in (BF16, F32)
              for k in TEST_KS}
    assert len(counts) == 1
    (n_blocks,) = counts
    assert n_blocks == min(-(-n // 4), 4096)


def test_fwd_many_slot_heads_shrink_the_block_or_raise():
    cfg = fwd_launch_config(700, 40, 512, 512, F32)
    assert cfg.rows < 4 and cfg.smem_bytes <= SMEM_MAX and cfg.slots >= 1
    with pytest.raises(ValueError):
        fwd_launch_config(700, 200, 512, 512, F32)


# bwd_launch_config(700, k, hc, heads, dtype) for k in TEST_KS, as the
# backward kernel was tuned with it: (lanes, chunk_bytes, nv, head_lanes),
# then (rows, slots, smem_bytes) per K
BWD_BEFORE = [
    ((128, 2, BF16), (32, 8, 1, 16), [
        (4, 1, 3184), (4, 4, 6592), (4, 12, 15680), (4, 13, 16816),
        (4, 24, 29312), (4, 25, 30448), (4, 40, 47488)]),
    ((128, 2, F32), (32, 16, 1, 16), [
        (4, 1, 4208), (4, 4, 10688), (4, 12, 27968), (4, 13, 30128),
        (4, 24, 53888), (4, 25, 56048), (4, 40, 88448)]),
    ((48, 3, BF16), (16, 8, 1, 4), [
        (8, 1, 3392), (8, 4, 7424), (8, 12, 18176), (8, 13, 19520),
        (8, 24, 34304), (8, 25, 35648), (8, 40, 55808)]),
    ((48, 3, F32), (32, 8, 1, 8), [
        (4, 1, 2208), (4, 4, 5760), (4, 12, 15232), (4, 13, 16416),
        (4, 24, 29440), (4, 25, 30624), (4, 40, 48384)]),
    ((36, 3, BF16), (16, 8, 1, 0), [
        (8, 1, 3392), (8, 4, 7424), (8, 12, 18176), (8, 13, 19520),
        (8, 24, 34304), (8, 25, 35648), (8, 40, 55808)]),
    ((36, 3, F32), (32, 8, 1, 0), [
        (4, 1, 2208), (4, 4, 5760), (4, 12, 15232), (4, 13, 16416),
        (4, 24, 29440), (4, 25, 30624), (4, 40, 48384)]),
    ((512, 8, BF16), (32, 16, 2, 0), [
        (4, 1, 12688), (4, 4, 26176), (4, 12, 62144), (4, 13, 66640),
        (4, 24, 116096), (4, 25, 120592), (4, 40, 188032)]),
    ((512, 8, F32), (32, 16, 4, 0), [
        (4, 1, 16784), (4, 4, 42560), (4, 12, 111296), (4, 13, 119888),
        (4, 24, 214400), (4, 25, 222992), (4, 25, 228992)]),
    ((32, 2, BF16), (8, 8, 1, 4), [
        (16, 1, 3520), (16, 4, 7936), (16, 12, 19712), (16, 13, 21184),
        (16, 24, 37376), (16, 25, 38848), (16, 40, 60928)]),
    ((32, 2, F32), (16, 8, 1, 8), [
        (8, 1, 2272), (8, 4, 6016), (8, 12, 16000), (8, 13, 17248),
        (8, 24, 30976), (8, 25, 32224), (8, 40, 50944)]),
]


@pytest.mark.parametrize("shape,row,per_k", BWD_BEFORE,
                         ids=[f"{hc}-{h}-{str(d).split('.')[-1]}"
                              for (hc, h, d), _, _ in BWD_BEFORE])
def test_bwd_config_unchanged(shape, row, per_k):
    hc, heads, dtype = shape
    for k, (rows, slots, smem) in zip(TEST_KS, per_k):
        cfg = bwd_launch_config(700, k, hc, heads, dtype)
        assert cfg == EdgeLaunch(row[0], row[1], row[2], rows, slots, smem,
                                 175, row[3])
