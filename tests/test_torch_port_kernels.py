"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Skipped without a CUDA device; on one, run (the JAX-pinning
conftest is not needed):

    python -m pytest --noconftest -m gpu tests/test_torch_port_kernels.py
"""
import pytest
import torch

from segger_tpu_torch.ops.postgather import (
    bwd_launch_config, edge_stage_bwd, edge_stage_bwd_reference,
    edge_stage_fwd, edge_stage_fwd_reference, fwd_launch_config,
    prng_keep_reference,
)
from segger_tpu_torch.ops.score import score_max, score_max_reference
from segger_tpu_torch.ops.banded import (
    band_graph, banded_edge_stage, banded_edge_stage_reference,
)
from segger_tpu_torch.ops.gatv2_attn import (
    attn_launch_config, gatv2_attention, gatv2_attention_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(n, k, n_src, gen, device):
    deg = torch.randint(0, k + 1, (n,), generator=gen)
    deg[:5] = 0
    mask = torch.arange(k)[None, :] < deg[:, None]
    idx = torch.where(mask, torch.randint(0, n_src, (n, k), generator=gen),
                      0)
    return idx.int().to(device), mask.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hc,heads", [(128, 2), (32, 2), (48, 3),
                                      (512, 8)])
@pytest.mark.parametrize("k", [1, 4, 13, 40])
def test_edge_stage_kernel_matches_reference(cuda, k, hc, heads, dtype):
    gen = torch.Generator().manual_seed(k * 1000 + hc)
    n, n_src = 700, 500
    xl = torch.randn(n_src, hc, generator=gen).to(dtype).to(cuda)
    xr = torch.randn(n, hc, generator=gen).to(dtype).to(cuda)
    att = torch.randn(heads, hc // heads, generator=gen).to(dtype).to(cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    out, alpha = edge_stage_fwd(xl, xr, att, idx, mask, heads)
    ref_out, ref_alpha = edge_stage_fwd_reference(xl, xr, att, idx, mask,
                                                  heads)
    torch.cuda.synchronize()
    # f32: one arithmetic, other summation order; bf16: an f32 sum may
    # round to the neighbouring bf16 value
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(alpha, ref_alpha, atol=1e-5, rtol=0)
    assert (out[:5] == 0).all() and (alpha[:5] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f,k", [(64, 4), (33, 7), (512, 2)])
def test_score_kernel_matches_reference(cuda, f, k, dtype):
    gen = torch.Generator().manual_seed(f + k)
    n, n_bd = 900, 60
    tx = torch.randn(n, f, generator=gen).to(dtype).to(cuda)
    bd = torch.randn(n_bd, f, generator=gen).to(dtype).to(cuda)
    idx, mask = _table(n, k, n_bd, gen, cuda)
    mx, slot = score_max(tx, bd, idx, mask)
    ref_mx, ref_slot = score_max_reference(tx, bd, idx, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(slot, ref_slot, atol=0, rtol=0)
    torch.testing.assert_close(mx, ref_mx, atol=1e-4, rtol=1e-5)
    assert (slot[:5] == -1).all() and (mx[:5] == -1e30).all()


def test_score_kernel_takes_first_max(cuda):
    tx = torch.ones(1, 4, device=cuda)
    bd = torch.tensor([[0.0, 0, 0, 0], [1, 1, 1, 1], [1, 1, 1, 1]],
                      device=cuda)
    idx = torch.tensor([[0, 1, 2, 1]], dtype=torch.int32, device=cuda)
    mask = torch.tensor([[True, False, True, True]], device=cuda)
    mx, slot = score_max(tx, bd, idx, mask)
    assert slot.item() == 2 and mx.item() == 4.0


def _score_inputs(n, k, f, n_bd, dtype, gen, cuda, p_valid=0.6,
                  misaligned=False):
    """Random rows and a candidate table whose valid slots fall anywhere
    (holes in the mask), idx partly out of [0, n_bd)."""
    def rows(m):
        x = torch.randn(m, f, generator=gen).to(dtype)
        if not misaligned:
            return x.to(cuda)
        buf = torch.empty(m * f + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(m, f)          # one element off the chunk
        view.copy_(x)
        return view

    idx = torch.randint(-3, n_bd + 3, (n, k), generator=gen,
                        dtype=torch.int32)
    mask = torch.rand(n, k, generator=gen) < p_valid
    return rows(n), rows(n_bd), idx.to(cuda), mask.to(cuda)


def _assert_score_matches(tx, bd, idx, mask):
    mx, slot = score_max(tx, bd, idx, mask)
    ref_mx, ref_slot = score_max_reference(tx, bd, idx, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(slot, ref_slot, atol=0, rtol=0)
    torch.testing.assert_close(mx, ref_mx, atol=1e-4, rtol=1e-5)
    return mx, slot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,f", [
    (1, 4, 64),            # one row
    (1_001, 4, 64),        # N not a multiple of the rows a block
    (777, 3, 33),          # general path: rows not whole chunks
    (500, 24, 64),         # K above the slot batch and the lanes a row
    (300, 64, 1),          # one lane a row, 64 rounds
    (257, 9, 512),         # four chunks a lane (f32), two slots a batch
])
def test_score_kernel_holes_and_clipped_idx(cuda, n, k, f, dtype):
    gen = torch.Generator().manual_seed(n + k + f)
    _assert_score_matches(*_score_inputs(n, k, f, 70, dtype, gen, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f,k", [(64, 4), (48, 24)])
def test_score_kernel_misaligned_view(cuda, f, k, dtype):
    """Tables one element off the chunk boundary take the element path
    in the same layout."""
    gen = torch.Generator().manual_seed(f * k)
    tx, bd, idx, mask = _score_inputs(600, k, f, 90, dtype, gen, cuda,
                                      misaligned=True)
    assert tx.data_ptr() % 8 and bd.data_ptr() % 8
    mx, slot = _assert_score_matches(tx, bd, idx, mask)
    al = _assert_score_matches(tx.clone(), bd.clone(), idx, mask)
    assert torch.equal(slot, al[1]) and torch.equal(mx, al[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [4, 13])
def test_score_kernel_ties_take_the_first_valid_slot(cuda, k, dtype):
    """Slots naming the same candidate row tie exactly; the first valid
    one wins, and a masked slot before it that names that row too does
    not."""
    gen = torch.Generator().manual_seed(k)
    n, f = 400, 64
    tx, bd, _, _ = _score_inputs(n, k, f, 50, dtype, gen, cuda)
    idx = torch.randint(0, 3, (n, k), generator=gen,
                        dtype=torch.int32).to(cuda)   # many repeats
    mask = (torch.rand(n, k, generator=gen) < 0.7).to(cuda)
    mask[:, 0] = False                         # a masked slot first
    idx[:, 0] = idx[:, k - 1]
    mx, slot = _assert_score_matches(tx, bd, idx, mask)
    has = mask.any(1)
    assert (slot[has] > 0).all()
    picked = idx[has].gather(1, slot[has, None].long())[:, 0]
    for j in range(1, k):
        earlier = (j < slot[has]) & mask[has, j]
        assert not (earlier & (idx[has, j] == picked)).any()


def test_score_kernel_empty_rows_and_masked_sentinel(cuda):
    """All-masked rows give (-1e30, -1); a valid slot whose dot lies below
    -1e30 loses to the first masked slot's -1e30."""
    tx = torch.full((3, 4), 1e20, device=cuda)
    bd = torch.stack([torch.full((4,), -1e20), torch.ones(4)]).to(cuda)
    idx = torch.tensor([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=torch.int32,
                       device=cuda)
    mask = torch.tensor([[True, False, False], [True, False, True],
                         [False, False, False]], device=cuda)
    mx, slot = _assert_score_matches(tx, bd, idx, mask)
    assert slot.tolist() == [1, 2, -1]
    assert torch.equal(mx, torch.tensor([-1e30, 4e20, -1e30], device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_score_kernel_runs_repeat_bit_for_bit(cuda, dtype):
    gen = torch.Generator().manual_seed(5)
    args = _score_inputs(16_128, 4, 64, 832, dtype, gen, cuda)
    a, b = score_max(*args), score_max(*args)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_launch_counters_count_kernel_launches_only(cuda):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(50, 64, generator=gen)
    idx, mask = _table(50, 4, 50, gen, "cpu")
    att = torch.randn(2, 32, generator=gen)
    e0 = dict(edge_stage_fwd.launches)
    b0 = dict(edge_stage_bwd.launches)
    s0 = score_max.launches
    _, alpha = edge_stage_fwd(x, x, att, idx, mask, 2)  # CPU: plain version
    edge_stage_bwd(x, x, att, idx, mask, alpha, x, 2)
    score_max(x, x, idx, mask)
    assert (edge_stage_fwd.launches, edge_stage_bwd.launches,
            score_max.launches) == (e0, b0, s0)
    xc, ic, mc = x.to(cuda), idx.to(cuda), mask.to(cuda)
    _, ac = edge_stage_fwd(xc, xc, att.to(cuda), ic, mc, 2, seed=(1, 2),
                           rate=0.2)
    edge_stage_bwd(xc, xc, att.to(cuda), ic, mc, ac, xc, 2, seed=(1, 2),
                   rate=0.2)
    score_max(xc, xc, ic, mc)
    assert edge_stage_fwd.launches == dict(e0, prng=e0["prng"] + 1)
    assert edge_stage_bwd.launches == dict(b0, prng=b0["prng"] + 1)
    assert score_max.launches == s0 + 1


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn(10, 64, device=cuda)
    idx = torch.zeros(10, 4, dtype=torch.int32, device=cuda)
    mask = torch.ones(10, 4, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        edge_stage_fwd(x, x, torch.randn(2, 32, device=cuda), idx.cpu(),
                       mask.cpu(), 2)
    with pytest.raises(TypeError):
        score_max(x.half(), x.half(), idx, mask)


# ---------------------------------------------------------------------
# dropout forward (K2, K4) and backward (K3, K4)
# ---------------------------------------------------------------------
SHAPES = [(128, 2), (48, 3), (512, 8)]


def _features(n, n_src, hc, heads, dtype, gen, cuda):
    xl = torch.randn(n_src, hc, generator=gen).to(dtype).to(cuda)
    xr = torch.randn(n, hc, generator=gen).to(dtype).to(cuda)
    att = torch.randn(heads, hc // heads, generator=gen).to(dtype).to(cuda)
    return xl, xr, att


def _dropout(mode, rate, n, k, heads, gen, cuda):
    if mode == "prng":
        w = torch.randint(0, 2**32, (2,), generator=gen, dtype=torch.int64)
        return dict(seed=(int(w[0]), int(w[1])), rate=rate)
    if mode == "keep":
        keep = (torch.rand(n, k, heads, generator=gen) < 0.8) / 0.8
        return dict(keep=keep.to(cuda))
    return {}


MODES = [("nokeep", 0.0), ("prng", 0.0), ("prng", 0.2), ("prng", 0.5),
         ("keep", 0.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hc,heads", SHAPES)
@pytest.mark.parametrize("k", [1, 4, 13, 40])
@pytest.mark.parametrize("mode,rate", MODES[1:])
def test_dropout_forward_kernel_matches_reference(cuda, mode, rate, k, hc,
                                                  heads, dtype):
    gen = torch.Generator().manual_seed(k * 7 + hc)
    n, n_src = 700, 500
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    kw = _dropout(mode, rate, n, k, heads, gen, cuda)
    out, alpha = edge_stage_fwd(xl, xr, att, idx, mask, heads, **kw)
    ref_out, ref_alpha = edge_stage_fwd_reference(xl, xr, att, idx, mask,
                                                  heads, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(alpha, ref_alpha, atol=1e-5, rtol=0)
    assert (out[:5] == 0).all() and (alpha[:5] == 0).all()


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_prng_keep_stream_equals_reference(cuda, rate):
    """One valid slot per row and all source rows ones: out is the keep
    multiplier itself, which must equal the plain hash bit for bit."""
    n, k, heads, ch = 4000, 13, 2, 64
    slot = torch.arange(n) % k
    idx = torch.zeros(n, k, dtype=torch.int32)
    mask = torch.zeros(n, k, dtype=torch.bool)
    mask[torch.arange(n), slot] = True
    xl = torch.ones(10, heads * ch, device=cuda)
    xr = torch.randn(n, heads * ch, device=cuda)
    att = torch.randn(heads, ch, device=cuda)
    seed = (0xDEADBEEF, 12345)
    out, _ = edge_stage_fwd(xl, xr, att, idx.to(cuda), mask.to(cuda), heads,
                            seed=seed, rate=rate)
    want = prng_keep_reference(seed, n, k, heads, rate)[torch.arange(n),
                                                         slot]
    got = out.cpu().view(n, heads, ch)[..., 0]
    assert torch.equal(got, want)
    assert abs((got == 0).float().mean().item() - rate) < 0.02


def _bwd_tol(dtype):
    return (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
            else dict(atol=2e-2, rtol=2e-2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hc,heads", SHAPES)
@pytest.mark.parametrize("k", [1, 4, 13, 40])
@pytest.mark.parametrize("mode,rate", MODES)
def test_backward_kernel_matches_reference(cuda, mode, rate, k, hc, heads,
                                           dtype):
    gen = torch.Generator().manual_seed(k * 11 + hc)
    n, n_src = 700, 500
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    kw = _dropout(mode, rate, n, k, heads, gen, cuda)
    _, alpha = edge_stage_fwd_reference(xl, xr, att, idx, mask, heads, **kw)
    go = torch.randn(n, hc, generator=gen).to(dtype).to(cuda)
    _check_backward(xl, xr, att, idx, mask, alpha, go, heads, mode, kw)


def _check_backward(xl, xr, att, idx, mask, alpha, go, heads, mode, kw):
    """The kernel against its plain version on one input: dg and dkeep
    elementwise, dxr and datt against their own scale, dg zero on masked
    slots and dxr zero on rows without a valid slot."""
    dtype = xl.dtype
    got = edge_stage_bwd(xl, xr, att, idx, mask, alpha, go, heads, **kw)
    want = edge_stage_bwd_reference(xl, xr, att, idx, mask, alpha, go,
                                    heads, **kw)
    torch.cuda.synchronize()
    tol = _bwd_tol(dtype)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    # dxr sums the K slots of a row, datt every slot of every row, in
    # another order than the plain version: each against its own scale
    for a, b in zip(got[1:3], want[1:3]):
        scale = b.float().abs().max().item() + 1e-9
        torch.testing.assert_close(
            a.float() / scale, b.float() / scale, rtol=0,
            atol=1e-5 if dtype == torch.float32 else 1e-2)
    if mode == "keep":
        torch.testing.assert_close(got[3].float(), want[3].float(), **tol)
    else:
        assert got[3] is None
    assert (got[0][~mask] == 0).all()
    assert (got[1][~mask.any(1)] == 0).all()


def _staging_limit(hc, heads, dtype, config=bwd_launch_config):
    """The largest K whose slots the kernel of ``config`` (the backward's
    by default) stages all at once."""
    k = 1
    while config(700, k + 1, hc, heads, dtype).slots == k + 1:
        k += 1
    return k


@pytest.mark.parametrize("mode,rate", [("prng", 0.2), ("keep", 0.0)])
@pytest.mark.parametrize("above", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_at_and_above_staging_limit(cuda, dtype, above,
                                                    mode, rate):
    """HC = 512: K at the staging limit (every slot staged once) and one
    above it (slots in chunks, the dg pass staging them again)."""
    hc, heads = 512, 8
    k = _staging_limit(hc, heads, dtype) + above
    assert (bwd_launch_config(700, k, hc, heads, dtype).slots < k) == above
    gen = torch.Generator().manual_seed(k * 17 + above)
    n, n_src = 700, 500
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    kw = _dropout(mode, rate, n, k, heads, gen, cuda)
    _, alpha = edge_stage_fwd_reference(xl, xr, att, idx, mask, heads, **kw)
    go = torch.randn(n, hc, generator=gen).to(dtype).to(cuda)
    _check_backward(xl, xr, att, idx, mask, alpha, go, heads, mode, kw)


@pytest.mark.parametrize("mode,rate", [MODES[0], MODES[2], MODES[4]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_ragged_blocks(cuda, dtype, mode, rate):
    """N not a multiple of the rows a block takes, more rows than one pass
    of the grid covers, and rows without a valid slot at the end of each
    block's rows and of the table."""
    hc, heads, k = 128, 2, 12
    n, n_src = 16 * 1024 + 37, 3_000
    cfg = bwd_launch_config(n, k, hc, heads, dtype)
    assert n % cfg.rows and n > cfg.rows * cfg.n_blocks
    gen = torch.Generator().manual_seed(29)
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    idx, mask = _table(n, k, n_src, gen, "cpu")
    rows = torch.arange(n)
    mask[(rows % cfg.rows == cfg.rows - 1) | (rows >= n - 10)] = False
    idx, mask = idx.to(cuda), mask.to(cuda)
    kw = _dropout(mode, rate, n, k, heads, gen, cuda)
    _, alpha = edge_stage_fwd_reference(xl, xr, att, idx, mask, heads, **kw)
    go = torch.randn(n, hc, generator=gen).to(dtype).to(cuda)
    _check_backward(xl, xr, att, idx, mask, alpha, go, heads, mode, kw)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("hc,heads", [(36, 3), (128, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_unaligned_rows(cuda, dtype, hc, heads, offset):
    """Rows that do not start on 16 bytes: HC = 36 (72 or 144 bytes), and
    tensors one element past an aligned base, so the kernel moves rows
    element by element."""
    gen = torch.Generator().manual_seed(hc + offset)
    n, n_src, k = 700, 500, 13

    def table(rows, fill):
        flat = torch.empty(rows * hc + offset, dtype=dtype, device=cuda)
        t = flat[offset:].view(rows, hc)
        t.copy_(fill.to(dtype))
        return t

    xl = table(n_src, torch.randn(n_src, hc, generator=gen))
    xr = table(n, torch.randn(n, hc, generator=gen))
    go = table(n, torch.randn(n, hc, generator=gen))
    att = torch.randn(heads, hc // heads, generator=gen).to(dtype).to(cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    kw = _dropout("prng", 0.2, n, k, heads, gen, cuda)
    _, alpha = edge_stage_fwd_reference(xl, xr, att, idx, mask, heads, **kw)
    _check_backward(xl, xr, att, idx, mask, alpha, go, heads, "prng", kw)


@pytest.mark.parametrize("mode,rate", [("nokeep", 0.0), ("prng", 0.2),
                                       ("keep", 0.0)])
def test_backward_kernel_repeats_bit_for_bit(cuda, mode, rate):
    gen = torch.Generator().manual_seed(3)
    n, n_src, k, hc, heads = 30_000, 20_000, 12, 128, 2
    xl, xr, att = _features(n, n_src, hc, heads, torch.bfloat16, gen, cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    kw = _dropout(mode, rate, n, k, heads, gen, cuda)
    _, alpha = edge_stage_fwd(xl, xr, att, idx, mask, heads, **kw)
    go = torch.randn(n, hc, generator=gen).to(torch.bfloat16).to(cuda)
    a = edge_stage_bwd(xl, xr, att, idx, mask, alpha, go, heads, **kw)
    b = edge_stage_bwd(xl, xr, att, idx, mask, alpha, go, heads, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2])
    assert (a[3] is None) == (mode != "keep")
    if mode == "keep":
        assert torch.equal(a[3], b[3])


# ---------------------------------------------------------------------
# the forward's row groups: staging limit, ragged blocks, unaligned rows,
# repeatability (K1, K2, K4 forward)
# ---------------------------------------------------------------------
def _check_forward(xl, xr, att, idx, mask, heads, kw):
    """The kernel against its plain version on one input: out at the
    forward's tolerance, alpha at 1e-5, both exactly 0 on rows without a
    valid slot."""
    out, alpha = edge_stage_fwd(xl, xr, att, idx, mask, heads, **kw)
    ref_out, ref_alpha = edge_stage_fwd_reference(xl, xr, att, idx, mask,
                                                  heads, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if xl.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(alpha, ref_alpha, atol=1e-5, rtol=0)
    empty = ~mask.any(1)
    assert (out[empty] == 0).all() and (alpha[empty] == 0).all()


@pytest.mark.parametrize("mode,rate", [MODES[0], MODES[2], MODES[4]])
@pytest.mark.parametrize("above", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_at_and_above_staging_limit(cuda, dtype, above, mode,
                                                   rate):
    """HC = 512: K at the forward's staging limit (every slot staged once)
    and one above it (slots in chunks, the output pass staging them
    again)."""
    hc, heads = 512, 8
    k = _staging_limit(hc, heads, dtype, fwd_launch_config) + above
    assert (fwd_launch_config(700, k, hc, heads, dtype).slots < k) == above
    gen = torch.Generator().manual_seed(k * 19 + above)
    n, n_src = 700, 500
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    # att at the 1/sqrt(C) scale of an initialized layer: with unit att,
    # 64-channel logits reach 40, where their f32 rounding alone (a few
    # 1e-6 in alpha, within its tolerance) moves an output that two slots
    # cancel by more than 1e-5
    att = att * (hc // heads) ** -0.5
    idx, mask = _table(n, k, n_src, gen, cuda)
    kw = _dropout(mode, rate, n, k, heads, gen, cuda)
    _check_forward(xl, xr, att, idx, mask, heads, kw)


@pytest.mark.parametrize("mode,rate", [MODES[0], MODES[2], MODES[4]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_ragged_blocks(cuda, dtype, mode, rate):
    """N not a multiple of the rows a block takes, more rows than one pass
    of the grid covers, and rows without a valid slot at the end of each
    block's rows and of the table."""
    hc, heads, k = 128, 2, 12
    n, n_src = 40 * 1024 + 37, 3_000
    cfg = fwd_launch_config(n, k, hc, heads, dtype)
    assert n % cfg.rows and n > cfg.rows * cfg.n_blocks
    gen = torch.Generator().manual_seed(31)
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    idx, mask = _table(n, k, n_src, gen, "cpu")
    rows = torch.arange(n)
    mask[(rows % cfg.rows == cfg.rows - 1) | (rows >= n - 10)] = False
    idx, mask = idx.to(cuda), mask.to(cuda)
    kw = _dropout(mode, rate, n, k, heads, gen, cuda)
    _check_forward(xl, xr, att, idx, mask, heads, kw)


@pytest.mark.parametrize("n", [700, 3_000])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("hc,heads", [(36, 3), (128, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernel_unaligned_rows(cuda, dtype, hc, heads, offset, n):
    """Rows that do not start on 16 bytes: HC = 36 (72 or 144 bytes), and
    tensors one element past an aligned base, so the kernel moves rows
    element by element; at 3,000 rows (K = 12) in bf16 in 16-byte
    chunks, two rows a warp."""
    gen = torch.Generator().manual_seed(hc + offset + n)
    n_src, k = 500, 13 if n < 2048 else 12

    def table(rows, fill):
        flat = torch.empty(rows * hc + offset, dtype=dtype, device=cuda)
        t = flat[offset:].view(rows, hc)
        t.copy_(fill.to(dtype))
        return t

    xl = table(n_src, torch.randn(n_src, hc, generator=gen))
    xr = table(n, torch.randn(n, hc, generator=gen))
    att = torch.randn(heads, hc // heads, generator=gen).to(dtype).to(cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    kw = _dropout("prng", 0.2, n, k, heads, gen, cuda)
    _check_forward(xl, xr, att, idx, mask, heads, kw)


@pytest.mark.parametrize("mode,rate", [("nokeep", 0.0), ("prng", 0.2),
                                       ("keep", 0.0)])
def test_forward_kernel_repeats_bit_for_bit(cuda, mode, rate):
    gen = torch.Generator().manual_seed(5)
    n, n_src, k, hc, heads = 30_000, 20_000, 12, 128, 2
    xl, xr, att = _features(n, n_src, hc, heads, torch.bfloat16, gen, cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    kw = _dropout(mode, rate, n, k, heads, gen, cuda)
    out_a, alpha_a = edge_stage_fwd(xl, xr, att, idx, mask, heads, **kw)
    out_b, alpha_b = edge_stage_fwd(xl, xr, att, idx, mask, heads, **kw)
    assert torch.equal(out_a, out_b) and torch.equal(alpha_a, alpha_b)


# ---------------------------------------------------------------------
# fused attention (K6) and the banded edge stage (K7)
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hc,heads", [(128, 2), (32, 1)] + SHAPES[1:])
@pytest.mark.parametrize("k", [1, 4, 13, 40])
def test_gatv2_attention_kernel_matches_reference(cuda, k, hc, heads, dtype):
    gen = torch.Generator().manual_seed(k * 13 + hc)
    n, n_src = 700, 500
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    bias = torch.randn(hc, generator=gen).to(cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    out = gatv2_attention(xl, xr, idx, mask, att, bias, heads)
    ref = gatv2_attention_reference(xl, xr, idx, mask, att, bias, heads)
    torch.cuda.synchronize()
    # f32: one arithmetic, other summation order; bf16: the same bf16
    # logits (one summation order), then an f32 sum that may round to the
    # neighbouring bf16 value
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(out[:5], bias.to(dtype).expand(5, hc))


def _strip_major_table(n, seed, k=8):
    import numpy as np

    from segger_tpu_torch.data.neighbors_host import kdtree_neighbors
    from segger_tpu_torch.data.partition import _strip_major_order
    from segger_tpu_torch.ops.padded_csr import coo_to_padded_csr

    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 600.0 * (n / 50_000) ** 0.5, (n, 2))
    pos = pos[_strip_major_order(pos)]
    src, dst = kdtree_neighbors(pos, max_k=5, max_dist=5.0)
    return coo_to_padded_csr(dst, src, n_dst=n, k=k)


@pytest.mark.parametrize("hc,heads", [(128, 2), (48, 3)])
@pytest.mark.parametrize("n", [3_000, 20_000])
def test_banded_kernel_matches_reference(cuda, n, hc, heads):
    csr = _strip_major_table(n, seed=n + hc)
    lo, idxl, mask, ok = band_graph(csr, n_src=n)
    assert ok
    gen = torch.Generator().manual_seed(n)
    n_pad = idxl.shape[0]
    xl, xr, att = _features(n_pad, n, hc, heads, torch.float32, gen, cuda)
    bias = torch.randn(hc, generator=gen).to(cuda)
    args = (xl, xr, torch.from_numpy(lo).to(cuda),
            torch.from_numpy(idxl).to(cuda), torch.from_numpy(mask).to(cuda),
            att, bias, heads)
    out = banded_edge_stage(*args)
    ref = banded_edge_stage_reference(*args)
    k6 = gatv2_attention(xl, xr[:n], torch.from_numpy(csr.idx).to(cuda),
                         torch.from_numpy(csr.mask).to(cuda), att, bias,
                         heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[:n], k6, atol=1e-5, rtol=1e-5)
    assert torch.equal(out[n:], bias.expand(n_pad - n, hc))


def test_attention_launch_counters_and_checks(cuda):
    gen = torch.Generator().manual_seed(1)
    n = 512
    idx, mask = _table(n, 16, n, gen, "cpu")
    x = torch.randn(n, 64, generator=gen)
    att, bias = torch.randn(2, 32, generator=gen), torch.randn(64)
    lo = torch.zeros(n // 256, dtype=torch.int32)
    a0, b0 = gatv2_attention.launches, banded_edge_stage.launches
    gatv2_attention(x, x, idx, mask, att, bias, 2)          # CPU: plain
    banded_edge_stage(x, x, lo, idx, mask, att, bias, 2)
    assert (gatv2_attention.launches, banded_edge_stage.launches) == (a0, b0)
    xc, ic, mc, ac, bc, lc = (t.to(cuda) for t in (x, idx, mask, att, bias,
                                                   lo))
    gatv2_attention(xc, xc, ic, mc, ac, bc, 2)
    banded_edge_stage(xc, xc, lc, ic, mc, ac, bc, 2)
    assert (gatv2_attention.launches, banded_edge_stage.launches) == (
        a0 + 1, b0 + 1)
    with pytest.raises(ValueError):          # no mixing devices
        gatv2_attention(xc, xc, idx, mask, ac, bc, 2)
    with pytest.raises(TypeError):           # the banded op is float32
        banded_edge_stage(xc.bfloat16(), xc.bfloat16(), lc, ic, mc,
                          ac.bfloat16(), bc, 2)


def _check_attention(xl, xr, idx, mask, att, bias, heads):
    """K6 against its plain version on one input, at phase 2c's
    tolerance; rows without a valid slot exactly the bias.  Returns the
    kernel's output."""
    out = gatv2_attention(xl, xr, idx, mask, att, bias, heads)
    ref = gatv2_attention_reference(xl, xr, idx, mask, att, bias, heads)
    torch.cuda.synchronize()
    tol = 1e-5 if xl.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    empty = ~mask.any(1)
    assert torch.equal(out[empty],
                       bias.to(xl.dtype).expand(int(empty.sum()), -1))
    return out


@pytest.mark.parametrize("above", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_at_and_above_staging_limit(cuda, dtype, above):
    """HC = 512: K at the attention kernel's staging limit (every slot
    staged once) and one above it (slots in chunks, the output pass
    staging them again)."""
    hc, heads = 512, 8
    k = _staging_limit(hc, heads, dtype, attn_launch_config) + above
    assert (attn_launch_config(700, k, hc, heads, dtype).slots < k) == above
    gen = torch.Generator().manual_seed(k * 23 + above)
    n, n_src = 700, 500
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    att = att * (hc // heads) ** -0.5       # an initialized layer's scale
    bias = torch.randn(hc, generator=gen).to(cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    _check_attention(xl, xr, idx, mask, att, bias, heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_ragged_blocks(cuda, dtype):
    """N not a multiple of the rows a block takes, more rows than one pass
    of the grid covers, and rows without a valid slot at the end of each
    block's rows and of the table."""
    hc, heads, k = 128, 2, 12
    n, n_src = 40 * 1024 + 37, 3_000
    cfg = attn_launch_config(n, k, hc, heads, dtype)
    assert n % cfg.rows and n > cfg.rows * cfg.n_blocks
    gen = torch.Generator().manual_seed(37)
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    bias = torch.randn(hc, generator=gen).to(cuda)
    idx, mask = _table(n, k, n_src, gen, "cpu")
    rows = torch.arange(n)
    mask[(rows % cfg.rows == cfg.rows - 1) | (rows >= n - 10)] = False
    _check_attention(xl, xr, idx.to(cuda), mask.to(cuda), att, bias, heads)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("hc,heads", [(36, 3), (128, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_unaligned_rows(cuda, dtype, hc, heads, offset):
    """Rows that do not start on a chunk: HC = 36 (72 or 144 bytes), and
    tensors one element past an aligned base, so the kernel moves rows
    element by element on its general path."""
    gen = torch.Generator().manual_seed(hc + offset + 41)
    n, n_src, k = 3_000, 500, 13

    def table(rows, fill):
        flat = torch.empty(rows * hc + offset, dtype=dtype, device=cuda)
        t = flat[offset:].view(rows, hc)
        t.copy_(fill.to(dtype))
        return t

    xl = table(n_src, torch.randn(n_src, hc, generator=gen))
    xr = table(n, torch.randn(n, hc, generator=gen))
    att = torch.randn(heads, hc // heads, generator=gen).to(dtype).to(cuda)
    bias = torch.randn(hc, generator=gen).to(cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    _check_attention(xl, xr, idx, mask, att, bias, heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_repeats_bit_for_bit(cuda, dtype):
    gen = torch.Generator().manual_seed(43)
    n, n_src, k, hc, heads = 30_000, 20_000, 12, 128, 2
    xl, xr, att = _features(n, n_src, hc, heads, dtype, gen, cuda)
    bias = torch.randn(hc, generator=gen).to(cuda)
    idx, mask = _table(n, k, n_src, gen, cuda)
    a = gatv2_attention(xl, xr, idx, mask, att, bias, heads)
    b = gatv2_attention(xl, xr, idx, mask, att, bias, heads)
    assert torch.equal(a, b)


def test_banded_kernel_repeats_and_equals_attention(cuda):
    """K7 twice and K6 on the same strip-major table: K7 bit-equal over
    two runs and within 1e-6 of K6, which reads the same sources."""
    n, hc, heads = 20_000, 128, 2
    csr = _strip_major_table(n, seed=47)
    lo, idxl, mask, ok = band_graph(csr, n_src=n)
    assert ok
    gen = torch.Generator().manual_seed(47)
    n_pad = idxl.shape[0]
    xl, xr, att = _features(n_pad, n, hc, heads, torch.float32, gen, cuda)
    bias = torch.randn(hc, generator=gen).to(cuda)
    args = (xl, xr, torch.from_numpy(lo).to(cuda),
            torch.from_numpy(idxl).to(cuda), torch.from_numpy(mask).to(cuda),
            att, bias, heads)
    a, b = banded_edge_stage(*args), banded_edge_stage(*args)
    k6 = gatv2_attention(xl, xr[:n], torch.from_numpy(csr.idx).to(cuda),
                         torch.from_numpy(csr.mask).to(cuda), att, bias,
                         heads)
    assert torch.equal(a, b)
    torch.testing.assert_close(a[:n], k6, atol=1e-6, rtol=1e-6)
