"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Skipped without a CUDA device; on one, run (the JAX-pinning
conftest is not needed):

    python -m pytest --noconftest -m gpu tests/test_torch_port_kernels.py
"""
import pytest
import torch

from segger_tpu_torch.ops.postgather import (
    edge_stage_fwd, edge_stage_fwd_reference,
)
from segger_tpu_torch.ops.score import score_max, score_max_reference

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


def test_launch_counters_count_kernel_launches_only(cuda):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(50, 64, generator=gen)
    idx, mask = _table(50, 4, 50, gen, "cpu")
    att = torch.randn(2, 32, generator=gen)
    e0, s0 = edge_stage_fwd.launches, score_max.launches
    edge_stage_fwd(x, x, att, idx, mask, 2)            # CPU: plain version
    score_max(x, x, idx, mask)
    assert (edge_stage_fwd.launches, score_max.launches) == (e0, s0)
    xc, ic, mc = x.to(cuda), idx.to(cuda), mask.to(cuda)
    edge_stage_fwd(xc, xc, att.to(cuda), ic, mc, 2)
    score_max(xc, xc, ic, mc)
    assert (edge_stage_fwd.launches, score_max.launches) == (e0 + 1, s0 + 1)


def test_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn(10, 64, device=cuda)
    idx = torch.zeros(10, 4, dtype=torch.int32, device=cuda)
    mask = torch.ones(10, 4, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        edge_stage_fwd(x, x, torch.randn(2, 32, device=cuda), idx.cpu(),
                       mask.cpu(), 2)
    with pytest.raises(TypeError):
        score_max(x.half(), x.half(), idx, mask)
