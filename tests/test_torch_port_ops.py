"""Port ops against the JAX package: padded-CSR builders, the edge-stage
and scoring kernels' plain versions (against the Pallas kernels in
interpret mode), and the scoring chain.

Inputs are made with numpy from a seed and handed to both frameworks;
the port runs on the CPU, where its kernel wrappers take the plain
PyTorch versions.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segger_tpu.ops import padded_csr as jcsr
from segger_tpu.ops import gather_agg as jga
from segger_tpu.ops import edge_stage as jes
from segger_tpu.ops.pallas import postgather as jpg
from segger_tpu.ops.pallas import score as jsc

from segger_tpu_torch.data.graph import TileGraph
from segger_tpu_torch.data.assemble import HostGraph
from segger_tpu_torch.ops import padded_csr as tcsr
from segger_tpu_torch.ops import gather_agg as tga
from segger_tpu_torch.ops.edge_stage import gatv2_edge_stage_flat
from segger_tpu_torch.ops.embed import embed_lookup
from segger_tpu_torch.ops.postgather import (
    edge_stage_fwd, edge_stage_fwd_reference,
)
from segger_tpu_torch.ops.score import score_max, score_max_reference

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ---------------------------------------------------------------------
# converters shared with the other port test files
# ---------------------------------------------------------------------
def port_csr(c):
    return None if c is None else tcsr.PaddedCSR(
        np.asarray(c.idx), np.asarray(c.mask))


def port_tile(jtile) -> TileGraph:
    """A JAX TileGraph (NumPy or jax arrays) as a NumPy port TileGraph."""
    kw = {}
    for f in dataclasses.fields(TileGraph):
        v = getattr(jtile, f.name)
        if isinstance(v, jcsr.PaddedCSR):
            kw[f.name] = port_csr(v)
        elif v is None or isinstance(v, (bool, int)):
            kw[f.name] = v
        else:
            kw[f.name] = np.asarray(v)
    return TileGraph(**kw)


def port_host_graph(g) -> HostGraph:
    return HostGraph(**{f.name: getattr(g, f.name)
                        for f in dataclasses.fields(HostGraph)})


def assert_csr_equal(a, b):
    for name in ("idx", "mask"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    a = jnp.asarray(a)
    return a if dtype is None else a.astype(dtype)


# ---------------------------------------------------------------------
# padded CSR
# ---------------------------------------------------------------------
@pytest.mark.parametrize("k,pad", [(None, 1), (None, 8), (3, 4)])
def test_padded_csr_builders_field_exact(k, pad):
    rng = np.random.default_rng(11)
    n_dst, n_src = 70, 90
    dst = rng.integers(0, n_dst, 400)
    src = rng.integers(0, n_src, 400)
    a = tcsr.coo_to_padded_csr(dst, src, n_dst, k=k, pad_to_multiple=pad)
    b = jcsr.coo_to_padded_csr(dst, src, n_dst, k=k, pad_to_multiple=pad)
    assert_csr_equal(a, b)
    assert_csr_equal(
        tcsr.transpose_csr(a, n_src=n_src, pad_to_multiple=pad),
        jcsr.transpose_csr(b, n_src=n_src, pad_to_multiple=pad),
    )
    empty = np.zeros(0, np.int64)
    assert_csr_equal(tcsr.coo_to_padded_csr(empty, empty, 5, k=k),
                     jcsr.coo_to_padded_csr(empty, empty, 5, k=k))


def test_transpose_csr_raises_on_truncation():
    csr = tcsr.coo_to_padded_csr(np.array([0, 1, 2]), np.zeros(3), 3)
    with pytest.raises(ValueError):
        tcsr.transpose_csr(csr, n_src=1, k=2)


# ---------------------------------------------------------------------
# edge stage (K1)
# ---------------------------------------------------------------------
def _edge_case(k, seed, n=200, n_src=300, heads=2, ch=16):
    """Random padded table with isolated rows and real rows of every
    degree up to k, plus features."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, k + 1, n)
    deg[:7] = 0
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n_src, dst.size)
    csr = jcsr.coo_to_padded_csr(dst, src, n, k=k)
    hc = heads * ch
    xl = rng.normal(size=(n_src, hc)).astype(np.float32)
    xr = rng.normal(size=(n, hc)).astype(np.float32)
    att = rng.normal(size=(heads, ch)).astype(np.float32)
    return csr, xl, xr, att, heads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [4, 8, 13])
def test_edge_stage_reference_matches_pallas(k, dtype):
    csr, xl, xr, att, heads = _edge_case(k, seed=k)
    jdt, tdt = _DT[dtype]
    csr_t = jcsr.transpose_csr(csr, n_src=xl.shape[0])
    jc = jax.tree.map(jnp.asarray, csr)
    jct = jax.tree.map(jnp.asarray, csr_t)
    out_j, res = jpg._fwd_rule(
        _j(xl, jdt), _j(xr, jdt), _j(att, jdt), jpg.no_dropout_keep(heads),
        jc, jct, (heads, 0.2, True),
    )
    alpha_j = np.asarray(res[1])[: xr.shape[0]]
    out_t, alpha_t = edge_stage_fwd(
        _t(xl, tdt), _t(xr, tdt), _t(att, tdt), _t(csr.idx), _t(csr.mask),
        heads,
    )
    assert out_t.dtype == tdt and alpha_t.dtype == torch.float32
    out_j = np.asarray(out_j.astype(jnp.float32))
    # f32: same arithmetic, other summation order.  bf16: the port rounds
    # p and s to bf16 as the TPU kernel does, XLA may fuse differently
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(
        atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out_t.float().numpy(), out_j, **tol)
    np.testing.assert_allclose(alpha_t.numpy(), alpha_j, **tol)
    empty = ~csr.mask.any(1)
    assert empty.sum() >= 7
    assert (out_t.float().numpy()[empty] == 0).all()
    assert (alpha_t.numpy()[empty] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_stage_flat_matches_jax(dtype):
    csr, xl, xr, att, heads = _edge_case(8, seed=3)
    jdt, tdt = _DT[dtype]
    keep = jnp.ones((*csr.idx.shape, heads), jdt)
    jc = jax.tree.map(jnp.asarray, csr)
    want = jes.gatv2_edge_stage_flat(
        _j(xl, jdt), _j(xr, jdt), _j(att, jdt), keep, jc, None, (heads, 0.2))
    got = gatv2_edge_stage_flat(
        _t(xl, tdt), _t(xr, tdt), _t(att, tdt), port_csr(csr).to("cpu"),
        (heads, 0.2))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(
        atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_edge_stage_wrapper_rejects_bad_shapes():
    csr, xl, xr, att, heads = _edge_case(4, seed=1)
    args = (_t(xl), _t(xr), _t(att), _t(csr.idx), _t(csr.mask))
    with pytest.raises(ValueError):
        edge_stage_fwd(*args, heads=3)               # HC % H != 0
    big = torch.zeros(xl.shape[0], 1024)
    with pytest.raises(ValueError):
        edge_stage_fwd(big, torch.zeros(xr.shape[0], 1024),
                       torch.zeros(2, 512), *args[3:], heads=2)
    with pytest.raises(TypeError):
        edge_stage_fwd(args[0].double(), *args[1:], heads=heads)
    with pytest.raises(TypeError):
        edge_stage_fwd(*args[:3], args[3].long(), args[4], heads=heads)


# ---------------------------------------------------------------------
# scoring (K5)
# ---------------------------------------------------------------------
def _score_case(seed, n=300, n_bd=40, k=4, f=32):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, k + 1, n)
    deg[:5] = 0
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n_bd, src.size)
    cand = jcsr.coo_to_padded_csr(src, dst, n, k=k)

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
            np.float32)

    tx = unit(rng.normal(size=(n, f)))
    bd = unit(rng.normal(size=(n_bd, f)))
    bd_index = rng.permutation(1000)[:n_bd].astype(np.int32)
    return cand, tx, bd, bd_index


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_reference_matches_pallas(dtype):
    cand, tx, bd, _ = _score_case(seed=7)
    jdt, tdt = _DT[dtype]
    mx_j, slot_j = jsc.score_max_pallas(
        _j(tx, jdt), _j(bd, jdt), jax.tree.map(jnp.asarray, cand),
        interpret=True)
    mx_t, slot_t = score_max(_t(tx, tdt), _t(bd, tdt), _t(cand.idx),
                             _t(cand.mask))
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_allclose(mx_t.numpy(), np.asarray(mx_j), atol=1e-6,
                               rtol=0)
    empty = ~cand.mask.any(1)
    assert (slot_t.numpy()[empty] == -1).all()
    assert (mx_t.numpy()[empty] == np.float32(-1e30)).all()


def test_score_reference_takes_first_max():
    tx = torch.ones(1, 4)
    bd = torch.tensor([[0.0, 0, 0, 0], [1, 1, 1, 1], [1, 1, 1, 1]])
    idx = torch.tensor([[0, 1, 2, 1]], dtype=torch.int32)
    mask = torch.tensor([[True, False, True, True]])
    mx, slot = score_max_reference(tx, bd, idx, mask)
    assert slot.item() == 2 and mx.item() == 4.0


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_candidates_matches_jax(normalized, dtype):
    cand, tx, bd, bd_index = _score_case(seed=9)
    if not normalized:
        tx, bd = tx * 3.0, bd * 0.5
    jdt, tdt = _DT[dtype]
    sim_j, seg_j = jga.score_candidates(
        _j(tx), _j(bd), jax.tree.map(jnp.asarray, cand), _j(bd_index),
        dtype=None if dtype == "float32" else jdt, normalized=normalized)
    sim_t, seg_t = tga.score_candidates(
        _t(tx), _t(bd), port_csr(cand).to("cpu"), _t(bd_index),
        dtype=None if dtype == "float32" else tdt, normalized=normalized)
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    np.testing.assert_allclose(sim_t.numpy(), np.asarray(sim_j), atol=1e-5,
                               rtol=0)


def test_csr_softmax_max_gather_match_jax():
    cand, tx, bd, _ = _score_case(seed=5, k=6)
    rng = np.random.default_rng(5)
    vals = rng.normal(size=cand.idx.shape).astype(np.float32)
    jc = jax.tree.map(jnp.asarray, cand)
    tc = port_csr(cand).to("cpu")
    np.testing.assert_allclose(
        tga.csr_softmax(_t(vals), tc).numpy(),
        np.asarray(jga.csr_softmax(_j(vals), jc)), atol=1e-6)
    mv_t, arg_t = tga.csr_max(_t(vals), tc)
    mv_j, arg_j = jga.csr_max(_j(vals), jc)
    np.testing.assert_array_equal(mv_t.numpy(), np.asarray(mv_j))
    np.testing.assert_array_equal(arg_t.numpy(), np.asarray(arg_j))
    np.testing.assert_array_equal(
        tga.csr_gather(_t(bd), tc).numpy(),
        np.asarray(jga.csr_gather(_j(bd), jc)))


def test_embed_lookup_wraps_negative_ids_like_jax():
    from segger_tpu.ops.embed import embed_lookup as jembed

    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([0, 3, -1, 2], np.int32)
    np.testing.assert_array_equal(
        embed_lookup(_t(table), _t(ids)).numpy(),
        np.asarray(jembed(_j(table), _j(ids))))


# ---------------------------------------------------------------------
# edge stage with dropout (K2, K4 forward) and backward (K3, K4)
# ---------------------------------------------------------------------
from segger_tpu_torch.ops import postgather as tpg  # noqa: E402


def _seed_words(key):
    """JAX's seed operand and the same two words as ints."""
    seed = jpg.prng_dropout_seed(jax.random.PRNGKey(key))
    return seed, tuple(int(w) for w in np.asarray(seed).view(np.uint32))


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_prng_keep_stream_bit_equal_to_pallas(rate):
    """Every row has one valid slot, at a varying position, and all
    source rows are ones: alpha = 1 and out = keep, so the recovered
    keep patterns of the two kernels must be equal."""
    n, k, heads, ch = 300, 7, 3, 4
    hc = heads * ch
    slot = np.arange(n) % k
    idx = np.zeros((n, k), np.int32)
    idx[np.arange(n), slot] = np.arange(n) % 50
    mask = np.zeros((n, k), bool)
    mask[np.arange(n), slot] = True
    csr = jcsr.PaddedCSR(idx=idx, mask=mask)
    csr_t = jcsr.transpose_csr(csr, n_src=50)
    rng = np.random.default_rng(1)
    xl = np.ones((50, hc), np.float32)
    xr = rng.normal(size=(n, hc)).astype(np.float32)
    att = rng.normal(size=(heads, ch)).astype(np.float32)
    seed, words = _seed_words(11)
    out_j = np.asarray(jpg.gatv2_edge_stage_pallas(
        _j(xl), _j(xr), _j(att), seed, jax.tree.map(jnp.asarray, csr),
        jax.tree.map(jnp.asarray, csr_t), (heads, 0.2, True, rate)))
    out_t, alpha_t = edge_stage_fwd(_t(xl), _t(xr), _t(att), _t(idx),
                                    _t(mask), heads, seed=words, rate=rate)
    np.testing.assert_array_equal(alpha_t.numpy()[mask], 1.0)
    keep_j = out_j.reshape(n, heads, ch)[..., 0]
    keep_t = out_t.numpy().reshape(n, heads, ch)[..., 0]
    np.testing.assert_array_equal(keep_t, keep_j)
    want = tpg.prng_keep_reference(words, n, k, heads, rate).numpy()
    np.testing.assert_array_equal(keep_t, want[np.arange(n), slot])
    dropped = (keep_t == 0).mean()
    assert abs(dropped - rate) < 0.08, dropped


def test_prng_hash_matches_jax_mix32_past_int32_wrap():
    pos = np.arange(2**31 - 300, 2**31 + 300, dtype=np.int64)
    pos32 = pos.astype(np.uint32).view(np.int32)
    seed, words = _seed_words(5)
    s = jax.lax.bitcast_convert_type(seed, jnp.int32)
    x = jpg._mix32(jnp.asarray(pos32) ^ s[0])
    x = jpg._mix32(x ^ (s[1] + jnp.int32(-1640531527)))
    want = np.asarray(x).view(np.uint32).astype(np.int64)
    got = tpg.prng_hash(torch.from_numpy(pos), words).numpy()
    np.testing.assert_array_equal(got, want)


def _keep_case(mode, n, k, heads, seed_key=3, rate=0.3):
    """JAX keep operand, its config and the port's keyword arguments."""
    if mode == "nokeep":
        return jpg.no_dropout_keep(heads), (heads, 0.2, True), {}
    if mode == "prng":
        seed, words = _seed_words(seed_key)
        return seed, (heads, 0.2, True, rate), dict(seed=words, rate=rate)
    keep = ((np.random.default_rng(seed_key).uniform(size=(n, k, heads))
             < 0.7) / 0.7).astype(np.float32)
    return _j(keep), (heads, 0.2, True), dict(keep=_t(keep))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prng", "keep"])
def test_dropout_forward_matches_pallas(mode, dtype):
    csr, xl, xr, att, heads = _edge_case(8, seed=21)
    jdt, tdt = _DT[dtype]
    km, cfg, kw = _keep_case(mode, *csr.idx.shape, heads)
    csr_t = jcsr.transpose_csr(csr, n_src=xl.shape[0])
    out_j, res = jpg._fwd_rule(
        _j(xl, jdt), _j(xr, jdt), _j(att, jdt), km,
        jax.tree.map(jnp.asarray, csr), jax.tree.map(jnp.asarray, csr_t), cfg)
    alpha_j = np.asarray(res[1])[: xr.shape[0]]
    out_t, alpha_t = edge_stage_fwd(
        _t(xl, tdt), _t(xr, tdt), _t(att, tdt), _t(csr.idx), _t(csr.mask),
        heads, **kw)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               atol=atol)
    np.testing.assert_allclose(alpha_t.numpy(), alpha_j, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["nokeep", "prng", "keep"])
def test_edge_stage_backward_matches_pallas_vjp(mode, dtype):
    """dxl, dxr, datt (and dkeep) of the autograd function against
    ``jax.vjp`` of the Pallas op, on a bucket segment with its
    transpose table, each scaled by its largest value."""
    csr, xl, xr, att, heads = _edge_case(13, seed=17, n=150, n_src=120)
    jdt, tdt = _DT[dtype]
    n, k = csr.idx.shape
    km, cfg, kw = _keep_case(mode, n, k, heads)
    csr_t = jcsr.transpose_csr(csr, n_src=xl.shape[0])
    go = np.random.default_rng(2).normal(size=xr.shape).astype(np.float32)
    jc, jct = (jax.tree.map(jnp.asarray, c) for c in (csr, csr_t))
    args = [_j(xl, jdt), _j(xr, jdt), _j(att, jdt)]
    if mode == "keep":
        args.append(km.astype(jdt))

    def f(*a):
        keep = a[3] if mode == "keep" else km
        return jpg.gatv2_edge_stage_pallas(a[0], a[1], a[2], keep, jc, jct,
                                           cfg)

    _, vjp = jax.vjp(f, *args)
    want = vjp(_j(go, jdt))
    xs = [_t(a, tdt).requires_grad_() for a in (xl, xr, att)]
    if mode == "keep":
        kw["keep"] = kw["keep"].to(tdt).requires_grad_()
    out = tpg.gatv2_edge_stage(
        *xs, _t(csr.idx), _t(csr.mask), heads, csr_t=port_csr(csr_t).to(
            "cpu"), **kw)
    out.backward(_t(go, tdt))
    got = [x.grad for x in xs] + ([kw["keep"].grad] if mode == "keep"
                                  else [])
    atol = 3e-5 if dtype == "float32" else 3e-2
    for name, a, b in zip(("dxl", "dxr", "datt", "dkeep"), want, got):
        a = np.asarray(a.astype(jnp.float32))
        scale = float(np.abs(a).max()) + 1e-9
        np.testing.assert_allclose(b.float().numpy() / scale, a / scale,
                                   atol=atol, err_msg=name)


def test_edge_stage_bwd_reference_zero_on_masked_slots():
    csr, xl, xr, att, heads = _edge_case(6, seed=4)
    args = (_t(xl), _t(xr), _t(att), _t(csr.idx), _t(csr.mask))
    _, alpha = edge_stage_fwd(*args, heads)
    go = torch.randn(xr.shape, generator=torch.Generator().manual_seed(0))
    dg, dxr, _, dkeep = tpg.edge_stage_bwd(*args, alpha, go, heads)
    assert dkeep is None
    assert (dg[~_t(csr.mask)] == 0).all()
    empty = ~csr.mask.any(1)
    assert (dxr[_t(empty)] == 0).all()


def test_transpose_gather_matches_index_add():
    csr, xl, *_ = _edge_case(5, seed=8)
    n, k = csr.idx.shape
    dg = torch.randn(n, k, 16, generator=torch.Generator().manual_seed(1))
    dg[~_t(csr.mask)] = 0
    csr_t = jcsr.transpose_csr(csr, n_src=xl.shape[0])
    got = tpg.transpose_gather(dg, xl.shape[0], _t(csr_t.idx),
                               _t(csr_t.mask))
    m = _t(csr.mask)
    want = torch.zeros(xl.shape[0], 16).index_add_(
        0, _t(csr.idx).long()[m], dg[m])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="transpose"):
        tpg.transpose_gather(dg, xl.shape[0], None, None)


def test_embed_lookup_backward_matches_jax():
    from segger_tpu.ops.embed import embed_lookup as jembed

    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([0, 3, -1, 2, 3], np.int32)
    cot = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jembed(t, _j(ids)), _j(table))
    want = np.asarray(vjp(_j(cot))[0])
    t = _t(table).requires_grad_()
    embed_lookup(t, _t(ids)).backward(_t(cot))
    np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-6)
