"""The attention slice of the port against the JAX package: the fused
attention op (K6) and the banded edge stage (K7) with its host banding,
the unfused GATv2 path with attention capture, the encoder's
intermediates, the bd->tx conv and the PyG-semantics golden fixture.

Inputs are made with numpy from a seed and handed to both frameworks; the
port runs on the CPU, where its kernel wrappers take the plain versions.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segger_tpu.data.neighbors_host import kdtree_neighbors
from segger_tpu.models import ISTEncoder as JEncoder
from segger_tpu.models.gatv2 import GATv2Conv as JConv
from segger_tpu.ops import coo_to_padded_csr
from segger_tpu.ops.pallas import banded as jband
from segger_tpu.ops.pallas import gatv2_attn as jattn

from segger_tpu_torch.models import ISTEncoder
from segger_tpu_torch.models.convert import params_from_flax, params_to_flax
from segger_tpu_torch.models.gatv2 import GATv2Conv
from segger_tpu_torch.models.positional import dense
from segger_tpu_torch.ops import (
    BLOCK, K_BAND, WINDOW, band_graph, banded_edge_stage, gatv2_attention,
)
from segger_tpu_torch.ops.padded_csr import PaddedCSR

from tests.test_torch_port_model import bucketed_tile  # noqa: F401
from tests.test_torch_port_ops import port_tile

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _flat(tree, prefix=""):
    """flax ``intermediates`` (nested dicts of one-element tuples) ->
    ``{"conv_0/tt/attention": array, ...}``."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(v[0])
    return out


# ---------------------------------------------------------------------
# K6: fused attention
# ---------------------------------------------------------------------
def _attn_case(heads, ch, k, n_src, n_dst, n_edges, seed=0):
    """``test_pallas.py``'s tables, plus an all-masked row (0) and a
    degree-1 row (1)."""
    rng = np.random.default_rng(seed)
    hc = heads * ch
    dst = rng.integers(2, n_dst, n_edges)
    src = rng.integers(0, n_src, n_edges)
    dst = np.concatenate([dst, [1]])
    src = np.concatenate([src, [rng.integers(0, n_src)]])
    csr = coo_to_padded_csr(dst, src, n_dst=n_dst, k=k)
    assert not csr.mask[0].any() and csr.mask[1].sum() == 1
    arrays = (rng.normal(size=(n_src, hc)), rng.normal(size=(n_dst, hc)),
              rng.normal(size=(heads, ch)), rng.normal(size=(hc,)))
    return csr, [a.astype(np.float32) for a in arrays]


class _Ref:
    """Stands in for the kernel's output ref: keeps what is stored."""

    def __setitem__(self, key, value):
        self.value = value


def _jax_kernel_body(xl, xr, idx, mask, att, bias, heads):
    """``gatv2_attn._kernel`` run eagerly on whole arrays, each op rounding
    to its dtype, its float32 result stored in xl's dtype.  (The JAX
    wrapper cannot take bfloat16: the kernel adds an f32 sum to the bias
    and Pallas refuses to store that into the bf16 output ref.)"""
    ref = _Ref()
    jattn._kernel(xl, xr, idx, mask, att, bias, ref, heads=heads,
                  ch=xl.shape[1] // heads, negative_slope=0.2)
    return ref.value.astype(xl.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,ch,k,n_src,n_dst,n_edges,block", [
    (2, 16, 8, 300, 256, 900, 64),
    (1, 32, 4, 300, 256, 900, 64),
    (2, 8, 4, 50, 37, 100, 16),          # rows not a multiple of the block
])
def test_gatv2_attention_matches_pallas(heads, ch, k, n_src, n_dst, n_edges,
                                        block, dtype):
    csr, (xl, xr, att, bias) = _attn_case(heads, ch, k, n_src, n_dst,
                                          n_edges)
    jdt, tdt = _DT[dtype]
    jargs = (jnp.asarray(xl, jdt), jnp.asarray(xr, jdt),
             jnp.asarray(csr.idx), jnp.asarray(csr.mask),
             jnp.asarray(att, jdt), jnp.asarray(bias))
    got = gatv2_attention(_t(xl, tdt), _t(xr, tdt), _t(csr.idx),
                          _t(csr.mask), _t(att, tdt), _t(bias), heads)
    assert got.dtype == tdt and got.shape == (n_dst, heads * ch)
    if dtype == "float32":
        want = jattn.gatv2_attention(*jargs, heads=heads, block_rows=block,
                                     interpret=True)
        tol = dict(rtol=1e-4, atol=1e-5)
        # no valid slot: the bias, exactly
        assert torch.equal(got[0], _t(bias))
    else:
        want = _jax_kernel_body(*jargs, heads)
        tol = dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_gatv2_attention_rejects_bad_inputs():
    csr, (xl, xr, att, bias) = _attn_case(2, 8, 4, 50, 37, 100)
    args = [_t(xl), _t(xr), _t(csr.idx), _t(csr.mask), _t(att), _t(bias)]
    with pytest.raises(TypeError):           # mixed feature dtypes
        gatv2_attention(args[0], args[1].double(), *args[2:], 2)
    with pytest.raises(ValueError):          # H does not divide HC
        gatv2_attention(*args, 3)
    with pytest.raises(TypeError):           # idx not int32
        gatv2_attention(args[0], args[1], args[2].long(), *args[3:], 2)


# ---------------------------------------------------------------------
# K7: banded edge stage and its host banding
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def banded_setup():
    """``test_banded.py``'s strip-major kNN table."""
    rng = np.random.default_rng(0)
    n = 6000
    pos = rng.uniform(0, 200, (n, 2))
    strip = np.floor(pos[:, 1] / 5.0).astype(np.int64)
    pos = pos[np.lexsort((pos[:, 0], strip))]
    src, dst = kdtree_neighbors(pos, max_k=5, max_dist=5.0)
    return n, coo_to_padded_csr(dst, src, n_dst=n, k=8)


def _port(csr):
    return PaddedCSR(np.asarray(csr.idx), np.asarray(csr.mask))


def test_band_graph_matches_jax_strip_major(banded_setup):
    n, csr = banded_setup
    got = band_graph(_port(csr), n_src=n)
    want = jband.band_graph(csr, n_src=n)
    assert got[3] and want[3]
    assert (BLOCK, WINDOW, K_BAND) == (jband.BLOCK, jband.WINDOW,
                                       jband.K_BAND)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_band_graph_rejects_like_jax():
    rng = np.random.default_rng(3)
    n = 10000
    dst = np.repeat(np.arange(n), 2)
    wide = coo_to_padded_csr(dst, rng.integers(0, n, dst.size), n_dst=n, k=4)
    assert not band_graph(_port(wide), n_src=n)[3]
    assert not jband.band_graph(wide, n_src=n)[3]
    deep = coo_to_padded_csr(np.zeros(K_BAND + 1, np.int64),
                             np.arange(K_BAND + 1), n_dst=4)
    assert band_graph(_port(deep), n_src=n) == (None, None, None, False)
    assert not jband.band_graph(deep, n_src=n)[3]


def test_banded_edge_stage_matches_pallas(banded_setup):
    n, csr = banded_setup
    lo, idxl, mask, ok = band_graph(_port(csr), n_src=n)
    assert ok
    rng = np.random.default_rng(1)
    h, c = 2, 16
    hc = h * c
    n_pad = idxl.shape[0]
    xl = rng.normal(size=(n, hc)).astype(np.float32)
    xr = np.pad(rng.normal(size=(n, hc)).astype(np.float32),
                ((0, n_pad - n), (0, 0)))
    att = rng.normal(size=(h, c)).astype(np.float32)
    bias = rng.normal(size=(hc,)).astype(np.float32)
    want = jband.banded_edge_stage(
        jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(lo), jnp.asarray(idxl),
        jnp.asarray(mask), jnp.asarray(att), jnp.asarray(bias), heads=h,
        interpret=True)
    got = banded_edge_stage(_t(xl), _t(xr), _t(lo), _t(idxl), _t(mask),
                            _t(att), _t(bias), h)
    assert got.shape == (n_pad, hc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    # padded rows hold no valid slot: the bias
    assert torch.equal(got[n:], _t(bias).expand(n_pad - n, hc))
    # the op over the banded table is K6 over the global one
    k6 = gatv2_attention(_t(xl), _t(xr[:n]), _t(csr.idx), _t(csr.mask),
                         _t(att), _t(bias), h)
    np.testing.assert_allclose(got[:n].numpy(), k6.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_banded_edge_stage_rejects_bad_inputs(banded_setup):
    n, csr = banded_setup
    lo, idxl, mask, _ = band_graph(_port(csr), n_src=n)
    x = torch.zeros(idxl.shape[0], 32)
    args = (_t(lo), _t(idxl), _t(mask), torch.zeros(2, 16), torch.zeros(32))
    with pytest.raises(TypeError):           # float32 only
        banded_edge_stage(x.bfloat16(), x.bfloat16(), args[0], args[1],
                          args[2], args[3].bfloat16(), args[4], 2)
    with pytest.raises(ValueError):          # K must be K_BAND
        banded_edge_stage(x, x, args[0], args[1][:, :8].contiguous(),
                          args[2][:, :8].contiguous(), *args[3:], 2)
    with pytest.raises(ValueError):          # one window start per block
        banded_edge_stage(x, x, args[0][:-1], *args[1:], 2)


# ---------------------------------------------------------------------
# the unfused conv, attention capture and the encoder's intermediates
# ---------------------------------------------------------------------
def test_unfused_conv_matches_jax_capture():
    rng = np.random.default_rng(5)
    n_src, n_dst, f, heads, ch = 70, 40, 12, 2, 8
    dst = rng.integers(1, n_dst, 200)            # row 0: no in-edge
    csr = coo_to_padded_csr(dst, rng.integers(0, n_src, 200), n_dst=n_dst)
    x_src = rng.normal(size=(n_src, f)).astype(np.float32)
    x_dst = rng.normal(size=(n_dst, f)).astype(np.float32)
    jconv = JConv(ch, heads)
    jcsr = jax.tree.map(jnp.asarray, csr)
    params = jconv.init(jax.random.PRNGKey(1), x_src, x_dst, jcsr)
    want, state = jconv.apply(params, x_src, x_dst, jcsr,
                              capture_attention=True,
                              mutable=["intermediates"])
    conv = GATv2Conv(f, ch, heads)
    conv.load_state_dict(params_from_flax(params), strict=True)
    inter = {}
    with torch.no_grad():
        got = conv(_t(x_src), _t(x_dst), _port(csr).to("cpu"),
                   intermediates=inter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    alpha = inter["attention"].numpy()
    np.testing.assert_allclose(
        alpha, _flat(state["intermediates"])["attention"], rtol=1e-5,
        atol=1e-5)
    valid = csr.mask.any(1)
    np.testing.assert_allclose(alpha[valid].sum(1), 1.0, rtol=1e-6)
    assert (alpha[~valid] == 0).all()
    np.testing.assert_array_equal(got[0].numpy(),
                                  conv.bias.detach().numpy())


def test_unfused_dropout_after_capture():
    """Dropout acts on the coefficients after they are recorded: flax's
    ``Dropout`` (keep with p = 1 - rate, scale by 1 / p) with the mask
    drawn from a generator seeded with the call's two seed words."""
    rng = np.random.default_rng(6)
    n, f, heads, ch, rate = 400, 8, 2, 4, 0.25
    csr = coo_to_padded_csr(np.repeat(np.arange(n), 6),
                            rng.integers(0, n, 6 * n), n_dst=n)
    x = _t(rng.normal(size=(n, f)).astype(np.float32))
    conv = GATv2Conv(f, ch, heads, dropout=rate)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    table = _port(csr).to("cpu")
    det, drop = {}, {}
    with torch.no_grad():
        out0 = conv(x, x, table, intermediates=det)
        out1 = conv(x, x, table, deterministic=False, seeds=lambda: (7, 9),
                    intermediates=drop)
        alpha = det["attention"]
        keep = torch.rand(alpha.shape, generator=torch.Generator()
                          .manual_seed((7 << 32) | 9)) < 1 - rate
        g = dense(conv.lin_l, x)[table.idx.long()].view(n, -1, heads, ch)
        want = torch.einsum("nkh,nkhc->nhc",
                            torch.where(keep, alpha / (1 - rate), 0.0), g)
    assert torch.equal(alpha, drop["attention"])
    assert not torch.allclose(out0, out1)
    torch.testing.assert_close(out1, want.reshape(n, -1) + conv.bias)
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.02


HEADS, HIDDEN, OUT, N_MID, IN_CH, N_GENES = 2, 16, 16, 1, 8, 40


@pytest.fixture(scope="module")
def encoder_case(bucketed_tile):  # noqa: F811
    model = JEncoder(n_genes=N_GENES, in_channels=IN_CH,
                     hidden_channels=HIDDEN, out_channels=OUT,
                     n_mid_layers=N_MID, n_heads=HEADS)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jax.tree.map(jnp.asarray, bucketed_tile))
    tm = ISTEncoder(n_genes=N_GENES, n_bd_features=bucketed_tile.bd_x.shape[1],
                    in_channels=IN_CH, hidden_channels=HIDDEN,
                    out_channels=OUT, n_mid_layers=N_MID,
                    n_heads=HEADS).eval()
    tm.load_state_dict(params_from_flax(params), strict=True)
    return model, params, tm


@pytest.mark.parametrize("capture", [False, True])
def test_encoder_intermediates_match_jax(encoder_case, bucketed_tile,
                                         capture):  # noqa: F811
    model, params, tm = encoder_case
    out_j, state = model.apply(params, jax.tree.map(jnp.asarray,
                                                    bucketed_tile),
                               capture_attention=capture,
                               mutable=["intermediates"])
    want = _flat(state["intermediates"])
    inter = {}
    with torch.no_grad():
        out = tm(port_tile(bucketed_tile).to("cpu"),
                 capture_attention=capture, intermediates=inter)
    assert sorted(inter) == sorted(want)
    n_att = sum(key.endswith("attention") for key in inter)
    assert n_att == (2 * (2 + N_MID) if capture else 0)
    for key, v in inter.items():
        np.testing.assert_allclose(v.numpy(), want[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    for key in ("tx", "bd"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# the PyG-semantics golden fixture
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    import os

    import tests.fixtures.make_pyg_golden as gen

    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "pyg_golden.npz")
    g = np.load(path)
    tile = port_tile(gen.make_tile(
        {k.split("/", 1)[1]: g[k] for k in g.files if k.startswith("graph/")}
    )).to("cpu")
    flat = {k.split("/", 1)[1]: g[k] for k in g.files
            if k.startswith("params/")}
    tree = {}
    for key, v in flat.items():
        node = tree
        *path_, leaf = key.split("/")
        for p in path_:
            node = node.setdefault(p, {})
        node[leaf] = v
    dims = g["meta/dims"]
    tm = ISTEncoder(n_genes=int(dims[2]), n_bd_features=int(dims[3]),
                    in_channels=int(dims[5]), hidden_channels=int(dims[6]),
                    out_channels=int(dims[7]), n_mid_layers=int(dims[8]),
                    n_heads=int(dims[4])).eval()
    tm.load_state_dict(params_from_flax(tree), strict=True)
    return g, tile, tm, gen


@pytest.mark.parametrize("capture", [False, True])
def test_port_matches_pyg_golden(golden, capture):
    g, tile, tm, _ = golden
    inter = {}
    with torch.no_grad():
        out = tm(tile, capture_attention=capture, intermediates=inter)
    names = sorted(k.split("/", 1)[1] for k in g.files
                   if k.startswith("acts/"))
    assert len(names) >= 8
    for name in names:
        np.testing.assert_allclose(inter[name].numpy(), g[f"acts/{name}"],
                                   rtol=2e-4, atol=1e-5, err_msg=name)
    for key in ("tx", "bd"):
        np.testing.assert_allclose(out[key].numpy(), g[f"out/{key}"],
                                   rtol=2e-4, atol=1e-5)


def test_port_isolated_rows_are_bias(golden):
    _, tile, tm, gen = golden
    inter = {}
    with torch.no_grad():
        tm(tile, intermediates=inter)
    bias = tm.conv_0.tt.bias.detach().numpy()
    for i in gen.ISOLATED_TX:
        np.testing.assert_allclose(inter["layer0_tx"][i].numpy(), bias,
                                   atol=1e-6)


# ---------------------------------------------------------------------
# the bd->tx conv
# ---------------------------------------------------------------------
def test_bd_to_tx_conv_matches_jax():
    """``test_parity_quirks.py``'s bt tile: the port's bt conv agrees with
    JAX's, is live (bd features reach tx), and its weights go through
    ``params_from_flax`` / ``params_to_flax`` both ways."""
    from tests.test_model import make_tile

    tile = make_tile(np.random.default_rng(2))
    n_tx = tile.tx_gene.shape[0]
    bt = coo_to_padded_csr(np.arange(n_tx), np.arange(n_tx) % 10,
                           n_dst=n_tx, k=4)
    tile = tile.replace(bt=jax.tree.map(jnp.asarray, bt))
    model = JEncoder(n_genes=12, in_channels=8, hidden_channels=8,
                     out_channels=8, n_mid_layers=0, n_heads=1,
                     use_bd_to_tx=True)
    params = model.init(jax.random.PRNGKey(0), tile)
    want, state = model.apply(params, tile, mutable=["intermediates"])
    tm = ISTEncoder(n_genes=12, n_bd_features=tile.bd_x.shape[1],
                    in_channels=8, hidden_channels=8, out_channels=8,
                    n_mid_layers=0, n_heads=1, use_bd_to_tx=True).eval()
    tm.load_state_dict(params_from_flax(params), strict=True)
    back = params_to_flax(tm)
    np.testing.assert_array_equal(
        back["params"]["conv_0"]["bt"]["lin_l"]["kernel"],
        np.asarray(params["params"]["conv_0"]["bt"]["lin_l"]["kernel"]))
    pt = port_tile(tile).to("cpu")
    inter = {}
    with torch.no_grad():
        got = tm(pt, intermediates=inter)
        moved = tm(pt.replace(bd_x=pt.bd_x + 5.0))
    want_inter = _flat(state["intermediates"])
    assert "conv_0/bt/attention" in inter
    for key in want_inter:
        np.testing.assert_allclose(inter[key].numpy(), want_inter[key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("tx", "bd"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5)
    assert not np.allclose(got["tx"].numpy(), moved["tx"].numpy(),
                           atol=1e-3)
