"""Port encoder against the JAX ISTEncoder: weight conversion, forward
parity on a degree-bucketed tile (xlo + lo + hi segments), and JAX
checkpoints read by the port."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from segger_tpu.models import ISTEncoder as JEncoder
from segger_tpu.train.checkpoint import save_checkpoint

from segger_tpu_torch.models import ISTEncoder
from segger_tpu_torch.models.convert import params_from_flax
from segger_tpu_torch.train.checkpoint import load_checkpoint

from tests.test_degree_bucketing import _bench_like_tile
from tests.test_torch_port_ops import port_tile

HEADS, HIDDEN, OUT, N_MID, IN_CH, N_GENES = 2, 16, 16, 1, 8, 40


@pytest.fixture(scope="module")
def bucketed_tile():
    """A kNN tile bucketed into xlo, lo and hi segments, with the
    per-segment transpose tables that select the split."""
    from segger_tpu.data.partition import apply_degree_bucketing

    tile = _bench_like_tile(np.random.default_rng(4), n_tx=800, n_bd=60)
    deg = tile.tt.mask.sum(1)
    n_lo = int((deg <= 8).sum()) // 8 * 8
    n_xlo = int((deg <= 4).sum()) // 8 * 8
    tile = apply_degree_bucketing(tile, n_lo=n_lo, n_xlo=n_xlo)
    assert tile.tt_n_xlo > 0 and tile.tt_n_lo > tile.tt_n_xlo
    assert tile.tt.idx.shape[1] > 8 and tile.tt_xlo_t is not None
    return tile


def _jax_model(dtype):
    return JEncoder(
        n_genes=N_GENES, in_channels=IN_CH, hidden_channels=HIDDEN,
        out_channels=OUT, n_mid_layers=N_MID, n_heads=HEADS,
        dtype=None if dtype == "float32" else jnp.bfloat16,
    )


@pytest.fixture(scope="module")
def params(bucketed_tile):
    """JAX parameters (the compute dtype does not change them)."""
    return jax.jit(_jax_model("float32").init)(
        jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, bucketed_tile))


def _jax_apply(dtype, params, tile):
    return jax.jit(_jax_model(dtype).apply)(
        params, jax.tree.map(jnp.asarray, tile))


def _port_model(tile, dtype):
    return ISTEncoder(
        n_genes=N_GENES, n_bd_features=tile.bd_x.shape[1],
        in_channels=IN_CH, hidden_channels=HIDDEN, out_channels=OUT,
        n_mid_layers=N_MID, n_heads=HEADS,
        dtype=None if dtype == "float32" else torch.bfloat16,
    ).eval()


def test_params_from_flax_uses_every_leaf_once(bucketed_tile, params):
    tm = _port_model(bucketed_tile, "float32")
    sd = params_from_flax(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    # strict: no missing and no unexpected key
    tm.load_state_dict(sd, strict=True)
    w = np.asarray(params["params"]["conv_0"]["tt"]["lin_l"]["kernel"])
    np.testing.assert_array_equal(
        tm.conv_0.tt.lin_l.weight.detach().numpy(), w.T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax_on_bucketed_tile(bucketed_tile, params,
                                              dtype, monkeypatch):
    tm = _port_model(bucketed_tile, dtype)
    tm.load_state_dict(params_from_flax(params), strict=True)
    if dtype == "bfloat16":
        # the TPU kernel's arithmetic (f32 softmax statistics), run in
        # interpret mode; the default CPU path softmaxes in bf16
        monkeypatch.setenv("SEGGER_EDGE_STAGE", "pallas")
    want = _jax_apply(dtype, params, bucketed_tile)
    with torch.no_grad():
        got = tm(port_tile(bucketed_tile).to("cpu"))
    atol = 1e-4 if dtype == "float32" else 3e-2
    for key in ("tx", "bd"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(want[key]), atol=atol)


def test_load_checkpoint_reads_jax_checkpoint(bucketed_tile, params,
                                             tmp_path):
    tm = _port_model(bucketed_tile, "float32")
    path = save_checkpoint(tmp_path / "ck.npz", params)
    loaded, meta = load_checkpoint(path, tm)
    assert meta["n_params"] == len(jax.tree_util.tree_leaves(params))
    tm.load_state_dict(params_from_flax(loaded), strict=True)
    tile = port_tile(bucketed_tile).to("cpu")
    with torch.no_grad():
        got = tm(tile)
        ref = _port_model(bucketed_tile, "float32")
        ref.load_state_dict(params_from_flax(params), strict=True)
        want = ref(tile)
    for key in ("tx", "bd"):
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy())
    want_j = _jax_apply("float32", params, bucketed_tile)
    np.testing.assert_allclose(got["tx"].numpy(), np.asarray(want_j["tx"]),
                               atol=1e-4)


def test_load_checkpoint_rejects_other_config(bucketed_tile, params,
                                             tmp_path):
    path = save_checkpoint(tmp_path / "ck.npz", params)
    other = ISTEncoder(n_genes=N_GENES,
                       n_bd_features=bucketed_tile.bd_x.shape[1],
                       in_channels=IN_CH, hidden_channels=HIDDEN,
                       out_channels=OUT, n_mid_layers=N_MID + 1,
                       n_heads=HEADS)
    with pytest.raises(ValueError):
        load_checkpoint(path, other)
