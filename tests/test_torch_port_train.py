"""The port's training slice against the JAX package: the losses with
JAX's own random draws, one full train step (forward with dropout, loss,
gradients, Adam) with JAX's seed words replayed, fit tiling and per-epoch
packing, and the fit loop's plumbing (history, resume, tile cache,
checkpoints that the JAX package reads).

The JAX side runs its edge stage as its own tests do off the TPU: the
Pallas kernels in interpret mode (``SEGGER_EDGE_STAGE=pallas``).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from segger_tpu.data import partition as jpart
from segger_tpu.data.synthetic import make_synthetic
from segger_tpu.models import losses as JL
from segger_tpu.ops.pallas import postgather as jpg
from segger_tpu.pipeline import ISTPipeline, PipelineConfig
from segger_tpu.train import checkpoint as jckpt
from segger_tpu.train.trainer import SeggerTrainer as JTrainer
from segger_tpu.train.trainer import TrainConfig as JConfig

from segger_tpu_torch.data import partition as tpart
from segger_tpu_torch.models import losses as TL
from segger_tpu_torch.models.convert import _flax_array, params_to_flax
from segger_tpu_torch.train.checkpoint import save_checkpoint
from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

from tests.test_torch_port_ops import port_host_graph, port_tile

MODEL = dict(hidden_channels=16, out_channels=16, n_mid_layers=0,
             n_heads=2)
MARGIN = 8.0


@pytest.fixture(scope="module")
def pipeline():
    s = make_synthetic(n_cells=100, n_genes=24, mean_tx_per_cell=15,
                       seed=5)
    cfg = PipelineConfig(
        cells_embedding_size=8, genes_min_counts=8, cells_min_counts=4,
        tiling_nodes_per_tile=1500, tiling_margin_training=MARGIN,
        prediction_graph_mode="cell", prediction_graph_buffer_ratio=0.2,
    )
    p = ISTPipeline(s.transcripts, s.boundaries, s.polygons, cfg).load()
    return p.graph, port_host_graph(p.graph)


@pytest.fixture(scope="module")
def fit_tiles(pipeline):
    jg, tg = pipeline
    jspecs = jpart.make_fit_tiles(
        jg, jpart.build_tiling(jg, nodes_per_tile=600), margin=MARGIN)
    tspecs = tpart.make_fit_tiles(
        tg, tpart.build_tiling(tg, nodes_per_tile=600), margin=MARGIN)
    return jspecs, tspecs


def _jax_split(specs, cfg):
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(specs))
    split = int(cfg.training_fraction * len(specs))
    return [specs[i] for i in perm[:split]]


def test_fit_tiles_and_epoch_bins_match_jax(pipeline, fit_tiles):
    jg, tg = pipeline
    jspecs, tspecs = fit_tiles
    assert len(tspecs) == len(jspecs) > 3
    for a, b in zip(tspecs, jspecs):
        for name in ("tx_rows", "bd_rows", "tx_interior", "bd_interior"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))
        assert a.n_edges == b.n_edges
    cfg = dict(MODEL, edges_per_batch=2000)
    jtr = JTrainer(jg, JConfig(**cfg))
    ttr = SeggerTrainer(tg, TrainConfig(**cfg), device="cpu")
    jtrain = _jax_split(jspecs, jtr.cfg)
    ttrain, _ = ttr.split_tiles(tspecs)
    assert [s.tx_rows.tolist() for s in ttrain] == [
        s.tx_rows.tolist() for s in jtrain]
    for epoch in (0, 1):
        jplans = jtr._batch_plans(jtrain, shuffle=True,
                                  rng=np.random.default_rng([0, epoch]))
        tplans = ttr._batch_plans(ttrain, shuffle=True,
                                  rng=ttr.epoch_streams(epoch)[0])
        assert len(tplans) == len(jplans) > 1
        for (ts, tb), (js, jb) in zip(tplans, jplans):
            assert tb == tpart.BucketShape(**dataclasses.asdict(jb))
            assert [s.tx_rows.tolist() for s in ts] == [
                s.tx_rows.tolist() for s in js]


# ---------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------
def _jax_uniforms(key, n):
    """The four uniforms ``sample_triplets`` draws from ``key``."""
    k_pos, k_neg, k_mp, k_mn = jax.random.split(key, 4)
    return (jax.random.uniform(k_pos, (n, 1))[:, 0],
            jax.random.uniform(k_neg, (n, 1))[:, 0],
            jax.random.uniform(k_mp, (n,)),
            jax.random.uniform(k_mn, (n,)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("sorted_host", [False, True])
def test_sampler_and_losses_match_jax(sorted_host):
    rng = np.random.default_rng(3)
    n, c, f = 300, 7, 16
    labels = rng.integers(-1, c, n).astype(np.int32)
    valid = (rng.uniform(size=n) < 0.8) & (labels >= 0)
    sim = rng.uniform(-0.5, 1, (c, c)).astype(np.float32)
    emb = rng.normal(size=(n, f)).astype(np.float32)
    sort = None
    if sorted_host:
        lab = np.where(valid, np.clip(labels, 0, None), c)
        sort = (np.argsort(lab, kind="stable").astype(np.int32),
                np.bincount(lab[valid], minlength=c)[:c].astype(np.int32))
    key = jax.random.PRNGKey(9)
    js = JL.sample_triplets(key, jnp.asarray(labels), jnp.asarray(valid),
                            jnp.asarray(sim),
                            None if sort is None else tuple(
                                jnp.asarray(a) for a in sort))
    u = tuple(_t(a) for a in _jax_uniforms(key, n))
    tsort = None if sort is None else tuple(_t(a) for a in sort)
    ts = TL.sample_triplets(*u, _t(labels), _t(valid), _t(sim), tsort)
    for name in js._fields:
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            err_msg=name)
    args_j = (jnp.asarray(emb), jnp.asarray(labels), jnp.asarray(valid),
              jnp.asarray(sim))
    args_t = (_t(emb), _t(labels), _t(valid), _t(sim))
    jsort = None if sort is None else tuple(jnp.asarray(a) for a in sort)
    for jf, tf, kw in ((JL.triplet_loss, TL.triplet_loss, {"margin": 0.3}),
                       (JL.metric_loss, TL.metric_loss, {})):
        sj, cj = jf(key, *args_j, sort_structure=jsort, **kw)
        st, ct = tf(u, *args_t, sort_structure=tsort, **kw)
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
        assert int(ct) == int(cj) > 0


@pytest.mark.parametrize("loss_type", ["triplet", "bce"])
def test_segmentation_loss_matches_jax(loss_type):
    rng = np.random.default_rng(4)
    n_tx, n_bd, e = 200, 30, 120
    emb_tx = rng.normal(size=(n_tx, 8)).astype(np.float32)
    emb_bd = rng.normal(size=(n_bd, 8)).astype(np.float32)
    src = rng.integers(0, n_tx, e).astype(np.int32)
    dst = rng.integers(0, 25, e).astype(np.int32)
    mask = rng.uniform(size=e) < 0.9
    key = jax.random.PRNGKey(2)
    sj, cj = JL.segmentation_loss(
        key, *(jnp.asarray(a) for a in (emb_tx, emb_bd, src, dst, mask)),
        jnp.asarray(25), loss_type=loss_type, margin=0.4)
    shift = jax.random.randint(key, (e,), 1, 25)
    st, ct = TL.segmentation_loss(
        _t(np.asarray(shift)).long(),
        *(_t(a) for a in (emb_tx, emb_bd, src, dst, mask)),
        torch.tensor(25), loss_type=loss_type, margin=0.4)
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
    assert int(ct) == int(cj)


def test_cosine_weight_schedule_equals_jax():
    for epoch in range(6):
        np.testing.assert_array_equal(
            TL.cosine_weight_schedule(epoch, 5, [1, 1, 0], [1, 1, 0.5]),
            JL.cosine_weight_schedule(epoch, 5, [1, 1, 0], [1, 1, 0.5]))


# ---------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------
def _flat_grads_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(k.key for k in path)] = np.asarray(leaf, np.float32)
    return out


def _step_setup(pipeline, fit_tiles, dtype):
    jg, tg = pipeline
    jspecs, tspecs = fit_tiles
    cfg = dict(MODEL, compute_dtype=dtype)
    jtr = JTrainer(jg, JConfig(**cfg))
    ttr = SeggerTrainer(tg, TrainConfig(**cfg), device="cpu")
    plan = jtr._batch_plans(_jax_split(jspecs, jtr.cfg), shuffle=True,
                            rng=np.random.default_rng([0, 0]))[0]
    jtile = jax.tree.map(lambda x: np.asarray(x)[0],
                         jtr._build_batch(plan, cache=False))
    assert jtile.tt_n_lo > 0 and jtile.tt_lo_t is not None
    params = jtr.init(jax.tree.map(jnp.asarray, jtile))
    ttr.load_params(params)
    w = jtr.cfg
    weights = JL.cosine_weight_schedule(
        1, 3, [w.tx_weight_start, w.bd_weight_start, w.sg_weight_start],
        [w.tx_weight_end, w.bd_weight_end, w.sg_weight_end])
    assert (weights > 0).all()
    return jtr, ttr, jtile, params, weights


def _jax_step(jtr, jtile, params, weights, monkeypatch):
    """JAX's loss, gradients and Adam update for one tile with dropout,
    eager, with the seed words of every edge-stage launch recorded and
    the loss draws returned."""
    monkeypatch.setenv("SEGGER_EDGE_STAGE", "pallas")
    seeds = []
    orig = jpg.gatv2_edge_stage_pallas

    def recording(xl, xr, att, keep, csr, csr_t, config):
        if keep.ndim == 1:
            seeds.append(tuple(int(v) for v in
                               np.asarray(keep).view(np.uint32)))
        return orig(xl, xr, att, keep, csr, csr_t, config)

    monkeypatch.setattr(jpg, "gatv2_edge_stage_pallas", recording)
    tile = jax.tree.map(jnp.asarray, jtile)
    k_drop, k_tx, k_bd, k_sg = jax.random.split(jax.random.PRNGKey(7), 4)
    cfg = jtr.cfg
    w = jnp.asarray(weights)

    def loss_fn(p):
        emb = jtr.model.apply(p, tile, deterministic=False,
                              rngs={"dropout": k_drop})
        st = JL.loss_stats(
            k_tx, k_bd, k_sg, emb, tile, jtr.tx_similarity,
            jtr.bd_similarity, tx_margin=cfg.tx_margin,
            sg_margin=cfg.sg_margin, sg_loss_type=cfg.sg_loss_type,
            use_interior=True)
        parts = st[0::2] / jnp.maximum(st[1::2], 1.0)
        return w[0] * parts[0] + w[1] * parts[1] + w[2] * parts[2]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = jtr.tx.update(grads, jtr.opt_state, params)
    new = optax.apply_updates(params, updates)
    nb = max(int(jtile.bd_valid.sum()), 2)
    draws = TL.LossRandoms(
        tuple(_t(a) for a in _jax_uniforms(k_tx, jtile.tx_valid.size)),
        tuple(_t(a) for a in _jax_uniforms(k_bd, jtile.bd_valid.size)),
        _t(jax.random.randint(k_sg, (jtile.sg_src.size,), 1, nb)).long(),
    )
    return float(loss), grads, new, seeds, draws


def _port_loss(ttr, jtile, weights, seeds, draws):
    tile = port_tile(jtile).to("cpu")
    it = iter(seeds)
    emb = ttr.model(tile, deterministic=False, seeds=lambda: next(it))
    assert next(it, None) is None, "a recorded seed was not consumed"
    cfg = ttr.cfg
    st = TL.loss_stats(draws, emb, tile, ttr.tx_similarity,
                       ttr.bd_similarity, tx_margin=cfg.tx_margin,
                       sg_margin=cfg.sg_margin,
                       sg_loss_type=cfg.sg_loss_type)
    parts = st[0::2] / st[1::2].clamp(min=1.0)
    w = torch.from_numpy(weights)
    return w[0] * parts[0] + w[1] * parts[1] + w[2] * parts[2]


def test_train_step_matches_jax_float32(pipeline, fit_tiles, monkeypatch):
    jtr, ttr, jtile, params, weights = _step_setup(pipeline, fit_tiles,
                                                   "float32")
    loss_j, grads_j, new_j, seeds, draws = _jax_step(
        jtr, jtile, params, weights, monkeypatch)
    # one launch per tt segment (lo, hi) and one tb, per layer
    assert len(seeds) == 2 * 3 and len(set(seeds)) == len(seeds)
    loss_t = _port_loss(ttr, jtile, weights, seeds, draws)
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=1e-5)
    ttr.optimizer.zero_grad()
    loss_t.backward()
    gj = _flat_grads_jax(grads_j)
    got = dict(_flax_array(n, p.grad) for n, p in
               ttr.model.named_parameters())
    assert got.keys() == gj.keys()
    for path, a in gj.items():
        scale = float(np.abs(a).max()) + 1e-12
        np.testing.assert_allclose(got[path] / scale, a / scale, atol=1e-4,
                                   err_msg="/".join(path))
    ttr.optimizer.step()
    new_t = _flat_grads_jax(params_to_flax(ttr.model))
    for path, a in _flat_grads_jax(new_j).items():
        big = np.abs(gj[path]) > 1e-6
        np.testing.assert_allclose(new_t[path][big], a[big], atol=1e-6,
                                   err_msg="/".join(path))


def test_train_step_loss_matches_jax_bfloat16(pipeline, fit_tiles,
                                              monkeypatch):
    jtr, ttr, jtile, params, weights = _step_setup(pipeline, fit_tiles,
                                                   "bfloat16")
    loss_j, _, _, seeds, draws = _jax_step(jtr, jtile, params, weights,
                                           monkeypatch)
    loss_t = _port_loss(ttr, jtile, weights, seeds, draws)
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=2e-2)


# ---------------------------------------------------------------------
# fit plumbing
# ---------------------------------------------------------------------
SMALL = dict(MODEL, edges_per_batch=2000, compute_dtype="float32")


def _fit(tg, specs, epochs, on_epoch_end=None, **cfg):
    tr = SeggerTrainer(tg, TrainConfig(**dict(SMALL, **cfg)), device="cpu")
    tr.fit(specs, max_epochs=epochs, on_epoch_end=on_epoch_end)
    return tr


@pytest.fixture(scope="module")
def fitted(pipeline, fit_tiles):
    """Two epochs of the port's fit."""
    return _fit(pipeline[1], fit_tiles[1], 2)


def test_fit_history_keys_match_jax(pipeline, fit_tiles, fitted):
    jg, _ = pipeline
    jtr = JTrainer(jg, JConfig(**SMALL))
    jhist = jtr.fit(fit_tiles[0], max_epochs=1)
    assert set(fitted.history[0]) == set(jhist[0])
    assert [r["epoch"] for r in fitted.history] == [0, 1]
    assert all(np.isfinite(v) for r in fitted.history for v in r.values())
    assert len(fitted.step_log) == 2 * len(
        fitted._batch_plans(fitted.split_tiles(fit_tiles[1])[0]))


def _state(tr):
    return {k: v.clone() for k, v in tr.model.state_dict().items()}


def test_resumed_fit_equals_uninterrupted(pipeline, fit_tiles, tmp_path):
    tg, specs = pipeline[1], fit_tiles[1]
    whole = _fit(tg, specs, 2)

    def stop(epoch, _):
        if epoch == 1:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _fit(tg, specs, 2, stop, checkpoint_every=1,
             checkpoint_dir=str(tmp_path))
    resumed = _fit(tg, specs, 2, checkpoint_every=1,
                   checkpoint_dir=str(tmp_path))
    assert [r["epoch"] for r in resumed.history] == [1]
    assert resumed.history[0] == whole.history[1]
    for k, v in _state(whole).items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v,
                                   atol=0, rtol=0)


def test_tile_cache_does_not_change_results(pipeline, fit_tiles):
    tg, specs = pipeline[1], fit_tiles[1]
    cached = _fit(tg, specs, 2)
    assert cached._tile_cache, "epoch 0 filled no cache"
    plain = _fit(tg, specs, 2, tile_cache_gb=0.0)
    assert not plain._tile_cache
    assert cached.history == plain.history
    for k, v in _state(plain).items():
        torch.testing.assert_close(cached.model.state_dict()[k], v,
                                   atol=0, rtol=0)
    cached.release_tile_cache()
    assert not cached._tile_cache and cached._tile_cache_bytes == 0


def test_port_checkpoint_loads_in_jax(pipeline, fit_tiles, fitted,
                                      tmp_path):
    jg, _ = pipeline
    path = save_checkpoint(tmp_path / "ck.npz", fitted.model,
                           fitted.optimizer, config=fitted.cfg,
                           extra={"epoch": 1})
    jtr = JTrainer(jg, JConfig(**SMALL))
    plan = jtr._batch_plans(fit_tiles[0], shuffle=False)[0]
    jtile = jax.tree.map(lambda x: np.asarray(x)[0],
                         jtr._build_batch(plan, cache=False))
    tmpl = jtr.init(jax.tree.map(jnp.asarray, jtile))
    params, opt_state, meta = jckpt.load_checkpoint(path, tmpl,
                                                    jtr.opt_state)
    assert meta["extra"]["epoch"] == 1
    adam = opt_state[0]
    assert int(adam.count) == len(fitted.step_log)
    mu_t = fitted.optimizer.state[fitted.model.conv_0.tt.att]["exp_avg"]
    np.testing.assert_array_equal(
        np.asarray(adam.mu["params"]["conv_0"]["tt"]["att"]), mu_t.numpy())
    want = jtr.model.apply(params, jax.tree.map(jnp.asarray, jtile))
    with torch.no_grad():
        got = fitted.model(port_tile(jtile).to("cpu"))
    for key in ("tx", "bd"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)


def test_frozen_gene_embedding_checkpoint_matches_masked_optax(
        pipeline, fit_tiles, tmp_path):
    """``update_gene_embedding=False`` leaves the embedding as installed,
    and the checkpoint's Adam leaves follow ``optax.masked``'s layout."""
    jg, tg = pipeline
    tr = _fit(tg, fit_tiles[1], 1, update_gene_embedding=False)
    np.testing.assert_array_equal(
        tr.model.gene_embedding.embedding.detach().numpy(),
        np.asarray(tg.gene_embedding, np.float32))
    path = save_checkpoint(tmp_path / "ck.npz", tr.model, tr.optimizer)
    jtr = JTrainer(jg, JConfig(**dict(SMALL, update_gene_embedding=False)))
    plan = jtr._batch_plans(fit_tiles[0], shuffle=False)[0]
    jtile = jax.tree.map(lambda x: np.asarray(x)[0],
                         jtr._build_batch(plan, cache=False))
    tmpl = jtr.init(jax.tree.map(jnp.asarray, jtile))
    _, opt_state, meta = jckpt.load_checkpoint(path, tmpl, jtr.opt_state)
    assert meta["n_opt"] == len(jax.tree_util.tree_leaves(jtr.opt_state))
    assert int(jax.tree_util.tree_leaves(opt_state)[0]) == len(tr.step_log)


def test_fit_without_device_raises_without_cuda(pipeline, fit_tiles):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SeggerTrainer(pipeline[1], TrainConfig(**SMALL)).fit(fit_tiles[1])


# ---------------------------------------------------------------------
# the rest of the trainer's API: tests/test_train_extras.py's cases, the
# batch iterators, the GATv2 conv with shared weights
# ---------------------------------------------------------------------
def test_mesh_sharded_fit(pipeline, fit_tiles):
    """``tests/test_train_extras.py:31``: training with the stacked-tile
    batch sharded over 4 devices (CPU shards) gives a finite loss."""
    from segger_tpu_torch.parallel.mesh import make_mesh

    tr = SeggerTrainer(pipeline[1], TrainConfig(**dict(SMALL, max_epochs=1,
                                                       tiles_per_step=4)),
                       device="cpu", mesh=make_mesh(4, ["cpu"] * 4))
    hist = tr.fit(fit_tiles[1], max_epochs=1)
    assert np.isfinite(hist[0]["train:loss"])
    assert tr.tile_dp and len(tr._replicas.modules) == 4


def test_predict_path_releases_tile_cache(pipeline, fit_tiles, fitted):
    """``tests/test_train_extras.py:145``: predict drops the fit's tile
    cache up front and does not fill it again."""
    assert fitted._tile_cache_bytes > 0
    tg = pipeline[1]
    specs = tpart.make_predict_tiles(
        tg, tpart.build_tiling(tg, nodes_per_tile=600), margin=MARGIN)
    out = fitted.predict(specs)
    assert out["row_index"].size > 0
    assert fitted._tile_cache_bytes == 0 and len(fitted._tile_cache) == 0


def test_trainer_does_not_mutate_caller_config(pipeline):
    """``tests/test_train_extras.py:205``: a mesh rounds
    ``tiles_per_step`` on the trainer's copy of the config, never on the
    caller's."""
    from segger_tpu_torch.parallel.mesh import make_mesh

    cfg = TrainConfig(**dict(SMALL, tiles_per_step=1))
    tr = SeggerTrainer(pipeline[1], cfg, device="cpu",
                       mesh=make_mesh(4, ["cpu"] * 4))
    assert cfg.tiles_per_step == 1
    assert tr.cfg.tiles_per_step == 4
    tr2 = SeggerTrainer(pipeline[1], device="cpu")
    assert tr2.cfg.tiles_per_step == TrainConfig().tiles_per_step


def test_fit_zero_epochs_runs_nothing(pipeline, fit_tiles):
    """``tests/test_train_extras.py:219``."""
    tr = SeggerTrainer(pipeline[1], TrainConfig(**SMALL), device="cpu")
    assert tr.fit(fit_tiles[1], max_epochs=0) == []
    assert tr.step_log == [] and tr.captures["train"] == 0


def test_fit_on_epoch_end_callback(pipeline, fit_tiles):
    """``tests/test_train_extras.py:230``: the callback fires once per
    epoch with the live trainer."""
    tr = SeggerTrainer(pipeline[1], TrainConfig(**dict(SMALL, max_epochs=3,
                                                       scan_steps=1)),
                       device="cpu")
    seen = []

    def cb(epoch, trainer):
        assert trainer is tr and trainer.initialized
        assert len(trainer.history) == epoch + 1
        seen.append(epoch)

    tr.fit(fit_tiles[1], on_epoch_end=cb)
    assert seen == [0, 1, 2]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for t, j in zip(got, want):
        j = port_tile(j)
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if isinstance(a, tpart.PaddedCSR):
                np.testing.assert_array_equal(a.idx, b.idx, err_msg=f.name)
                np.testing.assert_array_equal(a.mask, b.mask, err_msg=f.name)
            elif isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name


@pytest.mark.parametrize("shuffle", [False, True])
def test_iter_and_make_batches_match_jax(pipeline, fit_tiles, shuffle):
    """``iter_batches`` and ``make_batches`` build the JAX package's
    batches from the same specs and packing rng; ``make_batches`` fills
    no tile cache, ``iter_batches(cache=True)`` does."""
    jg, tg = pipeline
    jspecs, tspecs = fit_tiles
    cfg = dict(MODEL, edges_per_batch=2000, tiles_per_step=2)
    jtr = JTrainer(jg, JConfig(**cfg))
    ttr = SeggerTrainer(tg, TrainConfig(**cfg), device="cpu")

    def rng():
        return np.random.default_rng([0, 1]) if shuffle else None

    want = jtr.make_batches(jspecs, shuffle=shuffle, rng=rng())
    _assert_batches_equal(ttr.make_batches(tspecs, shuffle=shuffle,
                                           rng=rng()), want)
    assert not ttr._tile_cache
    with ttr.iter_batches(tspecs, shuffle=shuffle, rng=rng(),
                          prefetch=1) as it:
        got = list(it)
    _assert_batches_equal(got, want)
    assert ttr._tile_cache_bytes > 0
    want = list(jtr.iter_batches(jspecs, shuffle=shuffle, rng=rng(),
                                 use_xlo=True, cache=False))
    with ttr.iter_batches(tspecs, shuffle=shuffle, rng=rng(),
                          use_xlo=True, cache=False) as it:
        _assert_batches_equal(list(it), want)


def test_gatv2_shared_weights_match_jax():
    """``GATv2Conv(share_weights=True)``: one projection serves both
    sides, as JAX's ``lin_r = lin_l``; the flax tree (no ``lin_r``) loads
    strictly, and the unfused and fused forwards equal JAX's at 1e-5 in
    float32."""
    from segger_tpu.models.gatv2 import GATv2Conv as JConv
    from segger_tpu.ops import coo_to_padded_csr
    from segger_tpu_torch.models.convert import params_from_flax
    from segger_tpu_torch.models.gatv2 import GATv2Conv

    rng = np.random.default_rng(8)
    n_src, n_dst, f, heads, ch = 70, 40, 12, 2, 8
    dst = rng.integers(1, n_dst, 200)            # row 0: no in-edge
    csr = coo_to_padded_csr(dst, rng.integers(0, n_src, 200), n_dst=n_dst)
    x_src = rng.normal(size=(n_src, f)).astype(np.float32)
    x_dst = rng.normal(size=(n_dst, f)).astype(np.float32)
    jconv = JConv(ch, heads, share_weights=True)
    jcsr = jax.tree.map(jnp.asarray, csr)
    params = jconv.init(jax.random.PRNGKey(1), x_src, x_dst, jcsr)
    assert "lin_r" not in params["params"]
    want = np.asarray(jconv.apply(params, x_src, x_dst, jcsr))
    conv = GATv2Conv(f, ch, heads, share_weights=True)
    assert not hasattr(conv, "lin_r") and conv.lin_dst is conv.lin_l
    conv.load_state_dict(params_from_flax(params), strict=True)
    idx, mask = _t(csr.idx), _t(csr.mask)
    table = tpart.PaddedCSR(idx, mask)
    with torch.no_grad():
        unfused = conv(_t(x_src), _t(x_dst), table)
        fused = conv(_t(x_src), _t(x_dst), table,
                     segments=[(0, n_dst, idx, mask, None)])
    for got in (unfused, fused):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the destination side reads lin_l: changing it moves the output
    with torch.no_grad():
        conv.lin_l.bias.add_(1.0)
        moved = conv(_t(x_src), _t(x_dst), table)
    assert not torch.allclose(moved, unfused)
    assert sum(p.numel() for p in conv.parameters()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(params))
