"""The port's tile data parallelism (``SeggerTrainer(mesh=)`` for ``fit``,
``predict`` and ``predict_streaming``, ``segment --devices N``) against
the JAX package's sharded train step and against the port's own
one-device trainer at the same ``tiles_per_step``.

The JAX step runs on 4 of the 8 CPU devices of ``tests/conftest.py``,
its edge stage in interpret-mode Pallas so that its hashed dropout is
the port's; the port's 4 shards all lie on the CPU, each with its own
replica and inputs, where the kernel wrappers take their plain versions.
Sizes are ``tests/test_train_extras.py``'s ``small_pipeline`` (100
cells, hidden 8, 1 head, no middle layer).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from segger_tpu.data import partition as jpart
from segger_tpu.data.synthetic import make_synthetic
from segger_tpu.models import losses as JL
from segger_tpu.ops.pallas import postgather as jpg
from segger_tpu.parallel.mesh import make_mesh as jmake_mesh
from segger_tpu.pipeline import ISTPipeline, PipelineConfig
from segger_tpu.train.trainer import SeggerTrainer as JTrainer
from segger_tpu.train.trainer import TrainConfig as JConfig

import segger_tpu_torch.cli.segment as t_segment
from segger_tpu_torch.cli.main import main
from segger_tpu_torch.data import partition as tpart
from segger_tpu_torch.data.synthetic import write_synthetic_dataset
from segger_tpu_torch.models.convert import _flax_array, params_to_flax
from segger_tpu_torch.ops.postgather import seed_int32
from segger_tpu_torch.parallel.mesh import (
    Mesh, initialize_multihost, make_mesh, shard_tile_batch,
)
from segger_tpu_torch.train.graphs import tile_arrays
from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

from tests.test_torch_port_ops import port_host_graph, port_tile
from tests.test_torch_port_train import _jax_split, _jax_uniforms, _t

# test_train_extras.py's small model, in float32, four tiles a step
SMALL = dict(hidden_channels=8, out_channels=8, n_mid_layers=0, n_heads=1,
             seed=0, compute_dtype="float32", tiles_per_step=4)
MARGIN = 8.0
CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def small_pipeline():
    s = make_synthetic(n_cells=100, n_genes=24, mean_tx_per_cell=15, seed=5)
    cfg = PipelineConfig(
        cells_embedding_size=8, genes_min_counts=8, cells_min_counts=4,
        tiling_nodes_per_tile=1500, tiling_margin_training=MARGIN,
        prediction_graph_mode="uniform",
    )
    p = ISTPipeline(s.transcripts, s.boundaries, s.polygons, cfg).load()
    return p.graph, port_host_graph(p.graph)


@pytest.fixture(scope="module")
def tiles(small_pipeline):
    """Fit tiles of 300 nodes (twelve to train: steps of four real tiles) and
    predict tiles, JAX's and the port's."""
    jg, tg = small_pipeline
    jtree = jpart.build_tiling(jg, nodes_per_tile=300)
    ttree = tpart.build_tiling(tg, nodes_per_tile=300)
    return {"jfit": jpart.make_fit_tiles(jg, jtree, margin=MARGIN),
            "fit": tpart.make_fit_tiles(tg, ttree, margin=MARGIN),
            "predict": tpart.make_predict_tiles(tg, ttree, margin=MARGIN)}


def _fit(tg, specs, mesh=None, epochs=2, **cfg):
    tr = SeggerTrainer(tg, TrainConfig(**dict(SMALL, **cfg)), device="cpu",
                       mesh=mesh)
    tr.fit(specs, max_epochs=epochs)
    return tr


@pytest.fixture(scope="module")
def fits(small_pipeline, tiles):
    """Two epochs at four tiles a step: on one device, on 4 shards."""
    tg = small_pipeline[1]
    return (_fit(tg, tiles["fit"]),
            _fit(tg, tiles["fit"], make_mesh(devices=CPU4)))


# ---------------------------------------------------------------------
# one train step against JAX's sharded step
# ---------------------------------------------------------------------
def _jax_tile_seeds(jtr, params, tile, k_drop, monkeypatch):
    """The seed words of every edge-stage launch of one tile's forward
    with dropout key ``k_drop``, as flax's ``make_rng`` derives them
    (from the key and the module path only: the kernel is skipped)."""
    seeds = []

    def recording(xl, xr, att, keep, csr, csr_t, config):
        seeds.append(tuple(int(v) for v in np.asarray(keep).view(np.uint32)))
        return jnp.zeros((xr.shape[0], xl.shape[1]), xl.dtype)

    with monkeypatch.context() as m:
        m.setattr(jpg, "gatv2_edge_stage_pallas", recording)
        jtr.model.apply(params, jax.tree.map(jnp.asarray, tile),
                        deterministic=False, rngs={"dropout": k_drop})
    return seeds


def test_tile_dp_train_step_matches_jax(small_pipeline, tiles, monkeypatch):
    """One f32 step over a 4-tile batch on 4 shards against JAX's
    ``SeggerTrainer(mesh=make_mesh(4))`` step, JAX's seed words and
    sampler draws replayed (each tile's keys split as JAX's ``loss_fn``
    splits them): the loss within 1e-5 relative, the gradients within
    1e-4 of scale, the parameters after Adam within 1e-6."""
    monkeypatch.setenv("SEGGER_EDGE_STAGE", "pallas")
    jg, tg = small_pipeline
    jtr = JTrainer(jg, JConfig(**SMALL), mesh=jmake_mesh(4))
    plan = next(p for p in jtr._batch_plans(
        _jax_split(tiles["jfit"], jtr.cfg), shuffle=True,
        rng=np.random.default_rng([0, 0])) if len(p[0]) == 4)
    jbatch = jtr._build_batch(plan, cache=False)
    params = jtr.init(jax.tree.map(lambda a: jnp.asarray(a[0]), jbatch))
    weights = np.array([0.4, 0.4, 0.2], np.float32)
    key = jax.random.PRNGKey(7)
    keys = [jax.random.split(k, 4)
            for k in jax.random.split(key, 4)]
    seeds = [_jax_tile_seeds(jtr, params,
                             jax.tree.map(lambda a: a[b], jbatch),
                             keys[b][0], monkeypatch) for b in range(4)]
    train_step, _ = jtr._build_train_step()
    new_j, opt_j, loss_j, aux_j = train_step(
        params, jtr.opt_state, jtr._device_put(jbatch), key,
        jnp.asarray(weights))
    grads_j = _flat(jax.tree.map(lambda m: m / 0.1, opt_j[0].mu))

    tr = SeggerTrainer(tg, TrainConfig(**SMALL), device="cpu",
                       mesh=make_mesh(4, CPU4))
    tr.load_params(params)
    tr._tile_dp_setup()
    batch = port_tile(jbatch)

    def stage(steps, batch, gen, w):
        """Each shard's tile: the batch, JAX's seed words, its sampler
        uniforms and its link-loss shifts (as uniforms the port maps
        back to them)."""
        for d, step in enumerate(steps):
            inp = step.staging()
            for dst, src in zip(tile_arrays(inp.batch), tile_arrays(batch)):
                dst.copy_(torch.from_numpy(np.asarray(src[d:d + 1])))
            tile = jax.tree.map(lambda a: np.asarray(a[d]), jbatch)
            inp.seeds.copy_(torch.tensor([seed_int32(s) for s in seeds[d]],
                                         dtype=torch.int32))
            _, k_tx, k_bd, k_sg = keys[d]
            inp.tx_u[0].copy_(torch.stack(
                [_t(a) for a in _jax_uniforms(k_tx, tile.tx_valid.size)]))
            inp.bd_u[0].copy_(torch.stack(
                [_t(a) for a in _jax_uniforms(k_bd, tile.bd_valid.size)]))
            nb = max(int(tile.bd_valid.sum()), 2)
            shift = np.asarray(jax.random.randint(
                k_sg, (tile.sg_src.size,), 1, nb))
            inp.sg_u[0].copy_(_t((shift - 0.5) / (nb - 1)))
            inp.weights.copy_(torch.from_numpy(w))
            step.upload()

    tr._stage = stage
    row = tr._tile_dp_row("train", batch, None, weights)
    np.testing.assert_allclose(row[0].item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(row[1:].numpy(), np.asarray(aux_j),
                               rtol=1e-5)
    got = dict(_flax_array(n, p.grad) for n, p in
               tr.model.named_parameters())
    assert got.keys() == grads_j.keys()
    for path, a in grads_j.items():
        scale = float(np.abs(a).max()) + 1e-12
        np.testing.assert_allclose(got[path] / scale, a / scale, atol=1e-4,
                                   err_msg="/".join(path))
    new_t = _flat(params_to_flax(tr.model))
    n_big = 0
    for path, a in _flat(new_j).items():
        # Adam's first step is lr * g / (|g| + eps): only gradients well
        # above eps fix it
        big = np.abs(grads_j[path]) > 1e-6
        n_big += int(big.sum())
        np.testing.assert_allclose(new_t[path][big], a[big], atol=1e-6,
                                   err_msg="/".join(path))
    assert n_big > 500
    # the replicas hold the updated parameters
    for rep in tr._replicas.modules:
        for p, q in zip(rep.parameters(), tr.model.parameters()):
            assert torch.equal(p, q)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------
# against the port's one-device trainer
# ---------------------------------------------------------------------
def test_tile_dp_fit_matches_one_device(fits):
    """Two epochs on 4 shards against two epochs on one device at the
    same ``tiles_per_step``: the same batches and draws, so the history
    within 1e-6 relative.  The shards' gradients are summed in another
    order than autograd sums the tiles' on one device, which moves their
    last bits; where a gradient is that small (a parameter the loss
    barely reaches), Adam's ``g / (|g| + eps)`` turns the difference into
    a step of up to a tenth of the learning rate.  So the parameters are
    held within 1e-6 where the root mean square of the gradient
    (``sqrt(exp_avg_sq)``) exceeds 1e-4, about half of them, and
    within the learning rate everywhere."""
    one, mesh = fits
    assert mesh.cfg.tiles_per_step == one.cfg.tiles_per_step == 4
    assert len(mesh.step_log) == len(one.step_log) > 1
    assert [h.keys() for h in mesh.history] == [h.keys()
                                                 for h in one.history]
    for a, b in zip(one.history, mesh.history):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)
    n_held = n_all = 0
    for (name, p), q in zip(one.model.named_parameters(),
                            mesh.model.parameters()):
        n_all += p.numel()
        torch.testing.assert_close(q, p, rtol=0,
                                   atol=one.cfg.learning_rate, msg=name)
        held = one.optimizer.state[p]["exp_avg_sq"].sqrt() > 1e-4
        n_held += int(held.sum())
        torch.testing.assert_close(q[held], p[held], rtol=0, atol=1e-6,
                                   msg=name)
    assert n_held > 0.45 * n_all, (n_held, n_all)


def test_tile_dp_predict_equals_one_device(fits, tiles):
    """With the same parameters the 4-shard predict returns the
    one-device arrays in the same order, and ``predict_streaming`` the
    same dense arrays."""
    one, mesh = fits
    mesh.model.load_state_dict(one.model.state_dict())
    want, got = one.predict(tiles["predict"]), mesh.predict(tiles["predict"])
    assert want.keys() == got.keys() and want["row_index"].size > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(one.predict_streaming(tiles["predict"]),
                    mesh.predict_streaming(tiles["predict"])):
        np.testing.assert_array_equal(b, a)


def test_repeated_device_shards_keep_their_own_state(small_pipeline, tiles,
                                                     fits):
    """Four shards on one device: each has its own replica, inputs, seed
    words and memory; and 2 shards of two tiles each fit and predict as 4
    shards of one tile do (history within 1e-6 relative, predictions
    equal)."""
    _, mesh = fits
    reps = mesh._replicas
    assert len({id(m) for m in reps.modules}) == 4
    ptrs = [b.data_ptr() for b in reps.flats]
    assert len(set(ptrs)) == 4
    steps = [s for k, s in mesh._steps.items() if k[0] == "train"]
    assert sorted(k[2] for k in mesh._steps if k[0] == "train") == [0, 1, 2,
                                                                     3]
    for i, a in enumerate(steps):
        for b in steps[i + 1:]:
            assert a.inputs.flat.data_ptr() != b.inputs.flat.data_ptr()
            assert a.inputs.seeds.data_ptr() != b.inputs.seeds.data_ptr()
    two = _fit(small_pipeline[1], tiles["fit"], make_mesh(2, ["cpu"] * 2))
    assert two.cfg.tiles_per_step == 4
    for a, b in zip(mesh.history, two.history):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)
    two.model.load_state_dict(mesh.model.state_dict())
    got, want = two.predict(tiles["predict"]), mesh.predict(tiles["predict"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_shard_tile_batch_splits_the_tile_axis(small_pipeline, tiles):
    tg = small_pipeline[1]
    tr = SeggerTrainer(tg, TrainConfig(**SMALL), device="cpu")
    batch = tr.make_batches(tiles["fit"][:4], shuffle=False)[0]
    mesh = make_mesh(4, CPU4)
    groups = shard_tile_batch(batch, mesh)
    assert len(groups) == 4
    for d, g in enumerate(groups):
        for a, b in zip(tile_arrays(g), tile_arrays(batch)):
            assert isinstance(a, torch.Tensor) and a.shape[0] == 1
            np.testing.assert_array_equal(a.numpy(), b[d:d + 1])
    with pytest.raises(ValueError, match="equal groups"):
        shard_tile_batch(batch, make_mesh(3, ["cpu"] * 3))


def test_initialize_multihost_still_raises(small_pipeline, monkeypatch):
    """Tile data parallelism stays in one process: without a rendezvous
    (no arguments, no torchrun variables) ``initialize_multihost`` raises
    before contacting anything, naming what is missing, and a tile-data-
    parallel fit over a mesh that spans ranks raises."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR, MASTER_PORT, "
                       "WORLD_SIZE, RANK unset"):
        initialize_multihost()
    spans = Mesh(tuple(torch.device("cpu") for _ in range(4)), ("data",),
                 (4,), owners=(0, 0, 1, 1), rank=0)
    assert spans.local == (0, 1) and spans.spans_ranks
    tr = SeggerTrainer(small_pipeline[1], TrainConfig(**SMALL), device="cpu",
                       mesh=spans)
    tr.init()
    with pytest.raises(ValueError, match="tile data parallelism runs in "
                       "one process"):
        tr.predict([])


def test_segment_devices_4_on_the_cpu(tmp_path):
    """``segment --device cpu --devices 4`` trains and predicts tile data
    parallel over 4 CPU shards: a mesh of 4, four tiles a step, and a
    table more accurate than 0.6 against the true cells."""
    data = tmp_path / "data"
    synth = write_synthetic_dataset(data, seed=0, n_cells=120, n_genes=30,
                                    mean_tx_per_cell=20)
    out = tmp_path / "out"
    assert main(["segment", "-i", str(data), "-o", str(out), "--device",
                 "cpu", "--devices", "4", "--no-anndata",
                 "--cells-embedding-size", "16", "--cells-min-counts", "5",
                 "--genes-min-counts", "10", "--tiling-nodes-per-tile",
                 "2000", "--hidden-channels", "16", "--out-channels", "16",
                 "--n-mid-layers", "0", "--max-epochs", "2"]) == 0
    last = t_segment.run_segment.last_run
    tr, g = last["trainer"], last["graph"]
    assert tr.mesh.size == 4 and tr.tile_dp and tr.cfg.tiles_per_step == 4
    assert len(tr.history) == 2
    seg = pd.read_parquet(out / "segger_segmentation.parquet")
    assert seg["row_index"].is_unique and len(seg) == g.n_tx
    truth = np.asarray(synth.truth_cell)[seg["row_index"].to_numpy()]
    ids = seg["segger_cell_id"].to_numpy(object)
    of_a_cell = truth != ""
    acc = float((ids[of_a_cell] == truth[of_a_cell]).mean())
    assert acc > 0.6, acc


def test_chip_smoke_tile_dp_drive_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phase 11 on a small slide of its phase 7 on the
    CPU: one device against 4 CPU shards at four tiles a step, fit and
    predict."""
    import chip_smoke
    from segger_tpu_torch.pipeline import ISTPipeline as TPipeline
    from segger_tpu_torch.pipeline import PipelineConfig as TPipelineConfig

    pkw = dict(cells_embedding_size=8, genes_min_counts=5,
               cells_min_counts=3, tiling_nodes_per_tile=600,
               prediction_graph_buffer_ratio=0.2)
    s = chip_smoke.pipeline_slide(60, 20)
    p = TPipeline(s.transcripts, s.boundaries, s.polygons,
                  TPipelineConfig(seed=chip_smoke.SEED, **pkw)).load()
    t = chip_smoke.drive_tile_dp(
        tmp_path, p.graph, p.tree, np.asarray(s.truth_cell), device="cpu",
        n_cells=60, n_genes=20, epochs=1, pipeline_kw=pkw,
        train_kw=dict(hidden_channels=16, out_channels=16, n_mid_layers=0))
    assert t["steps"] >= 1 and t["n_tiles"][1] > 1
    assert t["loss_rel"] <= chip_smoke.GRAPH_STEP_RTOL
    assert t["agreement"] == 1.0 and t["bit_equal"]
    assert t["accuracy"] > 0.6
