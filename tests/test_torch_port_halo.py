"""The port's whole-slide halo exchange over 8 strips against the JAX
package's (``tests/test_halo.py``, ``tests/test_halo_train.py``): the
sharded graph build, the sharded predict, the sharded embeddings against
the single-device full-graph forward, the surrogate-loss gradient through
the exchange, one whole-slide train step with JAX's seed words and
per-shard sampler draws replayed, and the trainer's
``predict_whole_slide`` / ``fit_whole_slide``.

The JAX side runs on the 8 CPU devices of ``tests/conftest.py``; the
port runs its 8 shards on the CPU, where the kernel wrappers take their
plain versions.  The helpers take a :class:`Layout`, so that
``tests/test_torch_port_grid.py`` runs the same checks on a 4x2 grid.
"""
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from segger_tpu.data.synthetic import make_synthetic
from segger_tpu.models import ISTEncoder as JEncoder
from segger_tpu.ops.pallas import postgather as jpg
from segger_tpu.parallel import halo as jhalo
from segger_tpu.parallel.mesh import make_mesh as jmake_mesh
from segger_tpu.pipeline import ISTPipeline, PipelineConfig
from segger_tpu.train.trainer import SeggerTrainer as JTrainer
from segger_tpu.train.trainer import TrainConfig as JConfig

from segger_tpu_torch.data.assemble import save_host_graph_plane
from segger_tpu_torch.data.graph import TileGraph
from segger_tpu_torch.models import losses as TL
from segger_tpu_torch.models.convert import _flax_array, params_to_flax
from segger_tpu_torch.ops.gather_agg import csr_gather
from segger_tpu_torch.ops.padded_csr import PaddedCSR
from segger_tpu_torch.parallel import halo as thalo
from segger_tpu_torch.parallel.mesh import make_mesh, put_sharded
from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

from tests import _torch_multiprocess_worker as worker
from tests.test_halo import full_graph_tile
from tests.test_torch_port_ops import port_host_graph, port_tile
from tests.test_torch_port_train import _jax_uniforms, _t

N_DEV = 8
# tests/test_halo.py's encoder, in float32
MODEL = dict(hidden_channels=16, out_channels=16, n_mid_layers=1,
             n_heads=2, compute_dtype="float32")
WEIGHTS = np.array([0.4, 0.4, 0.2], np.float32)


class Layout(NamedTuple):
    """One decomposition, on both sides: its host build, meshes,
    predict, the port's exchanges, JAX's shard id inside ``shard_map``,
    train steps, and the trainer's keyword (``grid=``)."""
    n: int
    build_jax: Callable
    build_port: Callable
    jax_mesh: Callable
    port_mesh: Callable
    spec: P
    jax_predict: Callable
    port_predict: Callable
    port_exchanges: Callable    # per-shard halos -> (ex_tx, ex_bd)
    jax_shard_id: Callable
    jax_train_step: Callable
    port_train_step: Callable
    trainer_kw: dict


STRIPS = Layout(
    n=N_DEV,
    build_jax=lambda g, **kw: jhalo.build_sharded_graph(g, N_DEV, **kw),
    build_port=lambda g, **kw: thalo.build_sharded_graph(g, N_DEV, **kw),
    jax_mesh=lambda: jmake_mesh(N_DEV),
    port_mesh=lambda: make_mesh(devices=["cpu"] * N_DEV),
    spec=P("data"),
    jax_predict=jhalo.sharded_predict,
    port_predict=thalo.sharded_predict,
    port_exchanges=thalo.strip_exchanges,
    jax_shard_id=lambda: jax.lax.axis_index("data"),
    jax_train_step=jhalo.make_sharded_train_step,
    port_train_step=thalo.make_sharded_train_step,
    trainer_kw={},
)


def synthetic_graphs():
    """``tests/test_halo.py``'s slide: the JAX graph and its port copy."""
    s = make_synthetic(n_cells=150, n_genes=30, mean_tx_per_cell=20,
                       seed=3)
    cfg = PipelineConfig(
        cells_embedding_size=12, genes_min_counts=10, cells_min_counts=5,
        prediction_graph_mode="uniform", prediction_graph_max_k=4,
    )
    g = ISTPipeline(s.transcripts, s.boundaries, s.polygons, cfg).load().graph
    return g, port_host_graph(g)


def encoders(jg, tg):
    """The JAX encoder, its parameters (initialized on the full-graph
    tile, as ``test_halo.py`` does), that tile, and a CPU port trainer
    holding the same weights."""
    model = JEncoder(n_genes=jg.n_genes,
                     in_channels=jg.gene_embedding.shape[1],
                     hidden_channels=16, out_channels=16, n_mid_layers=1,
                     n_heads=2)
    tile = full_graph_tile(jg)
    # jitted: the same parameters as test_halo.py's eager init, sooner
    params = jax.jit(model.init)(jax.random.PRNGKey(0), tile)
    tr = SeggerTrainer(tg, TrainConfig(**MODEL), device="cpu")
    tr.load_params(params)
    return model, params, tile, tr


@pytest.fixture(scope="module")
def graphs():
    return synthetic_graphs()


@pytest.fixture(scope="module")
def models(graphs):
    return encoders(*graphs)


# ---------------------------------------------------------------------
# checks shared with the grid
# ---------------------------------------------------------------------
def check_build_equal(layout, graphs, for_training):
    """Every array of the stacked tile and of the halo spec: integers
    exactly, floats within 1e-6; the static fields equal."""
    jg, tg = graphs
    js, jh, jd = layout.build_jax(jg, for_training=for_training)
    ts, th, td = layout.build_port(tg, for_training=for_training)
    np.testing.assert_array_equal(td, jd)
    want = port_tile(js)
    assert ts.transposes_extended == for_training
    for f in dataclasses.fields(TileGraph):
        a, b = getattr(ts, f.name), getattr(want, f.name)
        if isinstance(b, PaddedCSR):
            for part in ("idx", "mask"):
                x, y = getattr(a, part), getattr(b, part)
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif b is None or isinstance(b, (bool, int)):
            assert a == b, f.name
        elif np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=f.name)
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    for f in dataclasses.fields(th):
        a, b = getattr(th, f.name), np.asarray(getattr(jh, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    if for_training:
        assert ts.tt_t is not None and ts.tt_n_lo == 0


def port_full_tile(tile):
    return port_tile(jax.tree.map(np.array, tile)).to("cpu")


def top2_margin(tr, tile):
    """Gap between the best and second-best candidate cosine of every
    transcript of the port's full-graph forward (inf with fewer than
    two candidates), by row."""
    with torch.no_grad():
        emb = tr.model(tile, pos_prenormalized=True)
        cos = torch.einsum("nf,nkf->nk", emb["tx"],
                           csr_gather(emb["bd"], tile.cand))
        cos = torch.where(tile.cand.mask, cos, -np.inf)
        cos = torch.cat([cos, torch.full_like(cos[:, :1], -np.inf)], 1)
        top = cos.topk(2, dim=1).values
    return (top[:, 0] - top[:, 1]).nan_to_num(np.inf).numpy()


def check_predict_matches_jax(layout, graphs, models):
    """The port's sharded predict against JAX's: rows equal,
    cell_encoding equal wherever the top-two margin exceeds 1e-5, the
    similarity within rtol 1e-4 / atol 1e-5."""
    jg, tg = graphs
    model, params, tile, tr = models
    want = layout.jax_predict(model, params, jg, layout.jax_mesh())
    got = layout.port_predict(tr.model, tg, layout.port_mesh())
    gi, wi = np.argsort(got["row_index"]), np.argsort(want["row_index"])
    rows = got["row_index"][gi]
    np.testing.assert_array_equal(rows, want["row_index"][wi])
    np.testing.assert_array_equal(rows, np.asarray(tile.tx_index))
    np.testing.assert_array_equal(got["gene"][gi], want["gene"][wi])
    np.testing.assert_allclose(got["similarity"][gi],
                               want["similarity"][wi], rtol=1e-4, atol=1e-5)
    # the full tile's rows are the sorted rows
    clear = top2_margin(tr, port_full_tile(tile)) > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got["cell_encoding"][gi][clear],
                                  want["cell_encoding"][wi][clear])
    assert (got["cell_encoding"][gi][clear] >= 0).sum() > 300


def check_embeddings_match_full_graph(layout, graphs, models):
    """The sharded tx embeddings against the port's single-device
    full-graph forward, at ``test_halo.py``'s 2e-4 / 1e-5."""
    _, tg = graphs
    _, _, tile, tr = models
    mesh = layout.port_mesh()
    stacked, halo, _ = layout.build_port(tg)
    shards, halos = put_sharded(stacked, mesh), put_sharded(halo, mesh)
    with torch.no_grad():
        emb = thalo.sharded_forward(tr.model, mesh, shards,
                                    layout.port_exchanges(halos)[0])
        want = tr.model(port_full_tile(tile), pos_prenormalized=True)["tx"]
    e = torch.cat([x["tx"] for x in emb]).numpy()
    idx = np.concatenate([t.tx_index.numpy() for t in shards])
    valid = np.concatenate([t.tx_valid.numpy() for t in shards])
    got = e[valid][np.argsort(idx[valid])]
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-4, atol=1e-5)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def check_surrogate_gradient(layout, graphs, models):
    """``test_halo_train.py``'s deterministic surrogate loss (a node term
    over every transcript, a link term over every supervision edge that
    reads the neighbours' embeddings through a final exchange) through
    the port's shards, against JAX's single-device gradient: within
    5e-5 of scale."""
    jg, tg = graphs
    model, params, tile, tr = models
    sg_src, sg_dst = jnp.asarray(jg.sg_src), jnp.asarray(jg.sg_dst)

    def loss_single(p):
        emb = model.apply(p, tile, pos_prenormalized=True)
        link = (emb["tx"][sg_src] * emb["bd"][sg_dst]).sum(-1)
        return (emb["tx"] ** 2).sum(-1).mean() + link.mean()

    g_ref = _flat(jax.jit(jax.grad(loss_single))(params))

    mesh = layout.port_mesh()
    stacked, halo, dropped = layout.build_port(tg, for_training=True)
    assert not dropped.any() and stacked.transposes_extended
    shards, halos = put_sharded(stacked, mesh), put_sharded(halo, mesh)
    ex_tx, _ = layout.port_exchanges(halos)
    tr.model.zero_grad(set_to_none=True)
    emb = thalo.sharded_forward(tr.model, mesh, shards, ex_tx)
    tx_ext = ex_tx([e["tx"] for e in emb])
    c_node = sum(int(t.tx_valid.sum()) for t in shards)
    c_link = sum(int(t.sg_mask.sum()) for t in shards)
    loss = 0.0
    for t, e, ext in zip(shards, emb, tx_ext):
        node = torch.where(t.tx_valid, (e["tx"] ** 2).sum(-1), 0.0).sum()
        link = (torch.cat(ext)[t.sg_src.long()]
                * e["bd"][t.sg_dst.long()]).sum(-1)
        loss = loss + node / c_node + torch.where(
            t.sg_mask, link, 0.0).sum() / c_link
    loss.backward()
    got = dict(_flax_array(n, p.grad) for n, p in
               tr.model.named_parameters())
    assert got.keys() == g_ref.keys()
    flat_ref = np.concatenate([g_ref[k].ravel() for k in sorted(g_ref)])
    flat_got = np.concatenate([got[k].ravel() for k in sorted(g_ref)])
    scale = np.abs(flat_ref).max() + 1e-12
    np.testing.assert_allclose(flat_got / scale, flat_ref / scale,
                               atol=5e-5)


def _jax_train_step(layout, jg, model, params, monkeypatch):
    """One JAX whole-slide step (the Pallas edge stage in interpret mode,
    so that its hashed dropout is the port's), with the seed words of
    every edge-stage launch recorded per shard and launch."""
    monkeypatch.setenv("SEGGER_EDGE_STAGE", "pallas")
    seeds, launch = {}, [0]
    orig = jpg.gatv2_edge_stage_pallas

    def recording(xl, xr, att, keep, csr, csr_t, config):
        if keep.ndim == 1:
            i = launch[0]
            launch[0] += 1

            def record(shard, words, i=i):
                seeds[(int(shard), i)] = tuple(
                    int(v) for v in np.asarray(words).view(np.uint32))
            jax.debug.callback(record, layout.jax_shard_id(), keep)
        return orig(xl, xr, att, keep, csr, csr_t, config)

    monkeypatch.setattr(jpg, "gatv2_edge_stage_pallas", recording)
    mesh = layout.jax_mesh()
    stacked, halo, _ = layout.build_jax(jg, for_training=True)
    sharding = NamedSharding(mesh, layout.spec)
    put = lambda tree: jax.tree.map(  # noqa: E731
        lambda x: jax.device_put(jnp.asarray(x), sharding), tree)
    opt = optax.adam(1e-3)
    step = layout.jax_train_step(
        model, opt, mesh, jnp.asarray(jg.tx_similarity),
        jnp.asarray(jg.bd_similarity))
    key = jax.random.PRNGKey(11)
    new, _, loss, aux = step(params, opt.init(params), put(stacked),
                             put(halo), key, jnp.asarray(WEIGHTS))
    jax.block_until_ready(new)
    per_shard = [[seeds[(d, i)] for i in range(launch[0])]
                 for d in range(layout.n)]
    return float(loss), np.asarray(aux), new, per_shard, key


def check_train_step(layout, graphs, models, monkeypatch):
    """One ``make_*_train_step`` step against JAX's, with JAX's seed
    words and per-shard sampler draws (``fold_in(key, shard)`` split as
    the JAX step splits it) replayed: the loss within 1e-5 relative, the
    parameters after Adam within 1e-6."""
    jg, tg = graphs
    model, params, _, _ = models
    loss_j, aux_j, new_j, seeds, key = _jax_train_step(
        layout, jg, model, params, monkeypatch)
    # a fresh trainer: its Adam state starts at zero, as optax's does
    tr = SeggerTrainer(tg, TrainConfig(**MODEL), device="cpu")
    tr.load_params(params)
    assert len(seeds[0]) == tr.model.seed_launches(
        layout.build_port(tg, for_training=True)[0])

    def randoms(d, tile):
        _, k_tx, k_bd, k_sg = jax.random.split(jax.random.fold_in(key, d), 4)
        nb = max(int(tile.bd_valid.sum()), 2)
        return TL.LossRandoms(
            tuple(_t(a) for a in _jax_uniforms(k_tx, tile.tx_valid.shape[0])),
            tuple(_t(a) for a in _jax_uniforms(k_bd, tile.bd_valid.shape[0])),
            _t(jax.random.randint(k_sg, (tile.sg_src.shape[0],), 1, nb)
               ).long())

    mesh = layout.port_mesh()
    stacked, halo, _ = layout.build_port(tg, for_training=True)
    step = layout.port_train_step(tr.model, tr.optimizer, mesh,
                                  tr.tx_similarity, tr.bd_similarity)
    its = [iter(s) for s in seeds]
    loss, aux = step(put_sharded(stacked, mesh), put_sharded(halo, mesh),
                     [lambda it=it: next(it) for it in its], randoms,
                     WEIGHTS)
    assert all(next(it, None) is None for it in its)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    np.testing.assert_allclose(aux.numpy(), aux_j, rtol=1e-5)
    grads = dict(_flax_array(n, p.grad) for n, p in
                 tr.model.named_parameters())
    got = _flat(params_to_flax(tr.model))
    n_big = 0
    for path, a in _flat(new_j).items():
        # Adam's first step is lr * g / (|g| + eps): only gradients well
        # above eps fix it
        big = np.abs(grads[path]) > 1e-6
        n_big += int(big.sum())
        np.testing.assert_allclose(got[path][big], a[big], atol=1e-6,
                                   err_msg="/".join(path))
    assert n_big > 1000


def check_trainer_whole_slide(layout, graphs, mesh):
    """``fit_whole_slide`` for 4 epochs (finite losses that move, JAX's
    history keys), then ``predict_whole_slide`` covers every transcript
    exactly once."""
    jg, tg = graphs
    small = dict(hidden_channels=8, out_channels=8, n_mid_layers=0,
                 n_heads=1, seed=0)
    jtr = JTrainer(jg, JConfig(**small))
    # initialized here by a jitted init: the trainer's own is eager and
    # takes most of the time; only the history's keys are compared
    template = jax.tree.map(lambda a: np.asarray(a)[0],
                            layout.build_jax(jg)[0])
    jtr.params = jax.jit(jtr.model.init)(jax.random.PRNGKey(0), template)
    jtr.opt_state = jtr.tx.init(jtr.params)
    want_keys = jtr.fit_whole_slide(layout.jax_mesh(), max_epochs=1,
                                    **layout.trainer_kw)[0].keys()
    tr = SeggerTrainer(tg, TrainConfig(**small), device="cpu", mesh=mesh)
    history = tr.fit_whole_slide(max_epochs=4, **layout.trainer_kw)
    assert len(history) == 4 and history[0].keys() == want_keys
    losses = [h["train:loss"] for h in history]
    assert np.isfinite(losses).all() and losses[-1] != losses[0]
    assert all(torch.isfinite(p).all() for p in tr.model.parameters())
    preds = tr.predict_whole_slide(**layout.trainer_kw)
    assert len(preds["row_index"]) == tg.n_tx
    assert len(np.unique(preds["row_index"])) == tg.n_tx
    assert set(preds) == {"row_index", "cell_encoding", "similarity", "gene"}


# ---------------------------------------------------------------------
# the strips
# ---------------------------------------------------------------------
@pytest.mark.parametrize("for_training", [False, True])
def test_build_sharded_graph_equals_jax(graphs, for_training):
    check_build_equal(STRIPS, graphs, for_training)


def test_sharded_predict_matches_jax(graphs, models):
    check_predict_matches_jax(STRIPS, graphs, models)


def test_sharded_embeddings_match_full_graph(graphs, models):
    check_embeddings_match_full_graph(STRIPS, graphs, models)


def test_sharded_training_grads_match_single_device(graphs, models):
    check_surrogate_gradient(STRIPS, graphs, models)


def test_sharded_train_step_matches_jax(graphs, models, monkeypatch):
    check_train_step(STRIPS, graphs, models, monkeypatch)


def test_trainer_whole_slide(graphs):
    check_trainer_whole_slide(STRIPS, graphs, STRIPS.port_mesh())


def test_exchange_zeros_at_the_ends_and_on_padding():
    """Shard 0 gets no left halo and the last no right one; masked send
    slots carry zeros."""
    xs = [torch.full((4, 2), float(d + 1)) for d in range(3)]
    idx = [torch.tensor([0, 3, 1]) for _ in range(3)]
    mask = [torch.tensor([True, False, True]) for _ in range(3)]
    out = thalo._exchange_1d(xs, idx, mask, idx, mask)
    for d, (local, left, right) in enumerate(out):
        assert local is xs[d]
        want_l = torch.zeros(3, 2) if d == 0 else torch.tensor(
            [[d, d], [0, 0], [d, d]], dtype=torch.float32)
        want_r = torch.zeros(3, 2) if d == 2 else torch.tensor(
            [[d + 2, d + 2], [0, 0], [d + 2, d + 2]], dtype=torch.float32)
        assert torch.equal(left, want_l) and torch.equal(right, want_r)


def test_predict_backward_without_transposes_raises(graphs, models):
    """The predict build has no transpose tables: its fused convs run the
    forward kernel alone, and a backward through them raises."""
    _, tg = graphs
    tr = models[3]
    mesh = make_mesh(devices=["cpu"] * 2)
    stacked, halo, _ = thalo.build_sharded_graph(tg, 2)
    shards, halos = put_sharded(stacked, mesh), put_sharded(halo, mesh)
    emb = thalo.sharded_forward(tr.model, mesh, shards,
                                thalo.strip_exchanges(halos)[0])
    with pytest.raises(ValueError, match="transpose table"):
        emb[0]["tx"].sum().backward()


def test_tile_dp_mesh_rounds_tiles_per_step(graphs):
    """Tile data parallelism over a mesh of CPU shards is ported: the mesh
    rounds ``tiles_per_step`` to its size, and an empty predict runs."""
    _, tg = graphs
    tr = SeggerTrainer(tg, TrainConfig(**MODEL), device="cpu",
                       mesh=make_mesh(devices=["cpu"] * 2))
    tr.init()
    assert tr.tile_dp and tr.cfg.tiles_per_step == 2
    assert all(v.size == 0 for v in tr.predict([]).values())


# ---------------------------------------------------------------------
# several processes, each case in processes of its own
# (tests/_torch_multiprocess_worker.py, chip_smoke.py's ranks), so that
# no process group is left in the test process; the cases run side by
# side
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def started_ranks(graphs, tmp_path_factory):
    """The worker's cases, started: each case's directory and ranks."""
    _, tg = graphs
    started = {}
    for mode, world in (("one-rank", 1), ("nccl-one-card", 2),
                        ("checksum", 2)):
        work = tmp_path_factory.mktemp(mode)
        save_host_graph_plane(tg, work / "graph", with_edge_groups=False)
        started[mode] = (work, worker.start_ranks(mode, work, world))
    return started


@pytest.fixture(scope="module")
def rank_runs(started_ranks):
    """Each case's directory and its ranks' ``(returncode, log)``."""
    return {mode: (work, worker.wait_ranks(ranks))
            for mode, (work, ranks) in started_ranks.items()}


def test_chip_smoke_multiprocess_drive_on_the_cpu(started_ranks, tmp_path):
    """``chip_smoke.py``'s phase 12 small on the CPU: two gloo ranks of
    the script itself, one CPU shard each, against one process of two
    CPU shards on its synthetic slide: predicts bit-equal at 2 strips and
    a 2x1 grid, the fit's losses within ``GRAPH_STEP_RTOL``, the
    parameters equal on both ranks."""
    import chip_smoke

    g = chip_smoke.synthetic_slide(n_tx=1200, n_cells=60, n_genes=20,
                                   f_bd=12)
    kw = dict(hidden_channels=8, out_channels=8, n_mid_layers=0)
    state = chip_smoke.ws_trainer(g, None, torch.device("cpu"), "float32",
                                  1, kw).model.state_dict()
    mp = chip_smoke.drive_multiprocess(tmp_path, g, state, device="cpu",
                                       epochs=2, train_kw=kw)
    assert len(mp["ranks"]) == 2 and mp["backend"] == "gloo"
    assert set(mp["ranks"][0]["preds"]) == {"strips", "2x1 grid"}
    for r in mp["checks"].values():
        assert r["device"] == "cpu" and len(r["losses"]) == 2
        assert r["loss_rel"] <= chip_smoke.GRAPH_STEP_RTOL


def _ranks_fail_with(runs, message):
    for code, log in runs:
        assert code != 0 and message in log, log[-4000:]


def test_one_rank_group_predicts_as_no_group(rank_runs):
    """``initialize_multihost()`` with no arguments reads torchrun's
    variables; with one rank its default mesh is the rank's two CPU
    shards, and ``predict_whole_slide`` equals the predict over two CPU
    shards without a group, bit for bit."""
    work, ((code, log),) = rank_runs["one-rank"]
    assert code == 0 and "RANK_OK 0" in log, log[-4000:]
    (res,) = worker.results(work, world=1)
    assert res["world"] == 1 and res["owners"] == (0, 0)
    assert res["group"].keys() == res["no group"].keys()
    for k, v in res["no group"].items():
        np.testing.assert_array_equal(res["group"][k], v, err_msg=k)


def test_two_nccl_ranks_on_one_card_raise(rank_runs):
    """Two NCCL ranks naming one card raise on both ranks, before any
    collective and before CUDA is touched (so here, with no card)."""
    _ranks_fail_with(rank_runs["nccl-one-card"][1],
                     "NCCL cannot run two ranks on one card: ranks [0, 1]")


def test_ranks_with_differing_parameters_raise(rank_runs):
    """``fit_whole_slide`` checks that every rank holds the same
    parameters before its first step: a rank that changed one weight
    makes both ranks raise, naming it."""
    _ranks_fail_with(rank_runs["checksum"][1],
                     "parameter checksums differ across ranks: rank(s) [1]")


def test_shard_generators_differ_and_repeat(graphs):
    """Each shard draws from its own generator, seeded with ``(seed + 1,
    epoch, shard)`` (the JAX package folds the shard's axis index into the
    epoch key): shards and epochs differ, and a second trainer draws the
    same numbers."""
    _, tg = graphs
    a, b = (SeggerTrainer(tg, TrainConfig(**MODEL), device="cpu")
            for _ in range(2))
    draws = {(e, d): torch.rand(4, generator=a.shard_generator(e, d))
             for e in range(2) for d in range(3)}
    assert len({tuple(v.tolist()) for v in draws.values()}) == 6
    for (e, d), v in draws.items():
        assert torch.equal(torch.rand(4, generator=b.shard_generator(e, d)),
                           v)


def test_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="3 shards need 3 devices"):
        make_mesh(3, devices=["cpu"] * 2)
