"""The port's whole-slide execution over a 4x2 grid (the two-stage
relay) against the JAX package's (``tests/test_grid.py``): the grid
build, the grid predict, the embeddings against the single-device
full-graph forward (corner edges relayed through both stages), the
surrogate-loss gradient, one grid train step with JAX's seed words and
per-shard sampler draws replayed, and the trainer with ``grid=``.  The
checks are ``tests/test_torch_port_halo.py``'s."""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from segger_tpu.parallel import grid as jgrid

from segger_tpu_torch.parallel import grid as tgrid

from tests.test_torch_port_halo import (
    Layout, check_build_equal, check_embeddings_match_full_graph,
    check_predict_matches_jax, check_surrogate_gradient, check_train_step,
    check_trainer_whole_slide, encoders, synthetic_graphs,
)

DX, DY = 4, 2

GRID = Layout(
    n=DX * DY,
    build_jax=lambda g, **kw: jgrid.build_grid_sharded_graph(g, DX, DY,
                                                             **kw),
    build_port=lambda g, **kw: tgrid.build_grid_sharded_graph(g, DX, DY,
                                                              **kw),
    jax_mesh=lambda: jgrid.make_grid_mesh(DX, DY),
    port_mesh=lambda: tgrid.make_grid_mesh(DX, DY,
                                           devices=["cpu"] * (DX * DY)),
    spec=P(("x", "y")),
    jax_predict=jgrid.grid_predict,
    port_predict=tgrid.grid_predict,
    port_exchanges=lambda halos: tgrid.grid_exchanges(halos, DX, DY),
    jax_shard_id=lambda: (jax.lax.axis_index("x") * DY
                          + jax.lax.axis_index("y")),
    jax_train_step=jgrid.make_grid_train_step,
    port_train_step=tgrid.make_grid_train_step,
    trainer_kw={"grid": (DX, DY)},
)


@pytest.fixture(scope="module")
def graphs():
    return synthetic_graphs()


@pytest.fixture(scope="module")
def models(graphs):
    return encoders(*graphs)


@pytest.mark.parametrize("for_training", [False, True])
def test_build_grid_sharded_graph_equals_jax(graphs, for_training):
    check_build_equal(GRID, graphs, for_training)
    _, halo, _ = GRID.build_port(graphs[1], for_training=for_training)
    # the decomposition exercises the y stage
    assert halo.tx_send_yu_mask.any() and halo.tx_send_yd_mask.any()


def test_grid_predict_matches_jax(graphs, models):
    check_predict_matches_jax(GRID, graphs, models)


def test_grid_embeddings_match_full_graph(graphs, models):
    check_embeddings_match_full_graph(GRID, graphs, models)


def test_grid_training_grads_match_single_device(graphs, models):
    check_surrogate_gradient(GRID, graphs, models)


def test_grid_train_step_matches_jax(graphs, models, monkeypatch):
    check_train_step(GRID, graphs, models, monkeypatch)


def test_trainer_grid_whole_slide(graphs):
    check_trainer_whole_slide(GRID, graphs, None)


def test_grid_mesh_needs_dx_dy_devices():
    with pytest.raises(ValueError, match="8 shards need 8 devices"):
        tgrid.make_grid_mesh(DX, DY, devices=["cpu"] * 4)
    mesh = tgrid.make_grid_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"x": 2, "y": 2} and mesh.size == 4


def test_relay_reaches_the_corner():
    """A row sent right by shard (0, 0) and relayed up by (1, 0) reaches
    (1, 1), the diagonal neighbour, in its from-below piece."""
    import torch

    xs = [torch.full((2, 1), float(d + 1)) for d in range(4)]
    zero = [torch.zeros(1, dtype=torch.int64) for _ in range(4)]
    on = [torch.ones(1, dtype=torch.bool) for _ in range(4)]
    # (1, 0) relays its x-extended row P + 0 (the from-left piece) up
    up = [torch.tensor([2]) for _ in range(4)]
    out = tgrid._exchange_2d(xs, zero, on, zero, on, zero, on, up, on, 2, 2)
    # shard ids gx * 2 + gy: (1, 1) is 3, its from-below piece is [3]
    np.testing.assert_array_equal(out[3][3].numpy(), [[1.0]])
    # (0, 1) gets the relay of (0, 0), which has no left neighbour
    np.testing.assert_array_equal(out[1][3].numpy(), [[0.0]])
