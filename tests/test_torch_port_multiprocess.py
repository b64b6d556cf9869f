"""The port's whole-slide predict over several processes on the CPU: two
gloo ranks of two CPU shards each (``tests/_torch_multiprocess_worker.py``)
against the JAX package's ``sharded_predict`` on a 4-device CPU mesh and
against the port's one-process predict over 4 CPU shards, at 4 strips
and on the 2x2 grid.

The slide and the encoder are ``tests/_multihost_worker.py``'s (the JAX
package's two-process test); the parent builds the graph and the weights
with the JAX package and hands them to the ranks as files, and runs the
JAX predict while the ranks run.
"""
import jax
import numpy as np
import pytest
import torch

from segger_tpu.data.synthetic import make_synthetic
from segger_tpu.models import ISTEncoder as JEncoder
from segger_tpu.parallel.halo import sharded_predict as jsharded_predict
from segger_tpu.parallel.mesh import make_mesh as jmake_mesh
from segger_tpu.pipeline import ISTPipeline, PipelineConfig

from segger_tpu_torch.data.assemble import save_host_graph_plane
from segger_tpu_torch.models.convert import params_from_flax

from tests import _torch_multiprocess_worker as worker
from tests.test_halo import full_graph_tile
from tests.test_torch_port_ops import port_host_graph

LAYOUTS = ("strips", "grid")


def multihost_graph():
    """``tests/_multihost_worker.py``'s slide, built by the JAX package."""
    s = make_synthetic(n_cells=80, n_genes=24, mean_tx_per_cell=15, seed=5)
    cfg = PipelineConfig(cells_embedding_size=8, genes_min_counts=5,
                         cells_min_counts=3, prediction_graph_mode="uniform",
                         prediction_graph_max_k=4)
    return ISTPipeline(s.transcripts, s.boundaries, s.polygons,
                       cfg).load().graph


def multihost_encoder(graph):
    """``tests/_multihost_worker.py``'s encoder and its parameters,
    initialized on the full-graph tile."""
    model = JEncoder(n_genes=graph.n_genes,
                     in_channels=graph.gene_embedding.shape[1],
                     hidden_channels=8, out_channels=8, n_mid_layers=1,
                     n_heads=2)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 full_graph_tile(graph))
    return model, params


def write_slide(work_dir, graph, params=None) -> None:
    """The port's copy of ``graph`` (and ``params`` as a port state dict)
    where the ranks read them."""
    save_host_graph_plane(port_host_graph(graph), work_dir / "graph",
                          with_edge_groups=False)
    if params is not None:
        torch.save(params_from_flax(params), work_dir / "state.pt")


def assert_ranks_ok(runs) -> None:
    for r, (code, log) in enumerate(runs):
        assert code == 0 and f"RANK_OK {r}" in log, log[-4000:]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results and the JAX predict, run side by side."""
    work = tmp_path_factory.mktemp("multiprocess_predict")
    graph = multihost_graph()
    model, params = multihost_encoder(graph)
    write_slide(work, graph, params)
    ranks = worker.start_ranks("predict", work)
    want = jsharded_predict(model, jax.tree.map(np.asarray, params), graph,
                            jmake_mesh(4))
    assert_ranks_ok(worker.wait_ranks(ranks))
    return worker.results(work), want, np.sort(graph.tx_index)


def _sorted(pred):
    o = np.argsort(pred["row_index"])
    return {k: v[o] for k, v in pred.items()}


def test_global_mesh_spans_the_ranks(run):
    """After ``initialize_multihost`` the default mesh holds every rank's
    shards in rank order, and each rank drives its own."""
    (r0, r1), _, _ = run
    for r, res in enumerate((r0, r1)):
        assert res["mesh"]["owners"] == (0, 0, 1, 1)
        assert res["mesh"]["local"] == (2 * r, 2 * r + 1)
        assert res["mesh"]["devices"] == ["cpu"] * 4


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranks_return_the_same_predictions(run, layout):
    """``fetch_global`` gathers every shard to every rank: both ranks
    return the same arrays, one row per transcript."""
    (r0, r1), _, rows = run
    assert r0[layout].keys() == r1[layout].keys()
    for k in r0[layout]:
        np.testing.assert_array_equal(r0[layout][k], r1[layout][k],
                                      err_msg=k)
    np.testing.assert_array_equal(np.sort(r0[layout]["row_index"]), rows)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_predict_bit_equal_to_one_process(run, layout):
    """Two ranks of two shards against one process of four, in the same
    shard order: every array bit for bit, as gloo only moves bytes."""
    (r0, _), _, _ = run
    ref = r0[f"{layout} one process"]
    for k in ref:
        np.testing.assert_array_equal(r0[layout][k], ref[k], err_msg=k)


def test_predict_matches_jax(run):
    """The two-rank strips against the JAX package's ``sharded_predict``
    on a 4-device CPU mesh, at ``tests/_multihost_worker.py``'s limits:
    rows, genes and cells equal, the similarity within rtol 1e-4, atol
    1e-5."""
    (r0, _), want, _ = run
    got, want = _sorted(r0["strips"]), _sorted(want)
    for k in ("row_index", "gene", "cell_encoding"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["similarity"], want["similarity"],
                               rtol=1e-4, atol=1e-5)
