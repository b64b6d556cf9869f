"""Whole-loop parity of the port: its CPU trainer against the float64
PyG reference loop of ``tests/test_loop_parity.py`` (built on
``tests/pyg_vendor.py``), at that test's limits.

Both loops start from the same flax init and run S = 24 full-batch steps
of the three-loss objective under the test's weight schedule and
Adam(1e-3), with no dropout (the reference loop runs the encoder
deterministic; here every conv's dropout rate is 0).  The port runs each
step as its trainer runs a training step: the compiled step body, fed
through its step inputs.  JAX's sampler draws for each step's keys are
written into those inputs, the uniforms the samplers take and, for the
segmentation loss, uniforms whose shift ``1 + floor(u * (nb - 1))`` is
JAX's ``randint`` draw; the reference loop replays the same draws.
"""
import jax
import numpy as np
import pytest
import torch

from segger_tpu_torch.data.partition import stack_tiles
from segger_tpu_torch.models.gatv2 import GATv2Conv
from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

from tests import test_loop_parity as LP
from tests.test_loop_parity import setup  # noqa: F401  (the fixture)
from tests.test_torch_port_ops import port_host_graph, port_tile
from tests.test_torch_port_train import _jax_uniforms


def _cluster_similarity(labels):
    """The reference loop's cluster similarity: 1 on the diagonal, -1
    elsewhere."""
    return np.eye(int(np.asarray(labels).max()) + 1, dtype=np.float32) * 2 - 1


def run_port_loop(graph, tile, params, sg_loss_type):
    """S steps of the port's compiled train step on the CPU; returns the
    per-step losses and the final embeddings."""
    host = port_host_graph(graph)
    host.tx_similarity = _cluster_similarity(tile.tx_cluster)
    host.bd_similarity = _cluster_similarity(tile.bd_cluster)
    tr = SeggerTrainer(host, TrainConfig(
        hidden_channels=LP.HIDDEN, out_channels=LP.OUT,
        n_mid_layers=LP.N_MID, n_heads=LP.HEADS, learning_rate=LP.LR,
        tx_margin=LP.TX_MARGIN, sg_margin=LP.SG_MARGIN,
        sg_loss_type=sg_loss_type, compute_dtype="float32"), device="cpu")
    tr.load_params(params)
    for m in tr.model.modules():
        if isinstance(m, GATv2Conv):
            m.dropout = 0.0
    t = port_tile(tile)
    batch = stack_tiles([t])
    n_tx, n_bd = t.tx_valid.size, t.bd_valid.size
    nb = max(int(t.bd_valid.sum()), 2)
    losses = []
    for i in range(LP.S):
        k_tx, k_bd, k_sg = LP._step_keys(i)
        step = tr._step("train", batch)
        tr._stage(step, batch)
        inp = step.inputs
        assert inp.seeds.shape[0] == 0
        inp.tx_u[0] = torch.stack([torch.from_numpy(np.array(u))
                                   for u in _jax_uniforms(k_tx, n_tx)])
        inp.bd_u[0] = torch.stack([torch.from_numpy(np.array(u))
                                   for u in _jax_uniforms(k_bd, n_bd)])
        shift = np.asarray(jax.random.randint(k_sg, (t.sg_src.size,), 1, nb))
        inp.sg_u[0] = torch.from_numpy((shift - 0.5) / (nb - 1))
        inp.weights.copy_(torch.from_numpy(np.asarray(LP._weights(i),
                                                      np.float32)))
        losses.append(tr._run("train", step).tolist()[0])
    with torch.no_grad():
        emb = tr.model(t.to("cpu"))
    return np.asarray(losses), {k: v.numpy() for k, v in emb.items()}


@pytest.mark.parametrize("sg_loss_type", ["triplet", "bce"])
def test_port_loop_matches_pyg_loop(setup, sg_loss_type):  # noqa: F811
    graph, tile, model, params = setup
    params = jax.tree.map(np.asarray, params)
    ref_loss, ref_emb = LP.run_torch_loop(graph, tile, model, params,
                                          sg_loss_type)
    loss, emb = run_port_loop(graph, tile, params, sg_loss_type)

    # loss curves track step by step (f32 port vs f64 reference)
    np.testing.assert_allclose(loss, ref_loss, rtol=5e-3, atol=5e-4)

    # final above-threshold transcript assignments >= 99% identical;
    # BCE compares over the reference's most confident half
    seg_p, sim_p = LP._assignments(emb, tile)
    seg_r, sim_r = LP._assignments(ref_emb, tile)
    thr = 0.5 if sg_loss_type == "triplet" else float(np.median(sim_r))
    above = (sim_p > thr) | (sim_r > thr)
    assert above.sum() > 100  # the comparison is not vacuous
    agree = (seg_p[above] == seg_r[above]).mean()
    assert agree >= 0.99, f"assignment agreement {agree:.4f}"

    np.testing.assert_allclose(emb["tx"], ref_emb["tx"], rtol=5e-2,
                               atol=5e-3)
