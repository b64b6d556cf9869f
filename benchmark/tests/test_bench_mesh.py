"""The harness on a cell of several chips, driven on the CPU at a tiny
size with the mesh's four shards on the CPU: the trainer runs the
program's tile data parallelism, the recorder holds every tile of a
compared step with the draws in global tile order, and the reference
over a one-tile batch is the one-tile reference it always was, bit for
bit.  The fullest card's peak memory is the peak."""
import pytest
import torch

import compare
import harness

SEED = 2**31 + 23
CELL = "xenium5k-fit-4card"


@pytest.fixture(scope="module")
def env(tiny):
    cell = harness.cell_spec(CELL, root=tiny, bench=tiny / "benchmark")
    env = harness.Env(cell, SEED, "cpu")
    harness.fit_setup(env, first_epoch_only=True)
    return env


def test_the_cell_runs_the_programs_tile_data_parallelism(env):
    tr = env.trainer
    assert tr.tile_dp and tr.mesh.size == 4
    assert [d.type for d in tr.mesh.devices] == ["cpu"] * 4
    assert tr.cfg.tiles_per_step == 4
    assert env.devices == [torch.device("cpu")]


def test_the_recorder_holds_every_tile_in_global_order(env):
    """The recorded seed words and uniforms of the first compared step
    are what one device draws for its 4 tiles from the epoch's generator,
    tile by tile."""
    from segger_tpu_torch.train.graphs import StepInputs

    tr = env.trainer
    steps = env.recorder.steps
    assert len(steps) == env.traffic["compare_steps"]
    first = steps[0]
    batch = first["batch"]
    assert batch.tx_gene.shape[0] == 4
    assert first["tx_u"].shape[0] == first["bd_u"].shape[0] == 4
    assert first["sg_u"].shape[0] == 4
    n_seeds = tr.model.seed_launches(batch) * 4
    assert first["seeds"].shape == (n_seeds, 2)
    one = StepInputs.like(batch, n_seeds, "cpu")
    _, gen = tr.epoch_streams(0)
    tr._draw([one], 4, 4, gen)
    for key in ("seeds", "tx_u", "bd_u", "sg_u"):
        assert torch.equal(first[key], getattr(one, key)), key
    assert len(compare.step_tiles(first)) == 4


def test_the_compared_steps_are_correct(env):
    readings = compare.fit_check(env)
    assert compare.judge(readings, env.traffic["limits"]), readings


def old_train_step(ref, p, tile, seeds, tx_u, bd_u, sg_u, weights, sims,
                   model):
    """The reference's one-tile step as it stood before it took a batch
    of tiles: its loss and gradients."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    emb = ref.forward(leaves, tile, model, seeds, "f32")
    loss = ref.step_loss(ref.loss_parts(emb, tile, tx_u, bd_u, sg_u, *sims,
                                        model), weights)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), dict(zip(leaves, grads))


def test_a_one_tile_batch_is_the_old_reference_bit_for_bit(tiny):
    cell = harness.cell_spec("xenium5k-fit", root=tiny,
                             bench=tiny / "benchmark")
    env = harness.Env(cell, SEED, "cpu")
    harness.fit_setup(env, first_epoch_only=True)
    ref, model = env.reference, env.model_cfg
    step = env.recorder.steps[0]
    tile = harness.to_torch(harness.tile_dict(step["batch"], 0), "cpu")
    seeds = [tuple(int(w) for w in r) for r in step["seeds"].tolist()]
    sims = [torch.from_numpy(a.astype("float32"))
            for a in (env.graph.tx_similarity, env.graph.bd_similarity)]
    weights = ref.loss_weights(0, model["max_epochs"], model)
    p = {k: v.detach().clone().float() for k, v in env.weights.items()}
    u = (step["tx_u"][0], step["bd_u"][0], step["sg_u"][0])
    # one thread: with several, the CPU's scatter-adds in the backward
    # sum in an order that varies from call to call
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want_loss, want = old_train_step(ref, p, tile, seeds, *u, weights,
                                         sims, model)
        loss, grads = ref.train_step(dict(p), {"t": 0, "m": {}, "v": {}},
                                     [(tile, seeds, *u)], weights, *sims,
                                     model)
    finally:
        torch.set_num_threads(threads)
    assert loss == want_loss
    for k, g in want.items():
        assert torch.equal(grads[k], torch.zeros_like(p[k]) if g is None
                           else g), k


def test_memory_peak_is_the_fullest_cards(monkeypatch):
    peaks = {0: 5, 1: 9, 2: 7, 3: 1}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[d.index])
    cards = [torch.device("cuda", i) for i in range(4)]
    assert harness.memory_peak(cards[:1]) == 5
    assert harness.memory_peak(cards) == 9
    assert harness.memory_peak([torch.device("cpu")]) == 0


@pytest.mark.parametrize("fault", [{"half": True}, {"half_tiles": True},
                                   {"exchange": False}])
def test_the_calibrations_planted_faults_are_not_correct(env, fault):
    """The faults ``calibrate.py`` reads in the reference put in the
    program's place: half of each tile's rows, half of the tiles, the
    gradients' exchange left out."""
    ref = compare.reference_fit(env, "f32")
    side = compare.reference_fit(env, "f32", **fault)
    readings = compare.fit_readings(side, ref)
    limits = {k: v for k, v in env.traffic["limits"].items()
              if k in readings}
    assert not compare.judge(readings, limits), readings
