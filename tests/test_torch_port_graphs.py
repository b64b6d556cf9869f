"""The port trainer's compiled steps (``segger_tpu_torch/train/graphs.py``).

On the CPU: the buffer-fed step bodies against the eager ``train_step`` /
``eval_step`` bit for bit, ``scan_steps`` against an eager loop, the edge
stage with its seed words in a tensor against the same words as ints,
the transfer counters, and a resume into the optimizer.  On the card
(``gpu``): replays with new seed words against eager calls, one capture
per new bucket shape, the resume into a capturable Adam, and the loss
rows read one step late against one read-back at each pass's end.  No JAX is
imported, so on a CUDA machine these run as

    python -m pytest --noconftest -m gpu tests/test_torch_port_graphs.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import synthetic_slide
from segger_tpu_torch.data.partition import (
    build_tiling, make_fit_tiles, make_predict_tiles,
)
from segger_tpu_torch.ops.padded_csr import PaddedCSR, transpose_csr
from segger_tpu_torch.ops.postgather import (
    edge_stage_bwd, edge_stage_fwd, gatv2_edge_stage, seed_tensor,
)
from segger_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from segger_tpu_torch.train.graphs import tile_arrays
from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig, _means
from segger_tpu_torch.utils_profiling import StageTimer, set_substage_timer

# 16 fit tiles: 7 train (a 7-step epoch), 9 val
MODEL = dict(hidden_channels=16, out_channels=16, n_mid_layers=0,
             n_heads=2, training_fraction=0.45)


@pytest.fixture(scope="module")
def slide():
    g = synthetic_slide(n_tx=6000, n_cells=300, n_genes=30, f_gene=8,
                        f_bd=8, seed=1)
    tree = build_tiling(g, nodes_per_tile=600)
    return (g, make_fit_tiles(g, tree, margin=8.0),
            make_predict_tiles(g, tree, margin=8.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _trainer(graph, device="cpu", **cfg):
    tr = SeggerTrainer(graph, TrainConfig(**dict(MODEL, **cfg)),
                       device=device)
    tr.init()
    return tr


def _compiled(tr, kind, batch, gen=None, weights=None):
    step = tr._step(kind, batch)
    tr._stage(step, batch, gen, weights)
    return tr._run(kind, step)


def _params(tr):
    return {k: v.detach().cpu().clone()
            for k, v in tr.model.state_dict().items()}


def _assert_same_params(a, b):
    for k, v in a.items():
        torch.testing.assert_close(b[k], v, atol=0, rtol=0, msg=k)


@pytest.mark.parametrize("dtype,tiles_per_step", [
    ("float32", 1), ("bfloat16", 1), ("float32", 2)])
def test_compiled_bodies_equal_eager_steps(slide, dtype, tiles_per_step):
    """Three train steps and three eval steps through the step inputs,
    eagerly on the CPU, give the loss rows, parameters and Adam state of
    the eager steps bit for bit: the same random numbers, drawn in the
    same order, reach the same ops."""
    g, fit, _ = slide
    cfg = dict(compute_dtype=dtype, tiles_per_step=tiles_per_step)
    eager, comp = _trainer(g, **cfg), _trainer(g, **cfg)
    train, val = eager.split_tiles(fit)
    erng, gen_e = eager.epoch_streams(0)
    _, gen_c = comp.epoch_streams(0)
    w = eager.weights(0, 3)
    plans = eager._batch_plans(train, shuffle=True, rng=erng)[:3]
    for kind, ps in (("train", plans), ("eval", eager._batch_plans(val)[:3])):
        for p in ps:
            batch = eager._build_batch(p, cache=False)
            step = eager.train_step if kind == "train" else eager.eval_step
            want = step(batch.to("cpu"), gen_e, w)
            assert _compiled(comp, kind, batch, gen_c, w).tolist() == want
    _assert_same_params(_params(eager), _params(comp))
    for pe, pc in zip(eager.model.parameters(), comp.model.parameters()):
        for key, v in eager.optimizer.state[pe].items():
            torch.testing.assert_close(comp.optimizer.state[pc][key], v,
                                       atol=0, rtol=0)
    # the generators end in the same state: no draw was added or skipped
    assert torch.equal(gen_e.get_state(), gen_c.get_state())


@pytest.fixture(scope="module")
def eager_history(slide):
    """Two epochs of the fit loop written out with the eager public
    steps: history, per-step loss rows and final parameters."""
    g, fit, _ = slide
    tr = _trainer(g)
    train, val = tr.split_tiles(fit)
    history, rows = [], []
    for epoch in range(2):
        w = tr.weights(epoch, 2)
        erng, gen = tr.epoch_streams(epoch)
        ep = [tr.train_step(tr._build_batch(p, False).to("cpu"), gen, w)
              for p in tr._batch_plans(train, shuffle=True, rng=erng)]
        vl = [tr.eval_step(tr._build_batch(p, False).to("cpu"), gen, w)
              for p in tr._batch_plans(val)]
        rows += ep
        history.append({"epoch": epoch, **_means("train", ep),
                        **_means("val", vl)})
    return history, rows, _params(tr)


@pytest.mark.parametrize("scan_steps", [0, 1, 3, 5])
def test_scan_steps_give_the_eager_history(slide, eager_history, scan_steps):
    """A 7-step epoch read back 1, 3 or 5 steps at a time (3 and 5 leave
    a remainder) gives the history, step rows and parameters of the
    eager loop."""
    g, fit, _ = slide
    history, rows, params = eager_history
    tr = _trainer(g, scan_steps=scan_steps)
    assert tr.fit(fit, max_epochs=2) == history
    assert len(rows) == 14
    assert [rec for _, rec, _ in tr.step_log] == rows
    assert [ep for ep, _, _ in tr.step_log] == [0] * 7 + [1] * 7
    _assert_same_params(params, _params(tr))


def _edge_inputs(dtype, device="cpu"):
    gen = torch.Generator().manual_seed(3)
    n, k, heads, hc = 40, 6, 2, 16
    xl = torch.randn(n, hc, generator=gen).to(dtype)
    xr = torch.randn(n, hc, generator=gen).to(dtype)
    att = torch.randn(heads, hc // heads, generator=gen).to(dtype)
    mask = torch.rand(n, k, generator=gen) < 0.7
    idx = torch.where(mask, torch.randint(0, n, (n, k), generator=gen), 0)
    go = torch.randn(n, hc, generator=gen).to(dtype)
    return [t.to(device) for t in (xl, xr, att, idx.int(), mask, go)]


# a first word past 2^31, so the int32 bit pattern is negative
WORDS = (0xDEADBEEF, 12345)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edge_stage_seed_tensor_equals_ints(dtype):
    """The differentiable edge stage with its seed words in an int32
    tensor gives the output and the gradients of the same words as ints,
    on the plain path."""
    xl, xr, att, idx, mask, go = _edge_inputs(dtype)
    csr_t = transpose_csr(PaddedCSR(idx.numpy(), mask.numpy()),
                          n_src=xl.shape[0]).to("cpu")
    words = seed_tensor(WORDS, "cpu")
    assert words.dtype == torch.int32 and int(words[0]) < 0
    got = []
    for seed in (WORDS, words):
        leaves = [t.clone().requires_grad_() for t in (xl, xr, att)]
        out = gatv2_edge_stage(*leaves, idx, mask, 2, csr_t=csr_t,
                               seed=seed, rate=0.2)
        out.backward(go)
        got.append([out.detach()] + [t.grad for t in leaves])
    for a, b in zip(*got):
        assert torch.equal(a, b)
    # and the mask is not the no-dropout one
    plain = edge_stage_fwd(xl, xr, att, idx, mask, 2)[0]
    assert not torch.equal(plain, got[0][0])


def _step_bytes(tr, batch, kind):
    """The bytes one step's inputs take in: the batch's arrays, and for a
    loss step its seed words, uniforms and weights."""
    n = sum(a.nbytes for a in tile_arrays(batch))
    if kind == "predict":
        return n
    b, n_tx = batch.tx_valid.shape
    n_bd, e_sg = batch.bd_valid.shape[1], batch.sg_src.shape[1]
    seeds = tr.model.seed_launches(batch) * b if kind == "train" else 0
    return n + seeds * 8 + b * 4 * (n_tx + n_bd) * 4 + b * e_sg * 8 + 12


def test_transfer_counters(slide):
    """``bytes_to_device`` counts every step's inputs, ``bytes_to_host``
    every predict batch's (B, 5, n_tx) int32 output, as the JAX
    package's counters count its device puts and read-backs."""
    g, fit, pred = slide
    tr = _trainer(g)
    assert tr.bytes_to_device == tr.bytes_to_host == 0
    tr.fit(fit, max_epochs=1)
    train, val = tr.split_tiles(fit)
    want = sum(_step_bytes(tr, tr._build_batch(p, False), "train") for p in
               tr._batch_plans(train, shuffle=True,
                               rng=tr.epoch_streams(0)[0]))
    want += sum(_step_bytes(tr, tr._build_batch(p, False), "eval")
                for p in tr._batch_plans(val))
    assert tr.bytes_to_device == want and tr.bytes_to_host == 0
    plans = tr._batch_plans(pred, use_xlo=True)
    out = tr.predict(pred)
    assert out["row_index"].size == g.n_tx
    batches = [tr._build_batch(p, False) for p in plans]
    assert tr.bytes_to_device == want + sum(
        _step_bytes(tr, b, "predict") for b in batches)
    assert tr.bytes_to_host == sum(
        5 * 4 * b.tx_valid.size for b in batches)


def _resume_case(slide, device, tmp_path):
    g, fit, _ = slide
    tr = _trainer(g, device=device)
    train, _ = tr.split_tiles(fit)
    erng, gen = tr.epoch_streams(0)
    w = tr.weights(0, 2)
    batches = [tr._build_batch(p, False)
               for p in tr._batch_plans(train, shuffle=True, rng=erng)[:3]]
    for batch in batches[:2]:
        _compiled(tr, "train", batch, gen, w)
    path = save_checkpoint(tmp_path / "ck.npz", tr.model, tr.optimizer)
    state = gen.get_state()
    back = _trainer(g, device=device)
    params, _ = load_checkpoint(path, back.model, back.optimizer)
    back.load_params(params)
    for p in back.optimizer.param_groups[0]["params"]:
        step = back.optimizer.state[p]["step"]
        assert step.device == p.device and float(step) == 2.0
    gen_b = torch.Generator().manual_seed(0)
    gen_b.set_state(state)
    a = _compiled(tr, "train", batches[2], gen, w).tolist()
    b = _compiled(back, "train", batches[2], gen_b, w).tolist()
    return a, b, _params(tr), _params(back)


def test_resume_then_one_more_step(slide, tmp_path):
    """Two steps, a checkpoint, a fresh trainer resumed from it: the next
    step gives the same loss and parameters as the trainer that went on."""
    a, b, pa, pb = _resume_case(slide, "cpu", tmp_path)
    assert a == b
    _assert_same_params(pa, pb)


@pytest.mark.gpu
def test_resume_into_capturable_adam(slide, tmp_path, cuda):
    """The same on the card: the resumed step count lies on the
    parameters' device, where the captured Adam reads it."""
    a, b, pa, pb = _resume_case(slide, cuda, tmp_path)
    np.testing.assert_allclose(a, b, rtol=1e-5)
    for k, v in pa.items():
        torch.testing.assert_close(pb[k], v, atol=1e-5, rtol=1e-4, msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replays_with_new_seed_words_match_eager(cuda, dtype):
    """K2 and K3 captured once with their seed words in device memory:
    each replay, with new words written before it, equals eager calls
    with those words as ints, and the two replays' masks differ."""
    xl, xr, att, idx, mask, go = _edge_inputs(dtype, cuda)
    words = torch.zeros(2, dtype=torch.int32, device=cuda)

    def body():
        out, alpha = edge_stage_fwd(xl, xr, att, idx, mask, 2, seed=words,
                                    rate=0.2)
        dg, dxr, datt, _ = edge_stage_bwd(xl, xr, att, idx, mask, alpha, go,
                                          2, seed=words, rate=0.2)
        return out, dg, dxr, datt

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = body()
    replays = []
    for seed in (WORDS, (7, 0x9E3779B9)):
        words.copy_(seed_tensor(seed, cuda))
        graph.replay()
        got = [t.clone() for t in static]
        out, alpha = edge_stage_fwd(xl, xr, att, idx, mask, 2, seed=seed,
                                    rate=0.2)
        want = [out, *edge_stage_bwd(xl, xr, att, idx, mask, alpha, go, 2,
                                     seed=seed, rate=0.2)[:3]]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        replays.append(got)
    assert not torch.equal(replays[0][0], replays[1][0])
    assert not torch.equal(replays[0][1], replays[1][1])


@pytest.mark.gpu
def test_new_bucket_shape_captures_once(slide, cuda):
    """A compiled train step is captured at its first batch and replayed
    after; a batch of a new bucket shape captures exactly once more."""
    g, fit, _ = slide
    tr = _trainer(g, device=cuda)
    train, _ = tr.split_tiles(fit)
    erng, gen = tr.epoch_streams(0)
    w = tr.weights(0, 2)
    plans = tr._batch_plans(train, shuffle=True, rng=erng)
    wider = dataclasses.replace(plans[0][1], n_tx=plans[0][1].n_tx + 256)
    order = [plans[0], plans[1], (plans[2][0], wider), (plans[3][0], wider),
             plans[4]]
    caps = []
    for p in order:
        row = _compiled(tr, "train", tr._build_batch(p, False), gen, w)
        assert np.isfinite(row.tolist()).all()
        caps.append(tr.captures["train"])
    assert caps == [1, 1, 2, 2, 2]
    assert len(tr._steps) == 2


@pytest.mark.gpu
def test_rows_read_one_step_late_equal_one_read_at_the_pass_end(slide, cuda):
    """A 2-epoch fit on the card whose loss rows come back one step late
    gives the history and step rows, bit for bit, of the same fit with
    every pass's rows read once at its end (``scan_steps`` past the
    epoch's 7 steps): the same graphs replay in the same order on one
    stream.  Both read every row but each of the 4 passes' last after a
    later step was enqueued.  The parameters are not compared: two fits
    of the same code on the card already differ in their last bits."""
    g, fit, _ = slide
    runs = []
    for scan_steps in (0, 100):
        tr = _trainer(g, device=cuda, scan_steps=scan_steps)
        timer = StageTimer()
        prev = set_substage_timer(timer)
        try:
            history = tr.fit(fit, max_epochs=2)
        finally:
            set_substage_timer(prev)
        _, val = tr.split_tiles(fit)
        steps = len(tr.step_log) + 2 * len(tr._batch_plans(val))
        assert len(tr.step_log) == 14
        assert timer.calls["loss_row.lagged"] == steps - 4
        runs.append((history, [rec for _, rec, _ in tr.step_log]))
    assert runs[0] == runs[1]
