"""``correct`` comes out false for the control and for each fault the
cells can have, with the harness driven on the CPU at a tiny size (its
look for a chip skipped; the 4-card cell's mesh is four CPU shards): the
reference in float8 put in the program's place; a step that leaves the
state unchanged; half of the batch left out of the loss (half of each
tile's rows; on the 4-card cell also half of a step's tiles); the
exchange between the cards left out (4-card cell); a step's loss or a
transcript's cell altered where it is produced; a gene's similarity
threshold altered where the writer works it out.  A sound run of the
same size comes out correct; the reference's thresholds equal the
writer's bit for bit, and in float32 or with a planted wrong threshold
they do not."""
import time

import numpy as np
import pytest
import torch

import compare
import harness

SEED = 2**31 + 11


def run(tiny, workload, trace=False):
    cell = harness.cell_spec(workload, root=tiny, bench=tiny / "benchmark")
    return harness.run_cell(cell, SEED, 0.5, trace, time.perf_counter(),
                            device="cpu")


def control(tiny, workload):
    cell = harness.cell_spec(workload, root=tiny, bench=tiny / "benchmark")
    env = harness.Env(cell, SEED, "cpu")
    setup, window = harness.KINDS[cell["traffic"]["kind"]]
    setup(env)
    window(env, 0.0, max_units=1)
    readings = compare.CHECKS[cell["traffic"]["kind"]](env, control=True)
    return compare.judge(readings, cell["traffic"]["limits"]), readings


@pytest.mark.parametrize("workload", ["xenium5k-fit", "xenium5k-predict",
                                      "xenium5k-fit-4card"])
def test_a_sound_run_is_correct(tiny, workload):
    r = run(tiny, workload)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("workload", ["xenium5k-fit", "xenium5k-predict",
                                      "xenium5k-fit-4card"])
def test_the_float8_control_is_not_correct(tiny, workload):
    ok, readings = control(tiny, workload)
    assert not ok, readings


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from segger_tpu_torch.train import trainer

    stats = trainer.L.loss_stats

    def half(randoms, emb, tile, *a, **kw):
        rows = tile.tx_interior & tile.tx_valid
        keep = torch.cumsum(rows.long(), 0) <= rows.sum() // 2
        return stats(randoms, emb, tile.replace(tx_interior=rows & keep),
                     *a, **kw)
    monkeypatch.setattr(trainer.L, "loss_stats", half)


def _half_tiles(monkeypatch):
    """Half of a mesh step's tiles left out, the means taken over the
    rest: the later shards' statistics and gradients dropped."""
    from segger_tpu_torch.train import trainer

    run = trainer.SeggerTrainer._run

    def first_half(self, kind, step):
        out = run(self, kind, step)
        shard = next(k[2] for k, s in self._steps.items() if s is step)
        keep = kind != "train" or shard < self.mesh.size // 2
        return out if keep else torch.zeros_like(out)

    def first_half_grads(flat_grads, out):
        out.copy_(flat_grads[0])
        for g in flat_grads[1:len(flat_grads) // 2]:
            out.add_(g.to(out.device))
        return out
    monkeypatch.setattr(trainer.SeggerTrainer, "_run", first_half)
    monkeypatch.setattr(trainer, "reduce_gradients", first_half_grads)


def _exchange_left_out(monkeypatch):
    from segger_tpu_torch.train import trainer

    def first_shard_only(flat_grads, out):
        return out.copy_(flat_grads[0])
    monkeypatch.setattr(trainer, "reduce_gradients", first_shard_only)


def _loss_altered(monkeypatch):
    from segger_tpu_torch.train import trainer

    combine = trainer._combine

    def altered(tot, w):
        loss, parts = combine(tot, w)
        return loss * 1.5, parts
    monkeypatch.setattr(trainer, "_combine", altered)


def _cell_altered(monkeypatch):
    from segger_tpu_torch.train import trainer

    score = trainer.score_candidates

    def altered(emb_tx, emb_bd, cand, bd_index, **kw):
        sim, seg = score(emb_tx, emb_bd, cand, bd_index, **kw)
        # another cell of the slide, which is no candidate of the row
        top = int(bd_index.max()) + 1
        return sim, torch.where(seg >= 0, (seg + 1) % top, seg)
    monkeypatch.setattr(trainer, "score_candidates", altered)


def _threshold_altered(monkeypatch):
    from segger_tpu_torch.data import writer

    thresholds = writer.compute_gene_thresholds

    def altered(sim, gene, seed=0):
        thr, failed, median = thresholds(sim, gene, seed)
        first = min(thr)
        return {**thr, first: thr[first] + 1e-4}, failed, median
    monkeypatch.setattr(writer, "compute_gene_thresholds", altered)


@pytest.mark.parametrize("workload,fault", [
    ("xenium5k-fit", _unchanged),
    ("xenium5k-fit", _half_batch),
    ("xenium5k-fit", _loss_altered),
    ("xenium5k-fit-4card", _unchanged),
    ("xenium5k-fit-4card", _half_batch),
    ("xenium5k-fit-4card", _half_tiles),
    ("xenium5k-fit-4card", _exchange_left_out),
    ("xenium5k-fit-4card", _loss_altered),
    ("xenium5k-predict", _cell_altered),
    ("xenium5k-predict", _threshold_altered),
])
def test_a_fault_is_not_correct(tiny, workload, fault, monkeypatch):
    fault(monkeypatch)
    r = run(tiny, workload)
    assert not r["correct"], r["check"]


def test_the_traced_run_is_correct_and_reads_the_host_layers(tiny):
    r = run(tiny, "merscope500-predict", trace=True)
    assert r["correct"], r["check"]
    m = r["metrics"]
    assert m["extract_ms_per_tile.predict"]["value"] > 0
    assert m["write_ms_per_mtx.predict"]["value"] > 0
    assert "K1_roofline" not in m           # no device records on the CPU
    assert {"busy_s", "window_s"} <= set(r["device"])


def test_the_reference_thresholds_are_the_writers():
    from segger_tpu_torch.data.writer import compute_gene_thresholds

    ref = harness.load_module(harness.ROOT / "references" / "segger.py")
    rng = np.random.default_rng(SEED)
    n = 40_000
    gene = rng.integers(0, 60, n)
    sim = np.where(rng.random(n) < 0.5, rng.normal(0.5, 0.2, n),
                   rng.beta(2, 5, n)).astype(np.float32).astype(np.float64)
    want, failed, median = compute_gene_thresholds(sim, gene)
    got, got_median = ref.gene_thresholds(sim, gene)
    assert got == want and got_median == median and not failed
    for dtype, fault in ((np.float32, None), (np.float64, "yen"),
                         (np.float64, "sample"), (np.float64, "median")):
        wrong, _ = ref.gene_thresholds(sim, gene, dtype, fault)
        assert max(abs(wrong.get(g, median) - t) for g, t in want.items()
                   ) > 1e-9, (dtype, fault)
