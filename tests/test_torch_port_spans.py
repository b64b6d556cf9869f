"""The spans and counters of the port's step loop and writer, as an
installed ``StageTimer`` records them over a tiny CPU fit of two epochs,
a predict and the table's writes: one ``stage`` a step, ``stage.draws``
a loss step, ``prefetch.wait`` each batch waited for, ``device.wait``
each loss-row read-back (the only wait on the device the CPU has),
``loss_row.lagged`` each row read after a later step, the tile cache's
hits and misses, and the writer's three parts once a
write."""
import numpy as np
import pytest

from chip_smoke import synthetic_slide
from segger_tpu_torch.data.partition import (
    build_tiling, make_fit_tiles, make_predict_tiles,
)
from segger_tpu_torch.data.writer import SegmentationWriter
from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig
from segger_tpu_torch.utils_profiling import StageTimer, set_substage_timer

# 16 fit tiles: 7 train, 9 val
MODEL = dict(hidden_channels=16, out_channels=16, n_mid_layers=0,
             n_heads=2, training_fraction=0.45)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    g = synthetic_slide(n_tx=6000, n_cells=300, n_genes=30, f_gene=8,
                        f_bd=8, seed=1)
    tree = build_tiling(g, nodes_per_tile=600)
    fit = make_fit_tiles(g, tree, margin=8.0)
    pred = make_predict_tiles(g, tree, margin=8.0)
    tr = SeggerTrainer(g, TrainConfig(**MODEL), device="cpu")
    tr.init()
    out = tmp_path_factory.mktemp("spans")
    timer = StageTimer()
    snaps = []
    prev = set_substage_timer(timer)
    try:
        tr.fit(fit, max_epochs=2,
               on_epoch_end=lambda e, t: snaps.append(dict(timer.calls)))
        preds = tr.predict(pred)
        snaps.append(dict(timer.calls))
        writer = SegmentationWriter(out, save_anndata=False)
        writer.write(preds, cell_ids=g.bd_cell_id,
                     gene_names=np.array([f"g{i}" for i in range(30)]))
        snaps.append(dict(timer.calls))
        enc = np.full(g.n_tx, -2, np.int64)
        enc[preds["row_index"]] = preds["cell_encoding"]
        sim = np.zeros(g.n_tx, np.float32)
        sim[preds["row_index"]] = preds["similarity"]
        writer.write_dense(sim, enc, g.tx_gene, g.bd_cell_id)
    finally:
        set_substage_timer(prev)
    train, val = tr.split_tiles(fit)
    return dict(trainer=tr, timer=timer, snaps=snaps, fit=fit, pred=pred,
                train=train, val=val)


def _delta(after, before, name):
    return after.get(name, 0) - before.get(name, 0)


def test_stage_once_a_step_and_draws_once_a_loss_step(run):
    tr, snaps = run["trainer"], run["snaps"]
    train_steps = len(tr.step_log)
    eval_steps = 2 * len(tr._batch_plans(run["val"]))
    predict_steps = len(tr._batch_plans(run["pred"], use_xlo=True))
    fitted, predicted = snaps[1], snaps[2]
    assert train_steps and eval_steps and predict_steps
    assert fitted["stage"] == train_steps + eval_steps
    assert fitted["stage.draws"] == train_steps + eval_steps
    assert _delta(predicted, fitted, "stage") == predict_steps
    assert _delta(predicted, fitted, "stage.draws") == 0
    # the CPU's one wait on the device: each loss row read back
    assert fitted["device.wait"] == train_steps + eval_steps
    # every row read one step late but the last of each of the 4 passes
    assert fitted["loss_row.lagged"] == train_steps + eval_steps - 4
    # each batch waited for, and the end of each pass
    assert fitted["prefetch.wait"] == train_steps + eval_steps + 4
    assert _delta(predicted, fitted, "prefetch.wait") == predict_steps + 1


def test_tile_cache_counts_every_extraction_through_it(run):
    first, fitted, predicted = run["snaps"][:3]
    # the first epoch fills the cache; the second reads it
    assert first.get("tile_cache.hit", 0) == 0
    assert first["tile_cache.miss"] == len(run["fit"])
    assert _delta(fitted, first, "tile_cache.hit") > 0
    assert (_delta(fitted, first, "tile_cache.hit")
            + _delta(fitted, first, "tile_cache.miss")) == len(run["fit"])
    # predict drops the cache: every tile extracted anew
    assert _delta(predicted, fitted, "tile_cache.hit") == 0
    assert _delta(predicted, fitted, "tile_cache.miss") == len(run["pred"])


def test_the_writer_reports_its_three_parts_once_a_write(run):
    predicted, written = run["snaps"][2:4]
    timer = run["timer"]
    for name in ("write.assign", "write.thresholds", "write.parquet"):
        assert name not in predicted
        assert written[name] == 1 and timer.calls[name] == 2
    # the thresholds are a part of the table's assignment
    assert 0 < timer.seconds["write.thresholds"] < timer.seconds[
        "write.assign"]
