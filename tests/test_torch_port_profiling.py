"""The port's profiling hooks (``segger_tpu_torch/utils_profiling.py``):
the stage timer as ``tests/test_train_extras.py`` checks the JAX
package's, the library substages a whole-slide driver installs a timer
for, the anonymous-RSS sampler, the device-memory read that never
initializes CUDA, and the torch.profiler trace."""
import json
import time

import numpy as np
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import torch

from segger_tpu.utils_profiling import StageTimer as JStageTimer

from segger_tpu_torch import utils_profiling as up
from segger_tpu_torch.data.synthetic import make_synthetic
from segger_tpu_torch.pipeline import ISTPipeline, PipelineConfig


def test_stage_timer():
    t = up.StageTimer()
    with t.stage("work", items=100):
        time.sleep(0.01)
    s = t.summary()
    assert s["work"]["calls"] == 1
    assert s["work"]["seconds"] >= 0.01
    assert s["work"]["rate"] > 0
    # the JAX package's summary keys and arithmetic
    j = JStageTimer()
    j.add("work", t.seconds["work"], 100)
    assert j.summary() == s and j.rates() == t.rates()


def test_substage_records_only_when_installed():
    with up.substage("nothing"):
        pass
    timer = up.StageTimer()
    prev = up.set_substage_timer(timer)
    try:
        with up.substage("a", items=3):
            pass
        with up.substage("a", items=2):
            pass
    finally:
        assert up.set_substage_timer(prev) is timer
    assert timer.calls["a"] == 2 and timer.items["a"] == 5
    assert "nothing" not in timer.seconds


def test_pipeline_reports_its_substages(tmp_path):
    """The graph build, the PhenoGraph chain, the cell PCA and the tile
    planning report into an installed timer."""
    synth = make_synthetic(n_cells=60, n_genes=20, mean_tx_per_cell=15,
                           seed=1)
    timer = up.StageTimer()
    prev = up.set_substage_timer(timer)
    try:
        ISTPipeline(synth.transcripts, synth.boundaries, synth.polygons,
                    PipelineConfig(cells_embedding_size=8, genes_min_counts=5,
                                   cells_min_counts=3)).load()
    finally:
        up.set_substage_timer(prev)
    assert {"graph.tx_knn", "graph.prediction", "phenograph.knn",
            "phenograph.jaccard", "phenograph.louvain",
            "features.pca_cells"} <= set(timer.seconds)
    assert timer.calls["phenograph.knn"] == 2      # cells, then genes


def test_anon_rss_sampler_sees_an_allocation():
    sampler = up.AnonRSSSampler(interval=0.01).start()
    base = up.AnonRSSSampler.read_gb()
    block = np.ones(64 * 2**20 // 8)          # 64 MiB, touched
    time.sleep(0.05)
    peak = sampler.stop()
    del block
    assert base > 0 and peak >= base + 0.04


def test_device_memory_stats_without_cuda():
    assert up.device_memory_stats() is None
    assert not torch.cuda.is_initialized()


def test_trace_writes_a_chrome_trace(tmp_path):
    with up.trace(tmp_path / "t"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])


def test_anon_rss_not_reported_is_none(monkeypatch):
    """Where the kernel reports VmRSS but no RssAnon, the anonymous peak
    is None (not measured), and the RSS peak is still sampled."""
    monkeypatch.setattr(up, "_status_gb",
                        lambda key: 1.5 if key == "VmRSS" else None)
    sampler = up.AnonRSSSampler(interval=0.01).start()
    assert sampler.stop() is None and sampler.peak_rss_gb == 1.5
