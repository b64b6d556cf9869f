"""The port's profiling hooks (``segger_tpu_torch/utils_profiling.py``):
the stage timer as ``tests/test_train_extras.py`` checks the JAX
package's, the library substages a whole-slide driver installs a timer
for, their spans on the torch.profiler timeline, the counters, the
anonymous-RSS sampler, the device-memory read that never initializes
CUDA, and the torch.profiler trace."""
import json
import sys
import threading
import time

import numpy as np
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import torch

import pytest

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


@pytest.mark.parametrize("with_timer", [False, True])
def test_substage_is_a_profiler_span(with_timer):
    """Whenever a profiler records, a substage is a ``record_function``
    span of its name, with or without an installed timer."""
    from torch.profiler import ProfilerActivity, profile

    timer = up.StageTimer() if with_timer else None
    prev = up.set_substage_timer(timer)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with up.substage("span.x", items=2):
                torch.ones(4) + 1
    finally:
        up.set_substage_timer(prev)
    spans = [e for e in prof.events() if e.name == "span.x"]
    assert len(spans) == 1
    assert any(e.name == "aten::add" and spans[0].time_range.start
               <= e.time_range.start <= spans[0].time_range.end
               for e in prof.events())
    if with_timer:
        assert timer.calls["span.x"] == 1 and timer.items["span.x"] == 2


def test_substage_with_neither_timer_nor_profiler_does_nothing(
        monkeypatch):
    """No timer and no profiler: no span is opened and nothing is
    recorded, even into a timer installed afterwards."""
    import torch.autograd.profiler as autograd_profiler

    def refuse(name):
        raise AssertionError(f"a span {name!r} was opened")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    timer = up.StageTimer()
    prev = up.set_substage_timer(None)
    try:
        with up.substage("quiet"):
            pass
        up.count("quiet.count")
        up.set_substage_timer(timer)
        with up.substage("after"):
            pass
    finally:
        up.set_substage_timer(prev)
    assert dict(timer.calls) == {"after": 1}


def test_count_adds_calls_at_no_seconds():
    timer = up.StageTimer()
    prev = up.set_substage_timer(timer)
    try:
        up.count("hits")
        up.count("hits", 3)
        timer.count("misses")
    finally:
        up.set_substage_timer(prev)
    assert timer.calls == {"hits": 4, "misses": 1}
    assert timer.seconds == {"hits": 0.0, "misses": 0.0}
    assert timer.summary()["hits"]["calls"] == 4


def test_add_from_two_threads_loses_no_call():
    timer = up.StageTimer()

    def work():
        for _ in range(10_000):
            timer.add("shared", 1e-6)

    threads = [threading.Thread(target=work) for _ in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert timer.calls["shared"] == 20_000


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
