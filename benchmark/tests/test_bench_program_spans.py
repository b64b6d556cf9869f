"""The readers of the program's own spans and counters, on made-up
stage totals: per step (over the calls of ``stage``), the tile cache's
hit share, the writer's parts per million transcripts written (the
table's self time less its thresholds), nothing for the other traffic
kind, and nothing where the program has no such span."""
import pytest

import harness
import tracing
from conftest import BENCH

# seconds and calls of each span and counter over 40 steps
FIT = {"stage": (0.8, 40), "stage.draws": (0.4, 40),
       "prefetch.wait": (0.2, 46), "device.wait": (0.6, 80),
       "tile_cache.hit": (0.0, 30), "tile_cache.miss": (0.0, 10),
       "plan.tile_bucket": (0.3, 3)}
PREDICT = {"stage": (0.4, 20), "prefetch.wait": (1.0, 21),
           "device.wait": (0.1, 40), "extract.tile": (1.1, 20),
           "write.assign": (3.0, 1), "write.thresholds": (2.0, 1),
           "write.parquet": (0.5, 1), "tile_cache.miss": (0.0, 20)}
ROWS = 2_000_000

WANT = {
    "prefetch_wait_ms_per_step.fit": 5.0,
    "stage_ms_per_step.fit": 20.0,
    "draws_ms_per_step.fit": 10.0,
    "device_wait_ms_per_step.fit": 15.0,
    "tile_cache_hit_share.fit": 75.0,
    "prefetch_wait_ms_per_step.predict": 50.0,
    "stage_ms_per_step.predict": 20.0,
    "device_wait_ms_per_step.predict": 5.0,
    "write_assign_ms_per_mtx.predict": 500.0,
    "write_thresholds_ms_per_mtx.predict": 1000.0,
    "write_parquet_ms_per_mtx.predict": 250.0,
}


def view(kind, stages):
    return tracing.TraceView(
        kind=kind, units=2, window_s=1.0, busy_s=0.5, kernels=[], steps=[],
        launches={}, least_s={}, flops=0.0, stages=stages,
        rows_written=ROWS if kind == "predict" else 0)


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_its_number(name):
    kind = name.rsplit(".", 1)[1]
    other = "fit" if kind == "predict" else "predict"
    r = reader(name)
    stages = FIT if kind == "fit" else PREDICT
    assert r.read(view(kind, stages)) == pytest.approx(WANT[name])
    # the other traffic kind, and a program without these spans (the
    # parent's: only the planning and extraction spans)
    assert r.read(view(other, FIT if other == "fit" else PREDICT)) is None
    old = {k: v for k, v in stages.items()
           if k in ("plan.tile_bucket", "extract.tile")}
    assert r.read(view(kind, old)) is None


def test_every_new_reader_is_in_the_benchmark():
    spec = harness.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in WANT:
        kind = name.rsplit(".", 1)[1]
        m = entries[name]
        assert m["moves"] == f"{kind}_tx_per_s"
        assert m["workloads"] == [f"xenium5k-{kind}", f"merscope500-{kind}"]
        assert m["source"] == ("program_counter" if "share" in name
                               else "program_span")
