"""The reader of the program's counter ``loss_row.lagged``: the share of
the traced fit steps whose loss row was read one step late, over the
calls of ``stage``; nothing for predict traffic, and nothing where the
program has no such counter."""
import pytest

import harness
import tracing
from conftest import BENCH

NAME = "readback_lag_share.fit"


def view(kind, stages):
    return tracing.TraceView(
        kind=kind, units=2, window_s=1.0, busy_s=0.5, kernels=[], steps=[],
        launches={}, least_s={}, flops=0.0, stages=stages)


@pytest.mark.parametrize("kind,stages,want", [
    # 3 passes of 40, 40 and 20 steps: every row but each pass's last
    ("fit", {"stage": (0.8, 100), "loss_row.lagged": (0.0, 97)}, 97.0),
    ("fit", {"stage": (0.8, 100), "device.wait": (0.6, 100)}, None),
    ("fit", {"loss_row.lagged": (0.0, 3)}, None),
    ("predict", {"stage": (0.4, 20), "loss_row.lagged": (0.0, 19)}, None),
])
def test_reader_gives_the_lagged_share(kind, stages, want):
    r = harness.load_module(BENCH / "metrics" / f"{NAME}.py")
    got = r.read(view(kind, stages))
    assert got == (pytest.approx(want) if want is not None else None)


def test_the_reader_is_in_the_benchmark():
    m = {m["name"]: m for m in harness.load_spec()["per_layer"]}[NAME]
    assert m["moves"] == "fit_tx_per_s" and m["unit"] == "%"
    assert m["source"] == "program_counter"
    assert m["layer"] == "compiled step and encoder"
    assert m["workloads"] == ["xenium5k-fit", "merscope500-fit"]
