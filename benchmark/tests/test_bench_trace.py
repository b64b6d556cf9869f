"""The trace's reduction on made-up events: the window, the union of the
device intervals with the spins left out, the idle gaps named by the host
label that covers them, and the kernel records split and held against
the launch counters."""
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

import tracing


def ev(name, start, end, device=False):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=DeviceType.CUDA if device else DeviceType.CPU,
              is_user_annotation=False)


def test_reduce_unions_intervals_and_names_gaps():
    events = [
        ev(tracing.WINDOW, 100, 200),
        ev("spin_kernel", 0, 50, device=True),
        ev("edge_stage_fwd_kernel<a>", 110, 130, device=True),
        ev("edge_stage_fwd_kernel<a>", 120, 140, device=True),   # overlaps
        ev("Memcpy HtoD", 170, 180, device=True),
        ev("bench.extract", 90, 200),
        ev("bench.stage", 141, 160),
    ]
    r = tracing.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)          # 110-140, 170-180
    assert r["spins"] == 1
    gaps = r["breakdown"]["idle_gaps"]
    # 140-170 (30 us): the main thread's stage label overlaps it, which
    # names it over the prefetch thread's extract; 180-200 and 100-110:
    # only extract covers them, which the main thread waited for
    assert gaps[0] == ["bench.stage", pytest.approx(30e-6)]
    assert [g[0] for g in gaps[1:]] == ["bench.extract", "bench.extract"]
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["edge_stage_fwd_kernel<a>"] == pytest.approx(40e-6)


def view(kernels, launches, steps, least=None):
    return tracing.TraceView(
        kind="fit", units=2, window_s=1.0, busy_s=0.5,
        kernels=kernels, steps=steps, launches=launches,
        least_s=least or {"K1": 1e-6, "K2": 2e-6, "K3": 3e-6, "K5": 0.0},
        flops=1.0)


FWD = "edge_stage_fwd_kernel<x>"
# two epochs: 2 training steps (a K2 record of 10 us each), then 1 eval
# step (a K1 record of 4 us)
STEPS = [(0, "train"), (10, "train"), (20, "eval"),
         (30, "train"), (40, "train"), (50, "eval")]


def test_forward_records_take_the_kind_of_their_step():
    kernels = [(FWD, t + 1, 4 if kind == "eval" else 10)
               for t, kind in STEPS]
    kernels += [("edge_stage_bwd_kernel<x>", 60 + i, 20) for i in range(4)]
    v = view(kernels, {"K1": 2, "K2": 4, "K3": 4, "K5": 0}, STEPS)
    assert v.kernel_seconds("K2") == pytest.approx(40e-6)
    assert v.kernel_seconds("K1") == pytest.approx(8e-6)
    assert v.kernel_seconds("K3") == pytest.approx(80e-6)
    assert v.roofline("K2") == pytest.approx(100 * 2e-6 / 40e-6)
    assert v.roofline("K5") is None


def test_records_that_miss_launches():
    kernels = [(FWD, t + 1, 10) for t, kind in STEPS if kind == "train"]
    # 4 of 400 launches lost: the time is scaled up to the launches
    v = view(kernels * 99, {"K1": 0, "K2": 400, "K3": 0, "K5": 0}, STEPS)
    assert v.kernel_seconds("K2") == pytest.approx(396 * 10e-6 * 400 / 396)
    # more than 1 % lost: no roofline
    v = view(kernels, {"K1": 0, "K2": 5, "K3": 0, "K5": 0}, STEPS)
    assert v.kernel_seconds("K2") is None and v.roofline("K2") is None
