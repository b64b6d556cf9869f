"""The trace's reduction on made-up events: the window, the union of the
device intervals with the spins left out, per card, the idle gaps named
by the host label that covers them, the kernel records split by the step
that launched them and held against the launch counters, and the copies
between cards."""
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

import harness
import tracing
from conftest import BENCH


def ev(name, start, end, device=False, card=0, corr=0):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=DeviceType.CUDA if device else DeviceType.CPU,
              is_user_annotation=False, device_index=card, id=corr)


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


def view(kernels, launches, steps, least=None, cards=1):
    return tracing.TraceView(
        kind="fit", units=2, window_s=1.0, busy_s=0.5,
        kernels=kernels, steps=steps, launches=launches,
        least_s=least or {"K1": 1e-6, "K2": 2e-6, "K3": 3e-6, "K5": 0.0},
        flops=1.0, cards=cards)


FWD = "edge_stage_fwd_kernel<x>"
# two epochs: 2 training steps (a K2 record of 10 us each), then 1 eval
# step (a K1 record of 4 us); (start, end, kind) of each step's label
STEPS = [(0, 5, "train"), (10, 15, "train"), (20, 25, "eval"),
         (30, 35, "train"), (40, 45, "train"), (50, 55, "eval")]


def test_forward_records_take_the_kind_of_their_step():
    # each record launched from inside its step's label, on card 0
    kernels = [(FWD, t + 1, 4 if kind == "eval" else 10, 0, t + 0.5)
               for t, _, kind in STEPS]
    kernels += [("edge_stage_bwd_kernel<x>", 60 + i, 20) for i in range(4)]
    v = view(kernels, {"K1": 2, "K2": 4, "K3": 4, "K5": 0}, STEPS)
    assert v.kernel_seconds("K2") == pytest.approx(40e-6)
    assert v.kernel_seconds("K1") == pytest.approx(8e-6)
    assert v.kernel_seconds("K3") == pytest.approx(80e-6)
    assert v.roofline("K2") == pytest.approx(100 * 2e-6 / 40e-6)
    assert v.roofline("K5") is None


def test_records_that_miss_launches():
    kernels = [(FWD, t + 1, 10, 0, t + 0.5) for t, _, kind in STEPS
               if kind == "train"]
    # 4 of 400 launches lost: the time is scaled up to the launches
    v = view(kernels * 99, {"K1": 0, "K2": 400, "K3": 0, "K5": 0}, STEPS)
    assert v.kernel_seconds("K2") == pytest.approx(396 * 10e-6 * 400 / 396)
    # more than 1 % lost: no roofline
    v = view(kernels, {"K1": 0, "K2": 5, "K3": 0, "K5": 0}, STEPS)
    assert v.kernel_seconds("K2") is None and v.roofline("K2") is None


def by_record_start(v, k):
    """The rule K1 and K2 were told apart by before: the kind of the step
    whose label last opened before the record started on the device."""
    starts = [s for s, _, _ in v.steps]
    return [r.dur for r in v.kernels if tracing.KERNELS["fwd"] in r.name
            and (v.steps[max(0, sum(s <= r.start for s in starts) - 1)][2]
                 == "train") == (k == "K2")]


def test_k2_follows_the_step_that_launched_it():
    """The host stages the next step while the card runs the last: the
    last training step's K2 records start on the card after the
    validation step's label has opened, and still are K2."""
    kernels = []
    for t, end, kind in STEPS:
        # the card runs a step late: a training step's 3 records from
        # 10 us after its label opened, when the next label has opened
        train = kind == "train"
        for i in range(3 if train else 2):
            kernels.append((FWD, t + (10 if train else 8) + i,
                            10 if train else 4, 0, t + 1))
    v = view(kernels, {"K1": 4, "K2": 12, "K3": 0, "K5": 0}, STEPS)
    assert v.kernel_seconds("K2") == pytest.approx(120e-6)
    assert v.kernel_seconds("K1") == pytest.approx(16e-6)
    # the old rule counts each epoch's last training step's records as
    # K1: they start after the eval label opened; half the K2 records
    # missing, the reader gave nothing
    assert len(by_record_start(v, "K2")) == 6
    assert len(by_record_start(v, "K1")) == 10
    # a record the trace does not link to a launch is counted in neither
    v = view(kernels + [(FWD, 60, 10)], {"K1": 4, "K2": 12, "K3": 0,
                                         "K5": 0}, STEPS)
    assert v.kernel_seconds("K2") == pytest.approx(120e-6)
    assert v.kernel_seconds("K1") == pytest.approx(16e-6)


def test_reduce_links_records_to_their_launch():
    """A device record shares the correlation id of the runtime call
    that enqueued it (a graph replay's ``cudaGraphLaunch``)."""
    events = [
        ev(tracing.WINDOW, 0, 100),
        ev(tracing.STEP + "train", 10, 20),
        ev("cudaGraphLaunch", 12, 13, corr=7),
        ev(tracing.STEP + "eval", 21, 30),
        ev("cudaLaunchKernel", 22, 23, corr=8),
        ev(FWD, 25, 35, device=True, corr=7),      # past the eval label
        ev(FWD, 40, 45, device=True, corr=8),
        ev("aten::add", 50, 51, corr=9),           # no launch of it
        ev(FWD, 60, 65, device=True, corr=9),
    ]
    r = tracing.reduce(events)
    assert [(k.start, k.launch) for k in r["kernels"]] == [
        (25, 12), (40, 22), (60, None)]
    assert r["steps"] == [(10, 20, "train"), (21, 30, "eval")]
    v = view(r["kernels"], {"K1": 1, "K2": 1, "K3": 0, "K5": 0},
             r["steps"])
    assert v.kernel_seconds("K2") == pytest.approx(10e-6)
    assert v.kernel_seconds("K1") == pytest.approx(5e-6)


def test_predict_forwards_are_k1_unlinked():
    """With no training step, every forward record is K1."""
    steps = [(0, 5, "predict"), (10, 15, "predict")]
    v = tracing.TraceView(
        kind="predict", units=1, window_s=1.0, busy_s=0.5,
        kernels=[(FWD, 1, 4), (FWD, 11, 4)], steps=steps,
        launches={"K1": 2, "K2": 0, "K3": 0, "K5": 0},
        least_s={"K1": 1e-6}, flops=1.0)
    assert v.kernel_seconds("K1") == pytest.approx(8e-6)
    assert v.kernel_seconds("K2") is None


def test_busy_is_each_cards_union_averaged_over_the_cards():
    events = [
        ev(tracing.WINDOW, 0, 100),
        ev("k", 10, 30, device=True, card=0),
        ev("k", 20, 40, device=True, card=0),      # 10-40 on card 0
        ev("k", 10, 30, device=True, card=1),      # 10-30 on card 1
        ev("Memcpy PtoP (Device -> Device)", 50, 60, device=True, card=1),
        ev("bench.stage", 0, 100),
    ]
    # one card: every record is that card's, as the union always was
    one = tracing.reduce(events)
    assert one["busy_s"] == pytest.approx(40e-6)          # 10-40, 50-60
    assert all(", card" not in g[0] for g in one["breakdown"]["idle_gaps"])
    # four cards, two of them idle: the mean of 30, 30, 0 and 0 us
    four = tracing.reduce(events, cards=4)
    assert four["busy_by_card"] == pytest.approx(
        {0: 30e-6, 1: 30e-6, 2: 0.0, 3: 0.0})
    assert four["busy_s"] == pytest.approx(15e-6)
    gaps = four["breakdown"]["idle_gaps"]
    assert gaps[0][0] in ("bench.stage, card 2", "bench.stage, card 3")
    assert gaps[0][1] == pytest.approx(100e-6)
    v = view(four["kernels"], {"K1": 0, "K2": 0, "K3": 0, "K5": 0}, [],
             cards=4)
    assert v.peer_copy_seconds() == pytest.approx(10e-6)


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read


def test_the_device_readers_count_the_cells_cards():
    """``fit_mfu`` and ``predict_mfu`` take the peak of the cell's cards,
    the idle share the cards' mean busy time; the copies between cards
    per step read only on several cards."""
    from counts import BF16_FLOPS_PER_S

    def v(kind, cards, kernels=()):
        return tracing.TraceView(
            kind=kind, units=1, window_s=2.0, busy_s=0.5,
            kernels=list(kernels), steps=[], launches={}, least_s={},
            flops=1e12, stages={"stage": (0.1, 10)}, cards=cards)

    for kind in ("fit", "predict"):
        mfu = reader(f"{kind}_mfu")
        assert mfu(v(kind, 1)) == 100.0 * 1e12 / (2.0 * BF16_FLOPS_PER_S)
        assert mfu(v(kind, 4)) == pytest.approx(mfu(v(kind, 1)) / 4)
        assert reader(f"device_idle_share.{kind}")(v(kind, 4)) == 75.0
    peer = reader("peer_copy_ms_per_step.fit")
    copy = [("Memcpy PtoP (Device -> Device)", 0, 500, 1),
            ("Memcpy DtoD (Device -> Device)", 0, 700, 0)]
    assert peer(v("fit", 4, copy)) == pytest.approx(0.05)   # 0.5 ms / 10
    assert peer(v("fit", 1, copy)) is None
    assert peer(v("fit", 4)) is None
