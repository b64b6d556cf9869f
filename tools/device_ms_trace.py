#!/usr/bin/env python3
"""How many kernel records a torch.profiler trace keeps, counted four
ways, for the edge-stage forward kernel (K1) on the tile-layer tables of
``chip_smoke.py``'s phase 2 (the first predict tile of the 200,000-
transcript slide at ``TrainConfig()`` width, bf16).  Needs one CUDA
device.

    python3 tools/device_ms_trace.py                    # 10 rounds
    python3 tools/device_ms_trace.py --rounds 8 --gap-s 20   # idling
    python3 tools/device_ms_trace.py --root OTHER       # OTHER's kernels

Each round takes ``--traces`` traces in a row of ``--reps`` launches of
one tile segment's K1 (the segments in turn, round by round) in each of
these ways, then idles ``--gap-s`` seconds:

- ``cpu+cuda``: CPU and CUDA activities, nothing before the launches
  (``chip_smoke.device_ms``'s trace before it took a spin lead);
- ``cuda``: CUDA activity only;
- ``idle-1s``: one second of idle host time in the window before the
  launches (3 traces);
- ``gpu-sleep``: one ``torch.cuda._sleep`` spin kernel of about 2 ms
  before them;
- ``lead-fill``: 50 one-element fill kernels before them;
- ``lead-same``: ``--reps`` launches of the same call before them;
- ``device_ms``: ``chip_smoke.kernel_trace``, a lead of
  ``chip_smoke.TRACE_LEAD`` spin kernels (absent from a checkout without
  it).

For every trace it counts the wrapper's own launches
(``edge_stage_fwd.launches``), the kernel's records in Kineto's raw
results, in ``prof.events()``, in ``prof.key_averages()`` and in the
exported Chrome trace, and, through each record's CUPTI correlation id,
which runtime launch records (by position, leads included) have no
kernel record of K1, and how many of the timed launches (the last
``--reps``) do.  Then, once, ``chip_smoke.graph_ms`` beside
``device_ms`` on each segment.  Prints the card's name and power limit,
one JSON line per round and way, and a summary line: how many traces of
each way held all their timed launches.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KERNEL = "edge_stage_fwd_kernel"
SLEEP_CYCLES = 4_000_000          # the gpu-sleep way's spin, about 2 ms


def one_trace(fn, reps, activities, lead, counter, path):
    """One trace of ``lead()`` and then ``reps`` calls of ``fn``; the
    counts of every view of the calls' kernel records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        lead()
        before = counter()
        for _ in range(reps):
            fn()
        launched = counter() - before
        torch.cuda.synchronize()
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and KERNEL in e.name()]
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and KERNEL in e.name]
    averaged = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation and KERNEL in e.key)
    prof.export_chrome_trace(str(path))
    trace = json.loads(Path(path).read_text())["traceEvents"]
    kern = {e["args"].get("correlation"): e for e in trace
            if e.get("cat") == "kernel" and KERNEL in e.get("name", "")}
    runtime = sorted((e for e in trace if e.get("cat") == "cuda_runtime"
                      and "aunch" in e.get("name", "")),
                     key=lambda e: e["ts"])
    # the calls' launches are the last ``reps`` runtime launch records
    lost = [i for i, e in enumerate(runtime)
            if e["args"].get("correlation") not in kern]
    timed = sum(e["args"].get("correlation") in kern
                for e in runtime[-reps:])
    return {"launched": launched, "raw": len(raw), "events": len(events),
            "key_averages": averaged, "chrome": len(kern),
            "timed_held": timed,
            "runtime_launches": len(runtime), "lost_positions": lost}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose segger_tpu_torch is measured")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--traces", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--gap-s", type=float, default=0.0,
                    help="idle seconds between rounds")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("device_ms_trace: no CUDA device", file=sys.stderr)
        return 2
    from segger_tpu_torch.data.partition import build_tiling, make_predict_tiles
    from segger_tpu_torch.ops.postgather import edge_stage_fwd
    from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

    print(smoke.gpu_line(), "| torch", torch.__version__, "cuda",
          torch.version.cuda)
    t_start = time.perf_counter()
    graph = smoke.synthetic_slide()
    specs = make_predict_tiles(graph, build_tiling(graph,
                                                   nodes_per_tile=50_000),
                               margin=20.0)
    cfg = TrainConfig()
    trainer = SeggerTrainer(graph, cfg)
    tile = smoke.first_tile(trainer, trainer._batch_plans(
        specs, use_xlo=True)[0])
    rng = np.random.default_rng(smoke.SEED)
    heads, hc = cfg.n_heads, cfg.n_heads * cfg.hidden_channels
    calls = []
    for name, i, m in smoke.tile_tables(tile):
        xl, xr, att, _ = smoke._features(i, tile.n_tx, torch.bfloat16, rng,
                                         heads, hc)
        calls.append((f"{name} {i.shape[0]}x{i.shape[1]}",
                      lambda xl=xl, xr=xr, att=att, i=i, m=m:
                      edge_stage_fwd(xl, xr, att, i, m, heads)))
    for _, fn in calls:
        fn()
    torch.cuda.synchronize()

    def counter():
        return edge_stage_fwd.launches["nokeep"]

    cpu_cuda = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    buf = torch.zeros(1, device="cuda")
    ways = {   # activities, what runs in the window before the calls, traces
        "cpu+cuda": (cpu_cuda, lambda: None, args.traces),
        "cuda": ([ProfilerActivity.CUDA], lambda: None, args.traces),
        "idle-1s": (cpu_cuda, lambda: time.sleep(1.0), 3),
        "gpu-sleep": (cpu_cuda, lambda: torch.cuda._sleep(SLEEP_CYCLES),
                      args.traces),
        "lead-fill": (cpu_cuda, lambda: [buf.zero_() for _ in range(50)],
                      args.traces),
        "lead-same": (cpu_cuda, lambda: [fn() for _ in range(args.reps)],
                      args.traces),
    }
    held = {w: 0 for w in (*ways, "device_ms")}
    taken = dict.fromkeys(held, 0)
    kernel_trace = getattr(smoke, "kernel_trace", None)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        for r in range(args.rounds):
            name, fn = calls[r % len(calls)]
            for way, (acts, lead, n_traces) in ways.items():
                recs = [one_trace(fn, args.reps, acts, lead, counter, path)
                        for _ in range(n_traces)]
                full = sum(x["timed_held"] == args.reps for x in recs)
                held[way] += full
                taken[way] += len(recs)
                print(json.dumps({
                    "round": r, "segment": name, "way": way,
                    "s_since_start": round(time.perf_counter() - t_start, 1),
                    "held_all": full, "traces": len(recs),
                    **{key: [x[key] for x in recs] for key in (
                        "launched", "raw", "events", "key_averages",
                        "chrome", "timed_held", "runtime_launches")},
                    "lost_positions": [x["lost_positions"] for x in recs
                                       if x["lost_positions"]][:3]}))
            if kernel_trace is not None:
                recs = [kernel_trace(fn, args.reps, KERNEL)
                        for _ in range(args.traces)]
                held["device_ms"] += sum(c == args.reps for c, _, _ in recs)
                taken["device_ms"] += len(recs)
                print(json.dumps({
                    "round": r, "segment": name, "way": "device_ms",
                    "s_since_start": round(time.perf_counter() - t_start, 1),
                    "key_averages": [c for c, _, _ in recs],
                    "spins_held": [sp for _, _, sp in recs]}))
            if args.gap_s:
                time.sleep(args.gap_s)
    graph_ms = getattr(smoke, "graph_ms", None)
    for name, fn in calls:
        print(json.dumps({
            "segment": name,
            "device_ms": smoke.device_ms(fn, args.reps, KERNEL),
            "graph_ms": graph_ms and graph_ms(fn, args.reps),
            "cuda_ms": smoke.cuda_ms(fn, 50)}))
    print(json.dumps({"held_all": held, "traces": taken,
                      "reps": args.reps, "pid": os.getpid()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
