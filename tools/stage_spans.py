#!/usr/bin/env python3
"""Where a benchmark cell's host time goes, by the program's own spans
and counters (``utils_profiling.substage`` / ``count``), and what
recording them costs.

    python3 tools/stage_spans.py --workload xenium5k-fit --seed 7
    python3 tools/stage_spans.py --workload xenium5k-predict --seed 7 \
        --units 1 --rounds 1

Builds the cell as ``benchmark/run.py`` does (``benchmark/harness.py``:
the slide from the seed, the pipeline, the trainer, the set-up fit or
warm-up pass; one OpenMP / BLAS thread), then:

- ``--rounds`` rounds, each ``--units`` epochs or passes with no timer
  and ``--units`` with a ``StageTimer`` installed and no profiler (in
  turns: off then on, then on then off): the seconds of each unit, so
  the timer's cost shows beside the noise;
- the benchmark's traced window (``harness.traced_window``: the profiler
  on, the timer installed, the benchmark's labels) and the cell's
  per-layer metrics read from it.

Prints one JSON line: the card's name and power limit, the units'
seconds with and without the timer, the spans' seconds and calls per
unit with the timer alone and under the profiler, the share of the
units' seconds that the main thread's named spans cover (the rest is
unnamed host work), and the traced metrics.  ``--device cpu`` with
``--root`` at a checkout whose benchmark is cut small runs it on the
CPU.
"""
from __future__ import annotations

import os

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# the main thread's spans; ``stage.draws`` lies inside ``stage`` and
# ``write.thresholds`` inside ``write.assign``
MAIN = ("plan.tile_bucket", "prefetch.wait", "stage", "device.wait",
        "write.assign", "write.parquet")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def per_unit(stages: dict, units: int) -> dict:
    return {k: [round(s / units, 6), round(c / units, 3)]
            for k, (s, c) in sorted(stages.items())}


def covered(stages: dict, seconds: float) -> float:
    return sum(stages.get(k, (0.0, 0))[0] for k in MAIN) / seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "benchmark"))
    import harness

    t0 = time.perf_counter()
    cell = harness.cell_spec(args.workload, root=root,
                             bench=root / "benchmark")
    env = harness.Env(cell, args.seed, args.device)
    kind = env.traffic["kind"]
    setup, window = harness.KINDS[kind]
    sync = harness._sync_fn(env.device)
    setup(env)
    sync()
    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           "setup_s": time.perf_counter() - t0, "units": args.units}

    profiling = env.port["profiling"]
    off, on = [], []
    timer = profiling.StageTimer()
    for r in range(args.rounds):
        # off, on, then on, off: a drift across the run favours neither
        for timed in ((False, True) if r % 2 == 0 else (True, False)):
            prev = profiling.set_substage_timer(timer if timed else None)
            try:
                (on if timed else off).append(window(
                    env, 0.0, max_units=args.units, sync=sync)["each"])
            finally:
                profiling.set_substage_timer(prev)
    n_on = args.rounds * args.units
    on_s = sum(map(sum, on))
    stages = {k: (timer.seconds[k], timer.calls[k]) for k in timer.seconds}
    out.update(off=off, on=on, unit_s=on_s / n_on,
               spans=per_unit(stages, n_on), covered=covered(stages, on_s))

    view, breakdown = harness.traced_window(
        env, env.traffic["trace_units"], sync)
    out.update(
        traced_unit_s=view.window_s / view.units,
        traced_spans=per_unit(view.stages, view.units),
        traced_covered=covered(view.stages, view.window_s),
        traced_busy_s=view.busy_s, traced_window_s=view.window_s,
        metrics={m["name"]: m["reader"].read(view)
                 for m in cell["per_layer"]},
        idle_gaps=breakdown["idle_gaps"][:5])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
