"""Run one cell of the benchmark of ``segger_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object; the last lines of standard error are the numbers
compared against the plain reference, each with its limit.  It exits
with 2, printing no result, when CUDA is absent or the cell asks for
more cards than are visible, and with 3 when JAX, flax, optax or the JAX
package was loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402

# one OpenMP / BLAS thread: the program's host work (the main thread and
# its prefetch thread) oversubscribes the card machine's 8 cores with
# PyTorch's and OpenBLAS's pools, which made runs of one seed spread by
# tens of percent; set before numpy and torch are imported
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness

    try:
        cell = harness.cell_spec(args.workload)
    except harness.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()}); no result",
              file=sys.stderr)
        return 2
    # seeds may exceed 32 bits; every draw takes them modulo its range
    result = harness.run_cell(cell, abs(args.seed), args.seconds,
                              bool(args.trace), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
