#!/usr/bin/env python3
"""Device time of the edge-stage backward kernel (``edge_stage_bwd.cu``:
K3 and the keep-tensor mode of K4) at ``chip_smoke.py``'s phase-2 shapes,
for the kernels of this checkout or of another one, measured by this
checkout's ``chip_smoke.check_edge_stage_bwd`` (checked against the plain
version, then ``device_ms`` from torch.profiler and the event-timed
``ms``).  Needs one CUDA device.

    python3 tools/bwd_device_ms.py                  # this checkout
    python3 tools/bwd_device_ms.py --root OTHER     # OTHER's kernels

To compare two versions on one card, run both in one job, in turns:
parent, change, change, parent.  Prints the card's name and power limit,
then one JSON line per shape and mode.  The training-tile shapes (12,000 x
8, 800 x 12, 640 x 24 over 12,800 source rows) are random tables of the
tile's segment sizes, not the tile's own tables.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose segger_tpu_torch is measured")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bwd_device_ms: no CUDA device", file=sys.stderr)
        return 2
    import segger_tpu_torch
    print(smoke.gpu_line(), "|", segger_tpu_torch.__file__)
    rng = np.random.default_rng(smoke.SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    runs = [(smoke.N_BENCH, smoke.N_BENCH, k, dt, mode)
            for k, dts in ((8, (bf16,)), (12, (bf16, f32)), (24, (bf16,)))
            for dt in dts for mode in ("prng", "nokeep")]
    runs.append((smoke.N_BENCH, smoke.N_BENCH, 12, bf16, "keep"))
    runs += [(n, 12_800, k, bf16, "prng")
             for n, k in ((12_000, 8), (800, 12), (640, 24))]
    for n, n_src, k, dt, mode in runs:
        idx, mask = smoke.random_table(n, k, n_src, rng)
        r = smoke.check_edge_stage_bwd(idx, mask, n_src, dt, rng, mode=mode)
        print(json.dumps({"tag": args.tag, **{key: r[key] for key in (
            "mode", "n", "k", "dtype", "device_ms", "ms", "bound_ms",
            "max_abs_err")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
