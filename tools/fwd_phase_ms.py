#!/usr/bin/env python3
"""Where the edge-stage forward kernel's time goes: the device time of
``csrc/edge_stage_fwd.cu`` whole and of copies cut down to some of its
phases, at ``chip_smoke.py``'s N = 50,000 shapes and a few tile segment
sizes, in bf16.  Needs one CUDA device.

    python3 tools/fwd_phase_ms.py

Each copy lives under ``build/fwd_phases/`` (``.gitignore`` lists
``build/``) and drops phases from the kernel's row loop by editing its
source:

- ``loads``: the idx, mask and xr loads, the slot compaction and the
  output store, with no staging and no passes;
- ``gathers``: ``loads`` and the staged gathers of the valid slots;
- ``no_softmax``: the whole kernel but the softmax;
- ``no_output``: the whole kernel but the output pass.

The copies' outputs are wrong by design and are not checked (the whole
kernel is held against its plain version by ``chip_smoke.py`` and the
``gpu`` tests).  Each version runs in a process of its own, in turns:
whole, the cuts, then the cuts and whole again.  Prints the card's name
and power limit, then one JSON line per version and shape.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SRC = "segger_tpu_torch/csrc/edge_stage_fwd.cu"
PASS_LOOP = "for (int q0 = 0; q0 < n_walk; q0 += slots) {"
# each edit: (pattern, replacement, which occurrence of the pattern)
STAGE = (re.escape(PASS_LOOP), PASS_LOOP.replace("n_walk", "0"), 0)
LOGITS = (r"qq < nc;", "qq < 0;", 0)
SOFTMAX = [(r"if \(heads_pow2\) \{", "if (false) {", 0),
           (r"h < heads; \+\+h\)(\s+softmax_row)", r"h < 0; ++h)\1", 0)]
OUTPUT = (re.escape(PASS_LOOP), PASS_LOOP.replace("n_walk", "0"), 1)
CUTS = {
    "loads": [OUTPUT, STAGE, LOGITS, *SOFTMAX],
    "gathers": [LOGITS, *SOFTMAX, OUTPUT],
    "no_softmax": SOFTMAX,
    "no_output": [OUTPUT],
}
SHAPES = [(50_000, 50_000, k, "nokeep") for k in (4, 8, 12, 24)] + [
    (50_000, 50_000, 12, "prng"), (12_000, 12_800, 8, "prng"),
    (5_040, 16_128, 4, "nokeep"), (800, 12_800, 12, "prng")]


def cut_copy(name: str, edits) -> Path:
    """A copy of the package whose forward kernel lacks the cut phases;
    raises if the kernel source no longer has a phase where it is
    sought."""
    root = HERE / "build" / "fwd_phases" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "segger_tpu_torch", root / "segger_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / SRC
    text = path.read_text()
    for pattern, repl, which in edits:
        found = list(re.finditer(pattern, text))
        if len(found) <= which:
            raise SystemExit(f"fwd_phase_ms: {pattern!r} not found in {SRC}")
        m = found[which]
        text = text[:m.start()] + m.expand(repl) + text[m.end():]
    path.write_text(text)
    return root


def time_versions(root: str, tag: str) -> None:
    """In this process: the device time of ``root``'s forward kernel at
    every shape."""
    sys.path.insert(0, root)
    sys.path.insert(1, str(HERE))
    import numpy as np
    import torch

    import chip_smoke as smoke
    from segger_tpu_torch.ops.postgather import edge_stage_fwd

    rng = np.random.default_rng(smoke.SEED)
    for n, n_src, k, mode in SHAPES:
        idx, mask = smoke.random_table(n, k, n_src, rng)
        xl, xr, att, _ = smoke._features(idx, n_src, torch.bfloat16, rng,
                                         2, 128)
        kw = smoke._dropout_args(mode, rng, n, k, 2, torch.bfloat16)
        ms = smoke.device_ms(
            lambda: edge_stage_fwd(xl, xr, att, idx, mask, 2, **kw), 20,
            "edge_stage_fwd_kernel")
        print(json.dumps({"version": tag, "n": n, "k": k, "mode": mode,
                          "device_ms": ms}), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "TAG"),
                    help="time one version in this process")
    ap.add_argument("--build", metavar="ROOT",
                    help="build one version's forward kernel")
    args = ap.parse_args(argv)
    if args.build:
        sys.path.insert(0, args.build)
        from segger_tpu_torch.ops import _build
        _build.build(["edge_stage_fwd"])
        return 0
    if args.time:
        time_versions(*args.time)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("fwd_phase_ms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke
    print(smoke.gpu_line(), flush=True)
    roots = {"whole": HERE, **{name: cut_copy(name, edits)
                               for name, edits in CUTS.items()}}
    me = [sys.executable, str(Path(__file__).resolve())]
    builds = [subprocess.Popen([*me, "--build", str(root)])
              for root in roots.values()]
    if any(p.wait() for p in builds):
        return 1
    order = list(roots)
    for name in order + order[::-1]:
        if subprocess.call([*me, "--time", str(roots[name]), name]):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
