#!/usr/bin/env python3
"""Device time of the edge-stage, attention and scoring kernels at
``chip_smoke.py``'s phase-2 shapes, for the kernels of this checkout or of
another one, measured by this checkout's ``chip_smoke`` checks (each
checked against its plain version, then ``device_ms`` from torch.profiler
and the event-timed ``ms``, with ``graph_ms``).  Needs one CUDA device.

    python3 tools/bwd_device_ms.py                  # the backward, here
    python3 tools/bwd_device_ms.py --root OTHER     # OTHER's kernels
    python3 tools/bwd_device_ms.py --kernel fwd     # the forward
    python3 tools/bwd_device_ms.py --kernel fwd --max-blocks 8192
    python3 tools/bwd_device_ms.py --kernel attn    # K6 and K7
    python3 tools/bwd_device_ms.py --kernel score   # K5

``--kernel bwd`` (the default) times ``edge_stage_bwd.cu`` (K3 and the
keep-tensor mode of K4); ``--kernel fwd`` times ``edge_stage_fwd.cu``
(K1 no dropout, K2 hashed dropout, K4's keep-tensor forward);
``--kernel attn`` times ``attn_fwd.cu``: K6 at phase 2c's shapes (N =
50,000, K 4/8/12/24, bf16 and f32), then K6 on the synthetic slide's
strip-major tt table and K7 on its banded form (f32, random features);
``--kernel score`` times ``score.cu`` (K5) at F = 64 (``out_channels``):
N = 50,000 over 2,500 candidate rows at K 4 / 8 / 24 in bf16 and K = 4 in
f32, then a random table of the predict tile's candidate size (16,128 x 4
over 832 rows), each with the library call's ``library_device_ms``.
To compare two versions on one card, run both in one job, in turns:
parent, change, change, parent.  Prints the card's name and power limit,
then one JSON line per shape and mode.  The tile shapes are random tables
of the segment sizes of the first training tile (12,000 x 8, 800 x 12,
640 x 24 over 12,800 source rows) and, for the forward, of the first
predict tile (5,040 x 4, 8,064 x 8, 3,024 x 12, 832 x 24 over 16,128),
not the tiles' own tables.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TRAIN_TILE = (12_800, ((12_000, 8), (800, 12), (640, 24)))
PREDICT_TILE = (16_128, ((5_040, 4), (8_064, 8), (3_024, 12), (832, 24)))
# (n, k, n_bd, dtype name) of the K5 timings: phase 2's N = 50,000 table
# over 2,500 cells, then the predict tile's candidate table
SCORE_RUNS = ((50_000, 4, 2_500, "bfloat16"), (50_000, 8, 2_500, "bfloat16"),
              (50_000, 24, 2_500, "bfloat16"), (50_000, 4, 2_500, "float32"),
              (16_128, 4, 832, "bfloat16"))


def runs_of(kernel, n_bench, bf16, f32):
    """(n, n_src, k, dtype, mode) of every measurement of ``kernel``."""
    if kernel == "bwd":
        runs = [(n_bench, n_bench, k, dt, mode)
                for k, dts in ((8, (bf16,)), (12, (bf16, f32)), (24, (bf16,)))
                for dt in dts for mode in ("prng", "nokeep")]
        runs.append((n_bench, n_bench, 12, bf16, "keep"))
        n_src, segs = TRAIN_TILE
        return runs + [(n, n_src, k, bf16, "prng") for n, k in segs]
    runs = [(n_bench, n_bench, k, dt, mode)
            for k, dts in ((4, (bf16,)), (8, (bf16,)), (12, (bf16, f32)),
                           (24, (bf16,)))
            for dt in dts for mode in ("nokeep", "prng")]
    runs.append((n_bench, n_bench, 12, bf16, "keep"))
    n_src, segs = PREDICT_TILE
    runs += [(n, n_src, k, bf16, "nokeep") for n, k in segs]
    n_src, segs = TRAIN_TILE
    return runs + [(n, n_src, k, bf16, "prng") for n, k in segs]


def attn_records(smoke, rng, heads=2, hc=128):
    """(kernel, where, record) of K6 at phase 2c's shapes, then of K6 and
    K7 on the slide-wide strip-major table, random features."""
    import torch

    for k in (4, 8, 12, 24):
        idx, mask = smoke.random_table(smoke.N_BENCH, k, smoke.N_BENCH, rng)
        for dt in (torch.bfloat16, torch.float32):
            xl, xr, att = smoke._features(idx, smoke.N_BENCH, dt, rng, heads,
                                          hc)[:3]
            bias = torch.randn(hc, device="cuda")
            yield "K6", "N=50000", smoke.check_attention(
                idx, mask, xl, xr, att, bias, heads)[0]
    graph = smoke.synthetic_slide()
    _, csr, banded, _, _ = smoke.strip_major_table(graph)
    idx, mask = (torch.from_numpy(a).cuda() for a in (csr.idx, csr.mask))
    lo, idxl, bmask = (torch.from_numpy(a).cuda() for a in banded)
    xl, xr, att = smoke._features(idx, graph.n_tx, torch.float32, rng, heads,
                                  hc)[:3]
    bias = torch.randn(hc, device="cuda")
    xr_pad = torch.cat([xr, xr.new_zeros(idxl.shape[0] - graph.n_tx, hc)])
    yield "K6", "slide", smoke.check_attention(idx, mask, xl, xr, att, bias,
                                               heads)[0]
    yield "K7", "slide", smoke.check_attention(idxl, bmask, xl, xr_pad, att,
                                               bias, heads, lo)[0]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose segger_tpu_torch is measured")
    ap.add_argument("--kernel", choices=("bwd", "fwd", "attn", "score"),
                    default="bwd")
    ap.add_argument("--max-blocks", type=int, default=None,
                    help="the kernels' grid cap (ops/postgather.py "
                         "_MAX_BLOCKS), for a block-count sweep")
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
    from segger_tpu_torch.ops import postgather
    if args.max_blocks:
        postgather._MAX_BLOCKS = args.max_blocks
    print(smoke.gpu_line(), "|", segger_tpu_torch.__file__, "| max blocks",
          getattr(postgather, "_MAX_BLOCKS", None))
    rng = np.random.default_rng(smoke.SEED)
    if args.kernel == "attn":
        for kernel, where, r in attn_records(smoke, rng):
            print(json.dumps({"tag": args.tag, "kernel": kernel,
                              "where": where, **{
                                  key: r[key] for key in (
                                      "n", "k", "dtype", "device_ms",
                                      "graph_ms", "ms", "bound_ms",
                                      "max_abs_err", "extra_bytes")}}))
        return 0
    if args.kernel == "score":
        for n, k, n_bd, dt in SCORE_RUNS:
            idx, mask = smoke.random_table(n, k, n_bd, rng)
            r = smoke.check_score(idx, mask, n_bd, rng, f=64,
                                  dtype=getattr(torch, dt))
            print(json.dumps({"tag": args.tag, "kernel": "K5", **{
                key: r[key] for key in (
                    "n", "k", "dtype", "device_ms", "graph_ms", "ms",
                    "bound_ms", "max_abs_err", "library_device_ms",
                    "valid_slots", "layout")}}))
        return 0
    check = (smoke.check_edge_stage_bwd if args.kernel == "bwd"
             else smoke.check_edge_stage)
    for n, n_src, k, dt, mode in runs_of(args.kernel, smoke.N_BENCH,
                                         torch.bfloat16, torch.float32):
        idx, mask = smoke.random_table(n, k, n_src, rng)
        r = check(idx, mask, n_src, dt, rng, mode=mode)
        print(json.dumps({"tag": args.tag, "kernel": args.kernel, **{
            key: r[key] for key in ("mode", "n", "k", "dtype", "device_ms",
                                    "graph_ms", "ms", "bound_ms",
                                    "max_abs_err")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
