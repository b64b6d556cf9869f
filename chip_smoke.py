#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``segger_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the check, on one CUDA device
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # one predict pass, by kernel, into
                                     # chiprun_out/predict_profile.txt

Phases (any failure exits non-zero; nothing is caught):

1. build every CUDA kernel of the predict path from ``segger_tpu_torch/
   csrc`` (one nvcc per source, started together) and print the build
   time and each kernel's registers and spills;
2. hold each kernel against its plain PyTorch version on the card at the
   predict path's shapes, and time both (CUDA events), beside the least
   time the card could take for the same work;
3. drive ``SeggerTrainer.predict`` at the full ``TrainConfig()`` width
   (bf16, 4 GATv2 layers, 64 x 2 heads) over a synthetic slide of 200k
   transcripts and 10k cells with random weights from a seed, counting
   kernel launches, and run the same predict on the CPU (plain versions,
   same weights) to compare assignments.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel JSON record, and the line before that the card's
name and power limit.  Without a CUDA device the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
N_TX, N_CELLS, N_GENES, F_GENE, F_BD = 200_000, 10_000, 400, 16, 128
N_BENCH = 50_000                  # rows of the per-kernel checks
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, device memory
F32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
MIN_AGREEMENT = 0.99              # GPU vs CPU identical cell_encoding
SIM_ATOL = 2e-2                   # GPU vs CPU similarity
ROOT = Path(__file__).resolve().parent


def synthetic_slide(n_tx=N_TX, n_cells=N_CELLS, n_genes=N_GENES,
                    f_gene=F_GENE, f_bd=F_BD, seed=SEED):
    """A HostGraph at Xenium density, made with numpy from ``seed``:
    uniform transcripts (~0.14 per um^2), cells on a jittered grid, tx kNN
    k=5 within 5 um (self included), 30% of transcripts supervised to
    their nearest cell, the 3 nearest cells as candidates."""
    import numpy as np
    from scipy.spatial import cKDTree

    from segger_tpu_torch.data.assemble import HostGraph
    from segger_tpu_torch.data.neighbors_host import kdtree_neighbors

    rng = np.random.default_rng(seed)
    ext = 600.0 * float(np.sqrt(n_tx / 50_000))
    pos = rng.uniform(0, ext, (n_tx, 2)).astype(np.float32)
    tt_src, tt_dst = kdtree_neighbors(pos, max_k=5, max_dist=5.0)
    g = int(np.ceil(np.sqrt(n_cells)))
    gx, gy = np.meshgrid(np.arange(g), np.arange(g))
    centers = np.stack([gx.ravel(), gy.ravel()], 1)[:n_cells]
    pitch = ext / g
    bd_pos = (centers * pitch + pitch / 2
              + rng.normal(0, pitch / 6, (n_cells, 2))).astype(np.float32)
    tree = cKDTree(bd_pos)
    nearest = tree.query(pos, k=1)[1]
    sg = rng.uniform(size=n_tx) < 0.3
    cand = tree.query(pos, k=3)[1]
    n_cl_tx, n_cl_bd = 20, 12
    return HostGraph(
        tx_gene=rng.integers(0, n_genes, n_tx).astype(np.int32),
        tx_pos=pos,
        tx_cluster=rng.integers(0, n_cl_tx, n_tx).astype(np.int32),
        tx_index=np.arange(n_tx, dtype=np.int64),
        tx_cell_encoding=np.where(sg, nearest, -1).astype(np.int64),
        bd_x=rng.normal(size=(n_cells, f_bd)).astype(np.float32),
        bd_pos=bd_pos,
        bd_cluster=rng.integers(0, n_cl_bd, n_cells).astype(np.int32),
        bd_index=np.arange(n_cells, dtype=np.int64),
        bd_cell_id=np.array([f"cell{i}" for i in range(n_cells)]),
        tt_src=tt_src,
        tt_dst=tt_dst,
        sg_src=np.where(sg)[0].astype(np.int32),
        sg_dst=nearest[sg].astype(np.int32),
        cand_src=np.repeat(np.arange(n_tx), 3).astype(np.int32),
        cand_dst=cand.ravel().astype(np.int32),
        gene_embedding=rng.normal(size=(n_genes, f_gene)).astype(
            np.float32),
        tx_similarity=rng.uniform(size=(n_cl_tx, n_cl_tx)).astype(
            np.float32),
        bd_similarity=rng.uniform(size=(n_cl_bd, n_cl_bd)).astype(
            np.float32),
    )


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` warm launches."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def random_table(n, k, n_src, rng, empty_frac=0.02):
    """(n, k) int32 idx and bool mask: per-row degrees uniform in
    [1, k] with leading valid slots, and a share of rows left empty."""
    import numpy as np
    import torch

    deg = rng.integers(1, k + 1, n)
    deg[rng.uniform(size=n) < empty_frac] = 0
    mask = np.arange(k)[None, :] < deg[:, None]
    idx = np.where(mask, rng.integers(0, n_src, (n, k)), 0)
    return (torch.from_numpy(idx.astype(np.int32)).cuda(),
            torch.from_numpy(mask).cuda())


def check_edge_stage(idx, mask, n_src, dtype, rng, heads=2, hc=128):
    """The edge-stage kernel against its plain version on one (idx,
    mask) table, with random features; times both."""
    import torch

    from segger_tpu_torch.ops.postgather import (
        edge_stage_fwd, edge_stage_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1e9)))
    n, k = idx.shape
    xl = torch.randn(n_src, hc, generator=gen, device="cuda").to(dtype)
    xr = torch.randn(n, hc, generator=gen, device="cuda").to(dtype)
    att = torch.randn(heads, hc // heads, generator=gen,
                      device="cuda").to(dtype)
    args = (xl, xr, att, idx, mask, heads)
    out, alpha = edge_stage_fwd(*args)
    ref_out, ref_alpha = edge_stage_fwd_reference(*args)
    torch.cuda.synchronize()
    if not (torch.isfinite(out.float()).all() and torch.isfinite(alpha).all()):
        raise AssertionError(f"edge_stage_fwd K={k} {dtype}: non-finite")
    err_out = (out.float() - ref_out.float()).abs()
    err_alpha = (alpha - ref_alpha).abs().max().item()
    # f32: one arithmetic, other summation order.  bf16: the f32 sums
    # may round to a neighbouring bf16 value of the output
    if dtype == torch.float32:
        atol, rtol = 1e-5, 1e-5
    else:
        atol, rtol = 2e-2, 2e-2
    ok_out = (err_out <= atol + rtol * ref_out.float().abs()).all().item()
    if not ok_out or err_alpha > 1e-5:
        raise AssertionError(
            f"edge_stage_fwd K={k} {dtype}: out err {err_out.max().item()}"
            f" alpha err {err_alpha}")
    empty = ~mask.any(1)
    if not ((out[empty] == 0).all() and (alpha[empty] == 0).all()):
        raise AssertionError("edge_stage_fwd: empty rows not zero")
    launches = edge_stage_fwd.launches
    ms = cuda_ms(lambda: edge_stage_fwd(*args), 50)
    plain_ms = cuda_ms(lambda: edge_stage_fwd_reference(*args), 5)
    edge_stage_fwd.launches = launches     # the checks do not count
    size = xl.element_size()
    n_valid = int(mask.sum())
    n_src_rows = int(idx[mask].unique().numel())
    n_bytes = ((n_src_rows + 2 * n) * hc * size + hc * size
               + idx.numel() * 5 + alpha.numel() * 4)
    n_ops = n_valid * hc * 8      # add, leaky, logit fma, weighted sum
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"n": n, "k": k, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": max(err_out.max().item(), err_alpha),
            "tol": f"out atol {atol} rtol {rtol}, alpha atol 1e-5",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": n_bytes, "valid_slots": n_valid,
            "empty_rows": int(empty.sum())}


def check_score(idx, mask, n_bd, rng, f=64, dtype=None):
    """The scoring kernel against its plain version on one candidate
    table, with random unit rows; times both and one PyTorch masked
    einsum + max as the library yardstick."""
    import torch

    from segger_tpu_torch.ops.score import score_max, score_max_reference

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1e9)))
    n, k = idx.shape

    def unit(m):
        x = torch.randn(m, f, generator=gen, device="cuda")
        return (x / x.norm(dim=1, keepdim=True)).to(dtype)

    tx, bd = unit(n), unit(n_bd)
    mx, slot = score_max(tx, bd, idx, mask)
    ref_mx, ref_slot = score_max_reference(tx, bd, idx, mask)
    torch.cuda.synchronize()
    err = (mx - ref_mx).abs().max().item()
    if not torch.equal(slot, ref_slot) or err > 1e-5:
        raise AssertionError(f"score_max: slot mismatch "
                             f"{(slot != ref_slot).sum().item()}, err {err}")
    if not (slot[~mask.any(1)] == -1).all():
        raise AssertionError("score_max: empty rows not -1")
    idx_l = idx.long()

    def library():
        cos = torch.einsum("nf,nkf->nk", tx.float(), bd[idx_l].float())
        return torch.where(mask, cos, -1e30).max(dim=1)

    launches = score_max.launches
    ms = cuda_ms(lambda: score_max(tx, bd, idx, mask), 50)
    plain_ms = cuda_ms(lambda: score_max_reference(tx, bd, idx, mask), 5)
    library_ms = cuda_ms(library, 20)
    score_max.launches = launches
    size = tx.element_size()
    n_valid = int(mask.sum())
    n_rows = int(idx[mask].unique().numel())
    n_bytes = (n_rows + n) * f * size + idx.numel() * 5 + n * 8
    b_ms, b_by = bound_ms(n_bytes, n_valid * f * 2)
    return {"n": n, "k": k, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "tol": "slots equal, max atol 1e-5",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "valid_slots": n_valid, "empty_rows": int((~mask.any(1)).sum())}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def profile_predict(trainer, specs, plans, path: Path):
    """Where the predict time goes: host extraction alone, the warm
    predict wall (three runs), and one predict pass under torch.profiler
    for device time by kernel and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for plan in plans:
        trainer._build_batch(plan)
    extract = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer.predict(specs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.predict(specs)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side events only (kernels, copies): the CPU ops carry the
    # same time again as their "self device" share
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    line = (f"profile: host extraction {extract:.3f} s for {len(plans)} "
            f"batches; warm predict wall {wall:.3f} s (runs {walls}); "
            f"device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / 1e3 / wall:.4f}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"{line}\n{table}\n")
    print(line)
    print(f"profile table in {path}")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from segger_tpu_torch.data.partition import (
        build_tiling, make_predict_tiles,
    )
    from segger_tpu_torch.models.encoder import tt_segments
    from segger_tpu_torch.ops import _build
    from segger_tpu_torch.ops.postgather import edge_stage_fwd
    from segger_tpu_torch.ops.score import score_max
    from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

    card = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build
    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(report)}")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- host planning of the slide (gives the widths of the real tiles)
    t0 = time.perf_counter()
    graph = synthetic_slide()
    tree = build_tiling(graph, nodes_per_tile=50_000)
    specs = make_predict_tiles(graph, tree, margin=20.0)
    cfg = TrainConfig()
    trainer = SeggerTrainer(graph, cfg)
    plans = trainer._batch_plans(specs, use_xlo=True)
    bucket = plans[0][1]
    print(f"slide: {graph.n_tx} tx, {graph.n_bd} cells, {len(specs)} "
          f"tiles, {len(plans)} batches, bucket {bucket}, host "
          f"{time.perf_counter() - t0:.1f} s")
    if not (bucket.n_xlo and bucket.n_lo):
        raise AssertionError("predict bucket lost its degree segments")

    # -- phase 2: kernels against their plain versions.  (a) N = 50,000
    # rows at the real tile's widths, bf16 and f32, random tables
    rng = np.random.default_rng(SEED)
    heads, hc = cfg.n_heads, cfg.n_heads * cfg.hidden_channels
    checks = []
    for k in sorted({bucket.k_xlo, bucket.k_lo, bucket.k_tt, bucket.k_tb}):
        idx, mask = random_table(N_BENCH, k, N_BENCH, rng)
        for dt in (torch.bfloat16, torch.float32):
            checks.append(("edge_stage_fwd", "N=50000", check_edge_stage(
                idx, mask, N_BENCH, dt, rng, heads, hc)))
    idx, mask = random_table(N_BENCH, bucket.k_cand, 2_500, rng)
    checks.append(("score_max", "N=50000", check_score(
        idx, mask, 2_500, rng, f=cfg.out_channels)))
    # (b) the launches the main path makes on its first tile, on that
    # tile's own tables: the tt segments and tb of one layer, scoring
    tile = trainer._build_batch(plans[0]).to("cuda").map_arrays(
        lambda a: a[0])
    segs = [(f"tt[{a}:{b}]", i, m) for a, b, i, m in tt_segments(tile)]
    segs.append(("tb", tile.tb.idx, tile.tb.mask))
    for name, i, m in segs:
        checks.append(("edge_stage_fwd", f"tile {name}", check_edge_stage(
            i, m, tile.n_tx, torch.bfloat16, rng, heads, hc)))
    checks.append(("score_max", "tile cand", check_score(
        tile.cand.idx, tile.cand.mask, tile.n_bd, rng,
        f=cfg.out_channels)))
    for kernel, where, r in checks:
        print(f"{kernel} [{where}] " + json.dumps(r))

    # -- phase 3: the main path
    trainer.init()
    torch.cuda.reset_peak_memory_stats()
    edge_stage_fwd.launches = 0
    score_max.launches = 0
    t0 = time.perf_counter()
    got = trainer.predict(specs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"edge_stage_fwd": edge_stage_fwd.launches,
                "score_max": score_max.launches}
    n_tiles = sum(len(s) for s, _ in plans)
    n_layers = 2 + cfg.n_mid_layers
    print(f"predict: {n_tiles} tiles, {len(plans)} batches, "
          f"{got['row_index'].size} transcripts, "
          f"{int((got['cell_encoding'] >= 0).sum())} assigned, "
          f"wall {wall:.3f} s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"launches {launches}")
    want = {"edge_stage_fwd": n_tiles * n_layers * 4, "score_max": n_tiles}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    rows = np.sort(got["row_index"])
    if not np.array_equal(rows, np.arange(graph.n_tx)):
        raise AssertionError("predict did not cover every transcript once")
    assigned = got["cell_encoding"] >= 0
    if not (np.isfinite(got["similarity"][assigned]).all()
            and got["cell_encoding"].max() < graph.n_bd
            and assigned.mean() > 0.99):
        raise AssertionError("predict output out of range")

    # -- the same predict on the CPU with the same weights
    cpu = SeggerTrainer(graph, cfg, device="cpu")
    cpu.init()
    t0 = time.perf_counter()
    ref = cpu.predict(specs)
    cpu_wall = time.perf_counter() - t0
    gi, ri = np.argsort(got["row_index"]), np.argsort(ref["row_index"])
    same = got["cell_encoding"][gi] == ref["cell_encoding"][ri]
    both = assigned[gi] & (ref["cell_encoding"][ri] >= 0)
    sim_err = np.abs(got["similarity"][gi] - ref["similarity"][ri])[both]
    print(f"cpu predict: wall {cpu_wall:.1f} s, identical cell_encoding "
          f"{same.mean():.5f} (need >= {MIN_AGREEMENT}), max similarity "
          f"diff {sim_err.max():.3e} (need <= {SIM_ATOL})")
    if same.mean() < MIN_AGREEMENT or sim_err.max() > SIM_ATOL:
        raise AssertionError("GPU and CPU predictions disagree")

    if "--profile" in argv:
        profile_predict(trainer, specs, plans,
                        ROOT / "chiprun_out" / "predict_profile.txt")

    def summary(kernel):
        tile_rs = [r for k, w, r in checks if k == kernel
                   and w.startswith("tile")]
        return {
            "max_abs_err": max(r["max_abs_err"] for k, _, r in checks
                               if k == kernel),
            # one layer's launches on one tile, at the main path's shapes
            "ms": sum(r["ms"] for r in tile_rs),
            "plain_ms": sum(r["plain_ms"] for r in tile_rs),
            "bound_ms": sum(r["bound_ms"] for r in tile_rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in tile_rs) else "operations",
            "shape": " + ".join(f"{r['n']}x{r['k']}" for r in tile_rs),
        }

    es_sum, sc_sum = summary("edge_stage_fwd"), summary("score_max")
    sc_tile = [r for k, w, r in checks if k == "score_max"
               and w.startswith("tile")][0]
    kernels = [
        {"name": "edge_stage_fwd", "route": "cuda",
         "source": "segger_tpu_torch/csrc/edge_stage_fwd.cu",
         "replaces": "segger_tpu/ops/pallas/postgather.py:175",
         "launches": launches["edge_stage_fwd"], **es_sum,
         "library_ms": None},
        {"name": "score_max", "route": "cuda",
         "source": "segger_tpu_torch/csrc/score.cu",
         "replaces": "segger_tpu/ops/pallas/score.py:60",
         "launches": launches["score_max"], **sc_sum,
         "library_ms": sc_tile["library_ms"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
