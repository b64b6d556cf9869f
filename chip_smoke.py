#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``segger_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # the check, on one CUDA device
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of
                                     # one predict pass and one training
                                     # step, by kernel, into
                                     # chiprun_out/{predict,train}_profile.txt
    python3 chip_smoke.py --whole-slide  # the build, phase 7's pipeline
                                     # and phases 10, 11 and 12 only
                                     # (run it on a host of several
                                     # cards)

Phase 12 starts its ranks as ``chip_smoke.py --rank R --world W --addr
HOST:PORT --work DIR --backend gloo|nccl`` (``rank_main``).

Phases (any failure exits non-zero; nothing is caught):

1. build every CUDA kernel of the predict and training paths from
   ``segger_tpu_torch/csrc`` (one nvcc per source, started together,
   and meanwhile the host's native spatial core, one g++) and print the
   build time and each kernel's registers and spills;
2. hold each kernel against its plain PyTorch version on the card, at
   N = 50,000 rows and on the main paths' own tile tables, and time both
   (CUDA events around the wrapper calls, and for every kernel and K5's
   library yardstick also ``device_ms``, the device time from
   torch.profiler, since at tile sizes the wrapper's host work outruns
   the kernel, and for every kernel ``graph_ms`` from a CUDA graph of
   the calls), beside the least time the card could take for the same
   work: K1 (edge-stage forward), K2 (its hashed-dropout mode), K3 (the
   edge-stage backward, no-dropout and hashed-dropout modes, run twice
   to show it repeats bit for bit), K4 (the keep-tensor mode of both),
   K5 (candidate scoring), K6 (the fused attention, at N = 50,000 and
   the tiles' widths) and K7 (the banded edge stage, on the slide-wide
   strip-major tt table that ``band_graph`` bands), each of K6 and K7
   with the device memory its call takes beyond its output;
3. drive ``SeggerTrainer.predict`` at the full ``TrainConfig()`` width
   (bf16, 4 GATv2 layers, 64 x 2 heads) over a synthetic slide of 200k
   transcripts and 10k cells with random weights from a seed, counting
   kernel launches (a captured step's replays add the launches recorded
   at its capture) and captures, and run the same predict on the CPU
   (plain versions, same weights) to compare assignments;
4. drive ``SeggerTrainer.fit`` for 2 epochs at ``TrainConfig()`` on the
   same slide's margin tiles, every step a replayed CUDA graph, counting
   launches and captures, with per-epoch losses, step wall times and
   peak memory; then the edge-stage op in keep mode (K4's own path)
   forward and backward on a training tile;
4b. run the first epoch's training steps again on the card, eagerly
   (``SeggerTrainer.train_step``) from the same initial weights: the
   first step's loss must equal the graphed one, and every step's agree
   within ``GRAPH_STEP_RTOL``;
4c. fit again from the same initial weights with ``scan_steps =
   SCAN_STEPS`` (loss rows read back four steps at a time): every step's
   loss within ``GRAPH_STEP_RTOL`` of phase 4's, with both fits' epoch
   walls;
5. run the first 4 training steps again on the CPU (same init, same
   generators, plain versions) and compare the per-step losses;
6. the forward-only path in float32: the first tt conv of the
   initialized encoder on the slide's layer-0 features over the
   slide-wide strip-major table, through K1 + bias, K6, K7 and the
   unfused conv (which must agree, its attention summing to 1), with
   launch counts; then the encoder's attention-capture forward on the
   first predict tile against its fused forward and the CPU;
7. the pipeline users run: ``ISTPipeline(...).run()`` on a
   ``make_synthetic`` slide of 10,000 cells and 400 genes (about 210k
   transcripts) at ``PipelineConfig()`` (128-wide features, adaptive
   tiles of 50,000 nodes, cell-mode candidates) and ``TrainConfig()``
   width for 2 epochs: features, the whole-slide graph, tiles, fit,
   predict and the segmentation table, with each stage's wall, the
   launches of K1, K2, K3 and K5 counted and held to the captures and
   replays, accuracy against the true cells above 0.6, one row per
   transcript, a cell for exactly the transcripts with a candidate edge,
   ``predict_streaming`` + ``write_dense`` equal to ``predict`` +
   ``write``, and the accuracy on transcripts with two or more candidate
   cells after training and with the initial weights; the port's
   ``segmentation_report`` of the table against the true cells and the
   median ``percent_contamination`` of ``calculate_contamination`` over
   an in-memory ``AnnDataLite`` of the table (``build_anndata``), its
   cells labelled with their synthetic expression programs, against a
   reference from ``expression_summary_from_anndata`` (recorded, not
   held); then K1, K2, K3 and K5 against their plain versions on the
   pipeline's own first tiles (its predict tile's tables and variable-K
   candidate table with its empty rows, its training tile's tables),
   timed, at phase 2's tolerances.  The h5ad export is off there (``save_anndata=False``):
   the GPU machine has no h5py;
8. the command line users run: phase 7's slide written as a raw Xenium
   v2 directory (``write_xenium_like``), then ``segger-tpu-torch segment
   --no-anndata --max-epochs 2 --seed 0 --devices 1`` on it in this
   process, and
   ``export transcripts boundaries`` on its output, with each stage's
   wall (write-vendor, read, features + graph, fit, predict, write,
   export-boundaries): the graph the command builds from the vendor
   files equals phase 7's (integer arrays exactly, floats within 1e-6),
   the table passes phase 7's checks, the launches of K1, K2, K3 and K5
   equal the run's captures and replays, the boundaries go through the
   export's process pool started by spawn (CUDA is initialized), and
   more than 90 % of the cells export kept have a ring of three or more
   vertices;
9. the out-of-core whole-slide path (``drive_outofcore``): phase 7's
   slide as ``ColumnarTranscripts.from_chunks`` of 7 DataFrame chunks,
   spooled to disk, through ``ISTPipeline(...).load()`` (the graph must
   equal phase 7's: integer fields exactly, float fields within rtol
   1e-6, atol 1e-7), saved as a graph plane, loaded memmapped, fit for 2
   epochs, ``predict_streaming`` and ``write_dense`` (the table passes
   phase 7's checks and agrees with phase 7's on at least 0.99 of the
   transcripts; K1, K2, K3 and K5 launched as counted, then held against
   their plain versions on this path's first tiles); the slide as a raw
   MERSCOPE directory through ``segment --low-memory --graph-cache C
   --prepare-only`` in a child process that must initialize no CUDA, then
   ``segment --low-memory --graph-cache C`` here on the card, which must
   load the plane (no read, no build) and launch as counted; and the
   native spatial core on this card's host: phase 7's graph stage by the
   native and the KDTree branches (equal edge sets, both substage walls)
   and the common-neighbor counts of its cells' kNN graph by the native
   merge and the SpGEMM (equal, both walls).  Each stage's wall,
   ``peak_rss_gb``, the sampled RSS and anonymous-RSS peaks and
   ``torch.cuda.max_memory_allocated`` are printed beside the card's
   name and power limit;
10. the whole-slide halo-exchange path (``drive_whole_slide``) on phase
   7's graph with phase 7's trained weights, every shard on ``cuda:0``:
   ``predict_whole_slide`` at 1 strip, 4 strips and a 2x2 grid, in bf16
   (4 strips and the grid agree with 1 strip on at least
   ``MIN_AGREEMENT`` of the transcripts, the similarity within
   ``SIM_ATOL``, accuracy above 0.6) and in float32 (cells equal wherever
   the top-two candidate margin exceeds 1e-5, similarity within 1e-4);
   the surrogate gradient of ``tests/test_halo_train.py`` at 4 strips
   against 1 strip within 5e-5 of scale (f32); ``fit_whole_slide`` for 2
   epochs at 1 and 4 strips from one init; with more than one card the
   4-strip predict over ``min(4, count)`` cards bit-equal to one card
   and its fit's losses within ``GRAPH_STEP_RTOL`` of one card's;
   and ``segment --distributed-predict --distributed-train --devices 1``
   on phase 7's slide as a Xenium directory (the table passes phase 7's
   checks).  Every run's launches of K1, K2, K3 and K5 are held to 8 K1
   and 1 K5 a shard a predict and 8 K2 and 8 K3 a shard a step; then
   K1, K2, K3 and K5 against their plain versions on a shard's own
   extended tables (the middle strip's, a grid shard's), K5 in float32
   as this path scores.  Each wall (build, predict, fit epoch) and
   ``torch.cuda.max_memory_allocated`` are printed beside the card's
   name and power limit;
11. tile data parallelism (``drive_tile_dp``) on phase 7's graph and
   tiling at ``TrainConfig()`` width with ``tiles_per_step = 4``: the
   one-device trainer fits 2 epochs from the seeded weights and
   predicts; ``SeggerTrainer(mesh=)`` over 4 shards on ``cuda:0`` fits
   from the same weights (every step's loss within ``GRAPH_STEP_RTOL``,
   the launches of K1, K2, K3 and K5 equal to the one-device fit's, each
   shard's counted from its steps' replays) and predicts with the
   one-device weights (cells equal on at least ``MIN_AGREEMENT`` of the
   transcripts, bit-equality recorded, the same launches); with several
   cards the same mesh with shard d on card d (losses within
   ``GRAPH_STEP_RTOL``, predict bit-equal) and with four ``segment
   --devices 4`` on phase 7's slide as a Xenium directory; then K1, K2,
   K3 and K5 against their plain versions on one shard's own tiles;
12. the whole-slide paths over several processes (``drive_multiprocess``)
   on phase 7's graph with phase 7's trained weights at ``TrainConfig()``
   width, one shard a rank: two ranks of this script on ``cuda:0`` joined
   by ``initialize_multihost(backend="gloo")`` (NCCL refuses two ranks
   on one card), started as subprocesses and waited for at most
   ``MP_TIMEOUT`` seconds (a failed rank or the limit kills them all);
   ``predict_whole_slide`` at 2 strips and a 2x1 grid bit-equal to one
   process's 2-shard predict on ``cuda:0``, ``fit_whole_slide`` for 2
   epochs from the seeded init with every epoch's loss within
   ``GRAPH_STEP_RTOL`` of one process's and the parameters equal on both
   ranks, each rank's launches its shard's share (8 K1 and 1 K5 a
   predict, 8 K2 and 8 K3 a step); with several cards the same with
   ``min(4, count)`` NCCL ranks, rank r on card r (strips, and the 2x2
   grid on four), against one process over the same cards.  The walls
   (rank start-up and ``initialize_multihost``, predicts, fit epochs)
   are printed beside one process's and the card's name and power
   limit;
13. the sparse-op helpers of ``ops`` that no main path runs
   (``drive_helpers``): ``csr_spmm`` in its three weight forms,
   ``csr_sddmm``, ``row_gather_1d``, ``take_rows``, ``csr_gather_t`` and
   the COO ``segment_sum``, ``segment_max`` and ``segment_softmax``,
   then the backwards of ``take_rows``, ``csr_gather_t`` and
   ``csr_spmm``, on ``cuda:0`` over ``bench.py::build_tile``'s tt table
   (50,000 transcripts, kNN 5, its transpose table and COO form) at F =
   128, H = 2 in float32, each against the same call on the CPU
   (``HELPER_ATOL`` + ``HELPER_RTOL`` of the magnitude, integers
   equal), with its ``cuda_ms``; no kernel wrapper counts a launch.

Every kernel record has ``device_ms`` (``kernel_trace``: the profiler
drops the first device records of each trace, so a lead of spin kernels
opens it) and ``graph_ms`` (``reps`` chained calls in one CUDA graph,
replayed between two events) beside the event-timed ``ms``.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel JSON record, and the line before that the card's
name and power limit.  Without a CUDA device the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SEED = 0
N_TX, N_CELLS, N_GENES, F_GENE, F_BD = 200_000, 10_000, 400, 16, 128
N_BENCH = 50_000                  # rows of the per-kernel checks
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, device memory
F32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
MIN_AGREEMENT = 0.99              # GPU vs CPU identical cell_encoding
SIM_ATOL = 2e-2                   # GPU vs CPU similarity
DROPOUT = 0.2                     # the encoder's attention dropout
TRAIN_EPOCHS = 2
CPU_STEPS = 4                     # training steps repeated on the CPU
SCAN_STEPS = 4                    # phase 4c's TrainConfig.scan_steps
FIRST_STEP_RTOL = 1e-2            # GPU vs CPU loss of the first step
GRAPH_STEP_RTOL = 1e-3            # graphed vs eager loss of each step
MEAN_STEP_RTOL = 2e-2             # GPU vs CPU mean loss of the CPU steps
# phase 7: make_synthetic's slide at PERF.md's density, PipelineConfig()
PIPE_CELLS, PIPE_GENES, PIPE_TX_PER_CELL = 10_000, 400, 20
PIPE_EPOCHS = 2
MIN_ACCURACY = 0.6                # against the true cells (test_e2e.py's)
TRACE_LEAD = 64                   # spin kernels that open a trace
LEAD_KERNEL = "spin_kernel"       # torch.cuda._sleep's kernel
HELPER_ATOL = HELPER_RTOL = 1e-5   # phase 13: a helper, card against CPU
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


def kernel_trace(fn, reps: int, kernel: str | None = None,
                 lead: int = TRACE_LEAD) -> tuple:
    """One torch.profiler trace of ``lead`` spin kernels and then
    ``reps`` calls of ``fn()``: the count of the calls' device records
    (of the CUDA kernel whose name contains ``kernel``, or of every
    device activity but the spins), their summed device milliseconds,
    and how many spin records the trace kept.

    The profiler drops the first device records of a trace, more of
    them the longer the process has idled between traces (on an H100
    80GB HBM3 at 700 W: none while traces follow each other, 11 after
    seven 20 s pauses; ``tools/device_ms_trace.py``): the spins take the
    loss, and while one of them is kept, every record of the calls is."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(1)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    spins = sum(e.count for e in events if LEAD_KERNEL in e.key)
    events = [e for e in events if LEAD_KERNEL not in e.key
              and (kernel is None or kernel in e.key)]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3, spins)


def device_ms(fn, reps: int, kernel: str | None = None) -> float:
    """Mean device milliseconds of one call of ``fn()``, from
    torch.profiler over ``reps`` warm calls: the device's own time,
    whatever the host spends around it.  (``cuda_ms`` brackets the calls
    with events, so at small sizes it measures how fast the wrapper
    enqueues.)  With ``kernel``, the mean time of the traced launches of
    the CUDA kernel whose name contains it, one a call (a trace whose
    spin lead the profiler dropped whole may have lost a few of them,
    and then the mean is over those it holds, at least half, while the
    next try takes a lead four times as long); with None, the sum over
    every device activity a call launches (a library call of several
    kernels), whose count must be a multiple of ``reps`` or the same in
    two traces in a row."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    counts, partial, lead = [], (0, 0.0), TRACE_LEAD
    for _ in range(5):     # a trace now and then comes back without kernels
        count, total, spins = kernel_trace(fn, reps, kernel, lead)
        counts.append(count)
        if not spins:
            lead *= 4
        if count and count % reps == 0 and (kernel is None or count == reps):
            return total / reps
        # a library call whose launches differ from call to call, with a
        # trace that repeats: the window's device time over its calls
        if kernel is None and count >= reps and counts[-2:] == [count] * 2:
            return total / reps
        if kernel and reps // 2 <= count < reps:
            partial = max(partial, (count, total))
    if partial[0]:
        return partial[1] / partial[0]
    raise AssertionError(f"device_ms: {counts} launches of "
                         f"{kernel or 'any kernel'} traced in five tries, "
                         f"expected {'' if kernel else 'a multiple of '}"
                         f"{reps}")


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of one call of ``fn()``, the cross-check
    of ``device_ms`` that no trace can lose: ``reps`` chained calls
    captured in one CUDA graph, replayed 5 times between two events.
    Between the calls the graph adds only its own launch gaps, not the
    wrapper's host work, and it times every kernel a call launches.  The
    capture runs the wrapper, so its launch counter moves as for
    ``reps`` calls: callers put it back."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


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


def _dropout_args(mode, rng, n, k, heads, dtype):
    """The edge stage's dropout keywords for ``mode``: hashed from two
    seed words at the training rate, or an (n, k, heads) keep tensor."""
    import numpy as np
    import torch

    if mode == "prng":
        # the words in device memory, where the main path's kernels read
        # them
        w = rng.integers(0, 2**32, 2)
        return {"seed": torch.from_numpy(w.astype(np.uint32).view(
            np.int32)).cuda(), "rate": DROPOUT}
    if mode == "keep":
        gen = torch.Generator(device="cuda").manual_seed(
            int(rng.integers(1e9)))
        keep = (torch.rand(n, k, heads, generator=gen, device="cuda")
                >= DROPOUT) / (1 - DROPOUT)
        return {"keep": keep.to(dtype)}
    return {}


def _features(idx, n_src, dtype, rng, heads, hc):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1e9)))
    n = idx.shape[0]
    xl = torch.randn(n_src, hc, generator=gen, device="cuda").to(dtype)
    xr = torch.randn(n, hc, generator=gen, device="cuda").to(dtype)
    att = torch.randn(heads, hc // heads, generator=gen,
                      device="cuda").to(dtype)
    go = torch.randn(n, hc, generator=gen, device="cuda").to(dtype)
    return xl, xr, att, go


def _row_bytes(idx, mask, hc, size):
    """Bytes of the source rows that the valid slots reference (each
    once) and of the idx/mask tables."""
    n_src_rows = int(idx[mask].unique().numel())
    return n_src_rows * hc * size + idx.numel() * 5


def check_edge_stage(idx, mask, n_src, dtype, rng, heads=2, hc=128,
                     mode="nokeep"):
    """The edge-stage forward kernel against its plain version on one
    (idx, mask) table, with random features, in one dropout mode; times
    both."""
    import torch

    from segger_tpu_torch.ops.postgather import (
        edge_stage_fwd, edge_stage_fwd_reference,
    )

    n, k = idx.shape
    xl, xr, att, _ = _features(idx, n_src, dtype, rng, heads, hc)
    kw = _dropout_args(mode, rng, n, k, heads, dtype)
    args = (xl, xr, att, idx, mask, heads)
    out, alpha = edge_stage_fwd(*args, **kw)
    ref_out, ref_alpha = edge_stage_fwd_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(out.float()).all() and torch.isfinite(alpha).all()):
        raise AssertionError(f"edge_stage_fwd {mode} K={k} {dtype}: "
                             "non-finite")
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
            f"edge_stage_fwd {mode} K={k} {dtype}: out err "
            f"{err_out.max().item()} alpha err {err_alpha}")
    empty = ~mask.any(1)
    if not ((out[empty] == 0).all() and (alpha[empty] == 0).all()):
        raise AssertionError("edge_stage_fwd: empty rows not zero")
    launches = dict(edge_stage_fwd.launches)
    ms = cuda_ms(lambda: edge_stage_fwd(*args, **kw), 50)
    dev_ms = device_ms(lambda: edge_stage_fwd(*args, **kw), 20,
                       "edge_stage_fwd_kernel")
    gr_ms = graph_ms(lambda: edge_stage_fwd(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: edge_stage_fwd_reference(*args, **kw), 5)
    edge_stage_fwd.launches = launches     # the checks do not count
    size = xl.element_size()
    n_valid = int(mask.sum())
    n_bytes = (_row_bytes(idx, mask, hc, size) + 2 * n * hc * size
               + hc * size + alpha.numel() * 4)
    if mode == "keep":
        n_bytes += kw["keep"].numel() * size
    n_ops = n_valid * hc * 8      # add, leaky, logit fma, weighted sum
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"mode": mode, "n": n, "k": k,
            "dtype": str(dtype).split(".")[-1],
            "max_abs_err": max(err_out.max().item(), err_alpha),
            "tol": f"out atol {atol} rtol {rtol}, alpha atol 1e-5",
            "ms": ms, "device_ms": dev_ms, "graph_ms": gr_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by, "bytes": n_bytes, "valid_slots": n_valid,
            "empty_rows": int(empty.sum())}


def check_edge_stage_bwd(idx, mask, n_src, dtype, rng, heads=2, hc=128,
                         mode="nokeep"):
    """The edge-stage backward kernel against its plain version on one
    table, from the forward's alpha and a random output gradient, in one
    dropout mode; runs it twice to show the outputs repeat bit for bit,
    and times both versions."""
    import torch

    from segger_tpu_torch.ops.postgather import (
        edge_stage_bwd, edge_stage_bwd_reference, edge_stage_fwd,
    )

    n, k = idx.shape
    xl, xr, att, go = _features(idx, n_src, dtype, rng, heads, hc)
    kw = _dropout_args(mode, rng, n, k, heads, dtype)
    launches_f = dict(edge_stage_fwd.launches)
    _, alpha = edge_stage_fwd(xl, xr, att, idx, mask, heads, **kw)
    edge_stage_fwd.launches = launches_f
    args = (xl, xr, att, idx, mask, alpha, go, heads)
    got = edge_stage_bwd(*args, **kw)
    again = edge_stage_bwd(*args, **kw)
    want = edge_stage_bwd_reference(*args, **kw)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        atol, rtol, datt_tol = 1e-5, 1e-5, 1e-5
    else:
        atol, rtol, datt_tol = 2e-2, 2e-2, 1e-2
    errs = {}
    for name, a, b in (("dg", got[0], want[0]), ("dkeep", got[3], want[3])):
        if a is None:
            continue
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"edge_stage_bwd {mode}: {name} non-finite")
        err = (a.float() - b.float()).abs()
        if not (err <= atol + rtol * b.float().abs()).all().item():
            raise AssertionError(f"edge_stage_bwd {mode} K={k} {dtype}: "
                                 f"{name} err {err.max().item()}")
        errs[name] = err.max().item()
    # dxr sums the K slots of a row, datt every slot of every row, in
    # another order than the plain version: each against its own scale
    for name, a, b in (("dxr", got[1], want[1]), ("datt", got[2], want[2])):
        scale = b.float().abs().max().item() + 1e-9
        errs[name] = (a.float() - b.float()).abs().max().item()
        if not torch.isfinite(a.float()).all() \
                or errs[name] / scale > datt_tol:
            raise AssertionError(f"edge_stage_bwd {mode} K={k} {dtype}: "
                                 f"{name} err {errs[name]} of {scale}")
    if not ((got[0][~mask] == 0).all() and (got[1][~mask.any(1)] == 0).all()):
        raise AssertionError("edge_stage_bwd: masked slots not zero")
    if not all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None):
        raise AssertionError("edge_stage_bwd: two runs differ")
    launches = dict(edge_stage_bwd.launches)
    ms = cuda_ms(lambda: edge_stage_bwd(*args, **kw), 20)
    dev_ms = device_ms(lambda: edge_stage_bwd(*args, **kw), 20,
                       "edge_stage_bwd_kernel")
    gr_ms = graph_ms(lambda: edge_stage_bwd(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: edge_stage_bwd_reference(*args, **kw), 3)
    edge_stage_bwd.launches = launches
    size = xl.element_size()
    n_valid = int(mask.sum())
    # reads: the referenced source rows, xr, G, alpha, idx/mask; writes:
    # dg, dxr and the datt partials (keep mode: keep in, dkeep out).  The
    # partials are counted at one per 8 rows up to 1,024, as the bound was
    # first set, so that it stays one yardstick across kernel designs
    n_blocks = min(-(-n // 8), 1024)
    n_bytes = (_row_bytes(idx, mask, hc, size) + 2 * n * hc * size
               + alpha.numel() * 4 + n * k * hc * size + n * hc * size
               + n_blocks * hc * 4)
    if mode == "keep":
        n_bytes += 2 * kw["keep"].numel() * size
    n_ops = n_valid * hc * 14     # t, dA, p, s, datt, dp, dxr, dg
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"mode": mode, "n": n, "k": k,
            "dtype": str(dtype).split(".")[-1],
            "max_abs_err": max(errs.values()), "errs": errs,
            "tol": f"dg/dkeep atol {atol} rtol {rtol}, dxr and datt "
                   f"{datt_tol} of their max; two runs bit-equal",
            "ms": ms, "device_ms": dev_ms, "graph_ms": gr_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by, "bytes": n_bytes, "valid_slots": n_valid,
            "empty_rows": int((~mask.any(1)).sum())}


def check_score(idx, mask, n_bd, rng, f=64, dtype=None):
    """The scoring kernel against its plain version on one candidate
    table, with random unit rows; times both and one PyTorch masked
    einsum + max as the library yardstick."""
    import torch

    from segger_tpu_torch.ops import score as score_op
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
    dev_ms = device_ms(lambda: score_max(tx, bd, idx, mask), 20,
                       "score_max_kernel")
    gr_ms = graph_ms(lambda: score_max(tx, bd, idx, mask), 20)
    plain_ms = cuda_ms(lambda: score_max_reference(tx, bd, idx, mask), 5)
    library_ms = cuda_ms(library, 20)
    library_dev_ms = device_ms(library, 20)   # all of its kernels
    score_max.launches = launches
    size = tx.element_size()
    n_valid = int(mask.sum())
    n_rows = int(idx[mask].unique().numel())
    n_bytes = (n_rows + n) * f * size + idx.numel() * 5 + n * 8
    b_ms, b_by = bound_ms(n_bytes, n_valid * f * 2)
    # the layout the kernel took (None for a checkout from before
    # score_launch_config, timed by tools/bwd_device_ms.py --root)
    config = getattr(score_op, "score_launch_config", None)
    layout = config and config(n, k, f, dtype, tx.data_ptr(),
                               bd.data_ptr())._asdict()
    return {"n": n, "k": k, "dtype": str(dtype).split(".")[-1],
            "layout": layout,
            "max_abs_err": err, "tol": "slots equal, max atol 1e-5",
            "ms": ms, "device_ms": dev_ms, "graph_ms": gr_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "valid_slots": n_valid, "empty_rows": int((~mask.any(1)).sum())}


def check_attention(idx, mask, xl, xr, att, bias, heads, lo=None):
    """The fused attention kernel (K6; ``lo`` None) or the banded edge
    stage (K7; ``lo`` the window starts, ``idx`` window-local) against
    its plain version on one table; times both.  Returns the record and
    the kernel's output."""
    import torch

    from segger_tpu_torch.ops.banded import (
        BLOCK, banded_edge_stage, banded_edge_stage_reference,
    )
    from segger_tpu_torch.ops.gatv2_attn import (
        gatv2_attention, gatv2_attention_reference,
    )

    if lo is None:
        op, plain, src = gatv2_attention, gatv2_attention_reference, idx
        args = (xl, xr, idx, mask, att, bias, heads)
    else:
        op, plain = banded_edge_stage, banded_edge_stage_reference
        src = lo.long().repeat_interleave(BLOCK)[:, None] + idx
        args = (xl, xr, lo, idx, mask, att, bias, heads)
    name, dt = op.__name__, xl.dtype
    n, k = idx.shape
    launches = op.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = op(*args)
    # device memory the call took beyond what it returns (scratch, copies)
    extra_bytes = (torch.cuda.max_memory_allocated()
                   - torch.cuda.memory_allocated())
    if op.launches != launches + 1:
        raise AssertionError(f"{name}: {op.launches - launches} launches")
    ref = plain(*args)
    torch.cuda.synchronize()
    # as K1: f32 one arithmetic, other summation order; bf16 an f32 sum
    # may round to a neighbouring bf16 value of the output
    tol = 1e-5 if dt == torch.float32 else 2e-2
    err = (out.float() - ref.float()).abs()
    if not (torch.isfinite(out.float()).all()
            and (err <= tol + tol * ref.float().abs()).all()):
        raise AssertionError(f"{name} K={k} {dt}: err {err.max().item()}")
    empty = ~mask.any(1)
    if not torch.equal(out[empty], bias.to(dt).expand(int(empty.sum()), -1)):
        raise AssertionError(f"{name}: empty rows are not the bias")
    ms = cuda_ms(lambda: op(*args), 50)
    dev_ms = device_ms(lambda: op(*args), 20, "attn_fwd_kernel")
    gr_ms = graph_ms(lambda: op(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 3)
    op.launches = launches                 # the checks do not count
    size, hc = xl.element_size(), xl.shape[1]
    n_valid = int(mask.sum())
    # idx, mask, the source rows the valid slots name, xr and out (+ lo)
    n_bytes = _row_bytes(src, mask, hc, size) + 2 * n * hc * size
    if lo is not None:
        n_bytes += lo.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, n_valid * hc * 8)
    return {"n": n, "k": k, "dtype": str(dt).split(".")[-1],
            "max_abs_err": err.max().item(),
            "tol": f"atol {tol} rtol {tol}, empty rows equal the bias",
            "ms": ms, "device_ms": dev_ms, "graph_ms": gr_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by, "bytes": n_bytes, "valid_slots": n_valid,
            "empty_rows": int(empty.sum()),
            "extra_bytes": extra_bytes}, out


def strip_major_table(graph):
    """The slide-wide tt table as ``tools/banded_retest.py`` builds it:
    the transcripts in strip-major order, kNN k=5 within 5 um (the
    slide's own settings), padded to K = 8; then ``band_graph`` over it.
    Returns the order, the table, the banded table, the widest block
    span in rows and band_graph's host seconds."""
    import numpy as np

    from segger_tpu_torch.data.neighbors_host import kdtree_neighbors
    from segger_tpu_torch.data.partition import _strip_major_order
    from segger_tpu_torch.ops.banded import BLOCK, band_graph
    from segger_tpu_torch.ops.padded_csr import coo_to_padded_csr

    order = _strip_major_order(graph.tx_pos)
    src, dst = kdtree_neighbors(graph.tx_pos[order], max_k=5, max_dist=5.0)
    csr = coo_to_padded_csr(dst, src, n_dst=graph.n_tx, pad_to_multiple=8)
    t0 = time.perf_counter()
    lo, idxl, mask, ok = band_graph(csr, n_src=graph.n_tx)
    band_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("band_graph refused the strip-major slide")
    blk_i = idxl.reshape(-1, BLOCK * idxl.shape[1])
    blk_m = mask.reshape(blk_i.shape)
    span = (np.where(blk_m, blk_i, -1).max(1)
            - np.where(blk_m, blk_i, 1 << 30).min(1) + 1)
    return order, csr, (lo, idxl, mask), int(span[blk_m.any(1)].max()), \
        band_s


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
    # the pass's K1 and K5 launches, which the table may rank below its
    # cut
    kernels = {}
    for tag, name in (("K1", "edge_stage_fwd_kernel"),
                      ("K5", "score_max_kernel")):
        es = [e for e in events if e.device_type == DeviceType.CUDA
              and name in e.key]
        kernels[tag] = (sum(e.self_device_time_total for e in es) / 1e3,
                        sum(e.count for e in es))
    line = (f"profile: host extraction {extract:.3f} s for {len(plans)} "
            f"batches; warm predict wall {wall:.3f} s (runs {walls}); "
            f"device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / 1e3 / wall:.4f}; " + ", ".join(
                f"{tag} {ms:.4f} ms in {n} launches"
                for tag, (ms, n) in kernels.items()))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"{line}\n{table}\n")
    print(line)
    print(f"profile table in {path}")


def profile_train_step(trainer, plan, path: Path):
    """One compiled training step (the staging of its batch and random
    numbers, the graph's replay and the read-back of its loss row) under
    torch.profiler: device time by kernel and the device's busy share of
    the step's wall time.  Then the device time of one optimizer step of
    a capturable Adam, foreach and fused, over the trainer's parameters
    and gradients."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, gen = trainer.epoch_streams(0)
    weights = trainer.weights(0, TRAIN_EPOCHS)
    batch = trainer._build_batch(plan, cache=False)

    def one_step():
        step = trainer._step("train", batch)
        trainer._stage(step, batch, gen, weights)
        return trainer._run("train", step).tolist()

    one_step()                           # warm; the fit captured the graph
    torch.cuda.synchronize()
    # where a step's wall goes: the host staging, queueing the replay,
    # then waiting for the loss row (the device finishing the graph)
    parts = []
    for _ in range(10):
        t = [time.perf_counter()]
        step = trainer._step("train", batch)
        trainer._stage(step, batch, gen, weights)
        t.append(time.perf_counter())
        row = trainer._run("train", step)
        t.append(time.perf_counter())
        row.tolist()
        t.append(time.perf_counter())
        parts.append(np.diff(t) * 1e3)
    stage_ms, queue_ms, wait_ms = np.median(parts, axis=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    step_line = (
        f"train profile: one graphed step (staging and read-back included) "
        f"wall {wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms in "
        f"{sum(e.count for e in device)} device events, idle share "
        f"{1 - busy_ms / 1e3 / wall:.4f}; unprofiled, medians of 10 "
        f"steps: staging {stage_ms:.3f} ms, queueing the replay "
        f"{queue_ms:.3f} ms, waiting for the loss row {wait_ms:.3f} ms")
    print(step_line)
    # the optimizer step alone, on the gradients of one eager step: the
    # device time of every activity 20 warm steps launch, over 20
    trainer.train_step(batch.to("cuda"), gen, weights)
    params = [p for g in trainer.optimizer.param_groups
              for p in g["params"]]
    adam = {}
    for name, fused in (("capturable foreach", False),
                        ("capturable fused", True)):
        opt = torch.optim.Adam(params, lr=trainer.cfg.learning_rate,
                               capturable=True, fused=fused)
        for _ in range(3):
            opt.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                opt.step()
            torch.cuda.synchronize()
        acts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation]
        adam[name] = (sum(e.self_device_time_total for e in acts) / 20e3,
                      sum(e.count for e in acts) / 20)
    line = ("Adam device time a step: " + ", ".join(
        f"{name} {ms:.4f} ms in {n:g} device events"
        for name, (ms, n) in adam.items())
        + f" (the trainer's: fused={trainer.optimizer.defaults['fused']})")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"{step_line}\n{line}\n{table}\n")
    print(line)
    print(f"profile table in {path}")


def reset_counts():
    from segger_tpu_torch.ops.banded import banded_edge_stage
    from segger_tpu_torch.ops.gatv2_attn import gatv2_attention
    from segger_tpu_torch.ops.postgather import (
        MODES, edge_stage_bwd, edge_stage_fwd,
    )
    from segger_tpu_torch.ops.score import score_max

    edge_stage_fwd.launches = dict.fromkeys(MODES, 0)
    edge_stage_bwd.launches = dict.fromkeys(MODES, 0)
    score_max.launches = 0
    gatv2_attention.launches = 0
    banded_edge_stage.launches = 0


def read_counts() -> dict:
    from segger_tpu_torch.ops.banded import banded_edge_stage
    from segger_tpu_torch.ops.gatv2_attn import gatv2_attention
    from segger_tpu_torch.ops.postgather import edge_stage_bwd, edge_stage_fwd
    from segger_tpu_torch.ops.score import score_max

    return {"fwd": dict(edge_stage_fwd.launches),
            "bwd": dict(edge_stage_bwd.launches),
            "score": score_max.launches,
            "attn": gatv2_attention.launches,
            "banded": banded_edge_stage.launches}


def first_tile(trainer, plan):
    """The first tile of one batch plan, built on the trainer's device."""
    return trainer._build_batch(plan, cache=False).to(
        trainer.device).map_arrays(lambda a: a[0])


def tile_tables(tile) -> list:
    """One layer's edge-stage launches on a tile, named: its tt degree
    segments, then tb."""
    from segger_tpu_torch.models.encoder import tt_segments

    segs = [(f"tt[{a}:{b}]", i, m) for a, b, i, m, _ in tt_segments(tile)]
    segs.append(("tb", tile.tb.idx, tile.tb.mask))
    return segs


def expected_launches(trainer, caps, steps=0, epochs=0, fit_plans=(),
                      val_plans=(), pplans=()) -> dict:
    """The launches of ``steps`` training steps over ``fit_plans``'
    bucket, ``epochs`` validation passes over ``val_plans`` and one
    predict over ``pplans``, where ``caps`` counts the CUDA-graph captures
    they made.  Every tile of a batch launches K1 (K2 and K3 when it
    trains) once for each of ``tile_tables`` in each layer, and a
    predicted tile K5 once; each replay and each capture's warm-up batch
    launch, a capture itself nothing."""
    cfg = trainer.cfg
    n_layers = 2 + cfg.n_mid_layers
    tps = cfg.tiles_per_step

    def per_tile(plans):
        return n_layers * len(tile_tables(first_tile(trainer, plans[0]))) \
            if plans else 0

    n_fit = (steps + caps["train"]) * tps * per_tile(fit_plans)
    n_val = (epochs * len(val_plans) + caps["eval"]) * tps
    n_pred = sum(len(s) for s, _ in pplans) + caps["predict"] * tps
    return {"fwd": {"nokeep": n_val * per_tile(val_plans)
                    + n_pred * per_tile(pplans), "prng": n_fit, "keep": 0},
            "bwd": {"nokeep": 0, "prng": n_fit, "keep": 0},
            "score": n_pred, "attn": 0, "banded": 0}


def drive_keep_op(tile, heads, hc, dtype, rng):
    """K4's own path: the differentiable edge-stage op in keep mode,
    forward and backward, on each launch of one layer of a training
    tile (its tt segments with their transpose tables, and tb)."""
    import torch

    from segger_tpu_torch.models.encoder import tt_segments
    from segger_tpu_torch.ops.postgather import gatv2_edge_stage

    segs = [(a, b, i, m, t) for a, b, i, m, t in tt_segments(tile)]
    segs.append((0, tile.n_bd, tile.tb.idx, tile.tb.mask, tile.tb_t))
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1e9)))
    for si, (a, b, idx, mask, csr_t) in enumerate(segs):
        n_dst = tile.n_bd if si == len(segs) - 1 else tile.n_tx
        xl = torch.randn(tile.n_tx, hc, generator=gen, device="cuda").to(
            dtype).requires_grad_()
        xr = torch.randn(n_dst, hc, generator=gen, device="cuda").to(
            dtype).requires_grad_()
        att = torch.randn(heads, hc // heads, generator=gen,
                          device="cuda").to(dtype).requires_grad_()
        n, k = idx.shape
        keep = ((torch.rand(n, k, heads, generator=gen, device="cuda")
                 >= DROPOUT) / (1 - DROPOUT)).to(dtype).requires_grad_()
        out = gatv2_edge_stage(xl, xr[a:b], att, idx, mask, heads,
                               csr_t=csr_t, keep=keep)
        out.float().square().sum().backward()
        for t in (xl, xr, att, keep):
            if not torch.isfinite(t.grad.float()).all():
                raise AssertionError("keep-mode op: non-finite gradient")
    torch.cuda.synchronize()
    return len(segs)


def _accuracy(row_index, cell_id, truth, rows=None) -> float:
    """Share of the transcripts that truly belong to a cell (and lie in
    ``rows``, when given) whose assigned cell id is their own."""
    import numpy as np

    t = truth[row_index]
    keep = t != ""
    if rows is not None:
        keep &= np.isin(row_index, rows)
    return float((cell_id[keep] == t[keep]).mean())


def pipeline_slide(n_cells=PIPE_CELLS, n_genes=PIPE_GENES,
                   tx_per_cell=PIPE_TX_PER_CELL):
    """Phases 7 and 8's slide: ``make_synthetic`` at constant density."""
    import numpy as np

    from segger_tpu_torch.data.synthetic import make_synthetic

    return make_synthetic(n_cells=n_cells, n_genes=n_genes,
                          mean_tx_per_cell=tx_per_cell,
                          extent=400.0 * float(np.sqrt(n_cells / 200)),
                          seed=SEED)


def run_launches(pipe, tr, epochs):
    """The launches a fit of ``epochs`` and one predict by ``tr`` over
    ``pipe``'s graph and tiling made on CUDA, counted as phases 3 and 4
    count them, with the run's tiles and batch plans."""
    from segger_tpu_torch.data.partition import (
        make_fit_tiles, make_predict_tiles,
    )

    g, tree = pipe.graph, pipe.tree
    fit_tiles = make_fit_tiles(g, tree,
                               margin=pipe.cfg.tiling_margin_training)
    ptiles = make_predict_tiles(g, tree,
                                margin=pipe.cfg.tiling_margin_prediction)
    train_tiles, val_tiles = tr.split_tiles(fit_tiles)
    val_plans = tr._batch_plans(val_tiles)
    fit_plans = tr._batch_plans(train_tiles, shuffle=True,
                                rng=tr.epoch_streams(0)[0])
    pplans = tr._batch_plans(ptiles, use_xlo=True)
    want = expected_launches(tr, dict(tr.captures), steps=len(tr.step_log),
                             epochs=epochs, fit_plans=fit_plans,
                             val_plans=val_plans, pplans=pplans)
    return want, {"fit_tiles": fit_tiles, "ptiles": ptiles,
                  "fit_plans": fit_plans, "pplans": pplans}


def check_table(seg, g, truth, where) -> dict:
    """A segmentation table against its graph and the true cells: one row
    per transcript, a cell for exactly the transcripts with a candidate
    edge, accuracy above ``MIN_ACCURACY``.  Returns the accuracies (also
    on the transcripts with two or more candidate cells) and the counts
    of transcripts with one and with two or more candidates."""
    import numpy as np
    import pandas as pd

    rows = seg["row_index"].to_numpy()
    ids = seg["segger_cell_id"].to_numpy(object)
    n_cand = np.bincount(g.cand_src, minlength=g.n_tx)
    with_cand = np.sort(g.tx_index[n_cand > 0])
    multi = g.tx_index[n_cand >= 2]
    acc = _accuracy(rows, ids, truth)
    if not (seg["row_index"].is_unique
            and np.array_equal(np.sort(rows), np.sort(g.tx_index))):
        raise AssertionError(f"{where}: not one row per transcript")
    if not np.array_equal(np.sort(rows[pd.notna(ids)]), with_cand):
        raise AssertionError(f"{where}: the transcripts with a cell are "
                             "not those with a candidate edge")
    if not acc > MIN_ACCURACY:
        raise AssertionError(f"{where} accuracy {acc} <= {MIN_ACCURACY}")
    return {"accuracy": acc,
            "accuracy_multi": _accuracy(rows, ids, truth, multi),
            "multi": multi, "n_with_cand": with_cand.size}


def table_quality(seg, synth) -> dict:
    """The port's ``segmentation_report`` of a segmentation table against
    the true cells, and the contamination QC of its cells: an in-memory
    ``AnnDataLite`` of the table (``build_anndata``, each cell labelled
    with its synthetic expression program), a reference from
    ``expression_summary_from_anndata`` on it, ``calculate_contamination``
    and the median of ``percent_contamination``.  Host only, no h5py."""
    import numpy as np
    import pandas as pd

    from segger_tpu_torch.export.anndata_writer import build_anndata
    from segger_tpu_torch.metrics import segmentation_report
    from segger_tpu_torch.validation import (
        calculate_contamination, expression_summary_from_anndata,
    )

    t0 = time.perf_counter()
    truth = pd.Series(np.asarray(synth.truth_cell, dtype=object))
    truth[truth == ""] = None
    report = segmentation_report(seg, truth)
    report_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tx = synth.transcripts.set_index("row_index").loc[
        seg["row_index"].to_numpy()]
    ad = build_anndata(pd.DataFrame({
        "segger_cell_id": seg["segger_cell_id"].astype(object).to_numpy(),
        "feature_name": tx["feature_name"].to_numpy(),
        "x": tx["x"].to_numpy(), "y": tx["y"].to_numpy()}))
    cell = ad.obs.index.to_numpy().astype(str)
    ad.obs["cell_type"] = [f"type_{synth.cell_type[int(c[5:])]}"
                           for c in cell]
    ad.layers["counts"] = ad.X
    reference = expression_summary_from_anndata(ad, "cell_type", "counts")
    calculate_contamination(ad, reference, counts_layer="counts",
                            spatial_key="X_spatial", cell_type_key="cell_type")
    pc = ad.obs["percent_contamination"].to_numpy()
    return {"report": report, "report_s": report_s,
            "contamination_s": time.perf_counter() - t0,
            "cells": int(ad.n_obs),
            "median_percent_contamination": float(np.median(pc)),
            "mean_percent_contamination": float(pc.mean())}


def drive_pipeline(out_dir, device=None, n_cells=PIPE_CELLS,
                   n_genes=PIPE_GENES, epochs=PIPE_EPOCHS,
                   tx_per_cell=PIPE_TX_PER_CELL, pipeline_kw=None,
                   train_kw=None) -> dict:
    """Phase 7: segment a ``make_synthetic`` slide through
    ``ISTPipeline.run`` (features, whole-slide graph, tiles, fit, predict,
    the segmentation table) with the kernel counts set to 0 just before
    the run and read just after, then check the table: accuracy against
    the true cells, one row per transcript, a cell for exactly the
    transcripts with a candidate edge, and ``predict_streaming`` +
    ``write_dense`` equal to the run's ``predict`` + ``write``.  Returns
    the walls, the counts with the launches the run must have made on
    CUDA, the accuracies on transcripts with two or more candidate
    cells after training and with the initial weights, and the graph."""
    import numpy as np
    import pandas as pd
    import torch

    from segger_tpu_torch.data.writer import SegmentationWriter
    from segger_tpu_torch.pipeline import ISTPipeline, PipelineConfig
    from segger_tpu_torch.train.trainer import TrainConfig

    cuda = device is None or torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    synth = pipeline_slide(n_cells, n_genes, tx_per_cell)
    walls = {"make-data": time.perf_counter() - t0}
    pipe = ISTPipeline(synth.transcripts, synth.boundaries, synth.polygons,
                       PipelineConfig(seed=SEED, **(pipeline_kw or {})))
    cfg = TrainConfig(max_epochs=epochs, **(train_kw or {}))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    reset_counts()
    seg = pipe.run(out_dir, cfg, save_anndata=False, device=device)
    if cuda:
        torch.cuda.synchronize()
    counts = read_counts()
    # the run's own peak, above what the caller held before it
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
        else None
    walls.update(pipe.walls)
    g, tr = pipe.graph, pipe.trainer
    caps = dict(tr.captures)
    want, run = run_launches(pipe, tr, epochs)
    ptiles = run["ptiles"]

    # the table, its quality report and its contamination QC
    truth = np.asarray(synth.truth_cell)   # by row_index
    table = check_table(seg, g, truth, "pipeline")
    multi = table["multi"]
    quality = table_quality(seg, synth)

    # predict_streaming + write_dense on the same trainer
    t0 = time.perf_counter()
    best_sim, best_enc = tr.predict_streaming(ptiles)
    gene_by_row = np.zeros(best_sim.size, np.int32)
    gene_by_row[g.tx_index] = g.tx_gene
    dense = SegmentationWriter(Path(out_dir) / "dense",
                               save_anndata=False).write_dense(
        best_sim, best_enc, gene_by_row, cell_ids=g.bd_cell_id,
        gene_names=pipe.adata.var.index.to_numpy().astype(str))
    stream_s = time.perf_counter() - t0
    a = seg.sort_values("row_index").reset_index(drop=True)
    b = dense.sort_values("row_index").reset_index(drop=True)
    ca = a["segger_cell_id"].astype(object).to_numpy()
    cb = b["segger_cell_id"].astype(object).to_numpy()
    na = pd.isna(ca)
    if not (len(a) == len(b) > 0
            and (a["row_index"].to_numpy() == b["row_index"].to_numpy()).all()
            and (na == pd.isna(cb)).all() and (ca[~na] == cb[~na]).all()
            and np.allclose(a["segger_similarity"], b["segger_similarity"],
                            rtol=1e-6, atol=0)
            and np.allclose(a["similarity_threshold"],
                            b["similarity_threshold"], rtol=1e-6, atol=1e-9)
            and (a["converged"].to_numpy() == b["converged"].to_numpy()).all()
            and (a["segger_gene"].astype(object).to_numpy()
                 == b["segger_gene"].astype(object).to_numpy()).all()):
        raise AssertionError("pipeline: write_dense differs from write")

    # the trained weights, for phase 10, before the initial ones
    state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    # the same prediction with the initial weights
    tr.init()
    p0 = tr.predict(ptiles)
    enc0 = p0["cell_encoding"].astype(np.int64)
    ids0 = np.where(enc0 >= 0, g.bd_cell_id[np.maximum(enc0, 0)], None)
    acc0_multi = _accuracy(p0["row_index"].astype(np.int64), ids0, truth,
                           multi)
    return {"walls": walls, "stream_s": stream_s, "counts": counts,
            "want": want, "captures": caps, "peak_mib": peak,
            "table": seg[["row_index", "segger_cell_id"]],
            "n_tx": g.n_tx, "n_bd": g.n_bd, "n_tt": int(g.tt_src.size),
            "n_cand": int(g.cand_src.size),
            "n_with_cand": table["n_with_cand"],
            "n_multi": int(multi.size),
            "n_tiles": (len(run["fit_tiles"]), len(ptiles)),
            "epochs": epochs, "steps": len(tr.step_log),
            "history": tr.history, "accuracy": table["accuracy"],
            "accuracy_multi": table["accuracy_multi"],
            "accuracy_multi_init": acc0_multi, "graph": g,
            "tree": pipe.tree, "quality": quality,
            "state": state, "truth": truth,
            # the first predict and training tiles, for the kernel checks
            "cfg": tr.cfg, "tiles": (first_tile(tr, run["pplans"][0]),
                                     first_tile(tr, run["fit_plans"][0]))}


def cli_flags(kw) -> list:
    """``{"tiling_nodes_per_tile": 600}`` -> the command's flags."""
    return [a for k, v in (kw or {}).items()
            for a in ("--" + k.replace("_", "-"), str(v))]


def same_graph(a, b, where) -> None:
    """Every integer array of two HostGraphs equal, every float array
    within 1e-6."""
    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not isinstance(x, np.ndarray):
            if x != y:
                raise AssertionError(f"{where}: {f.name} {x} != {y}")
            continue
        same = x.shape == y.shape and x.dtype == y.dtype and (
            np.allclose(x, y, rtol=0, atol=1e-6) if x.dtype.kind == "f"
            else np.array_equal(x, y))
        if not same:
            raise AssertionError(f"{where}: graph array {f.name} differs")


def drive_cli(work_dir, device=None, n_cells=PIPE_CELLS, n_genes=PIPE_GENES,
              epochs=PIPE_EPOCHS, tx_per_cell=PIPE_TX_PER_CELL,
              pipeline_kw=None, train_kw=None, graph=None) -> dict:
    """Phase 8: the command line users run.  Writes phase 7's slide as a
    raw Xenium v2 directory (``write_xenium_like``), runs ``segger-tpu-
    torch segment`` on it in this process (``--no-anndata``, the kernel
    counts set to 0 just before and read just after), then ``export
    transcripts boundaries`` on its output.  Checks that the graph the
    command built from the vendor files equals ``graph`` (phase 7's, from
    the in-memory tables; integer arrays exactly, floats within 1e-6), the
    table as phase 7 does, and that the exported boundaries have a ring of
    three or more vertices for more than 90 % of the cells export kept.
    Returns the walls by stage, the counts with the launches the run must
    have made on CUDA, and the boundary pools the export started."""
    import numpy as np
    import pandas as pd
    import torch

    from segger_tpu_torch.cli.main import main as cli
    from segger_tpu_torch.cli.segment import run_segment
    from segger_tpu_torch.data.synthetic import write_xenium_like
    from segger_tpu_torch.export.boundary import generate_boundaries

    work = Path(work_dir)
    synth = pipeline_slide(n_cells, n_genes, tx_per_cell)
    t0 = time.perf_counter()
    raw = write_xenium_like(work / "xenium", synth)
    walls = {"write-vendor": time.perf_counter() - t0}
    out = work / "out"
    reset_counts()
    # --devices 1: the tiled path runs on one card, also on a host of
    # several (where the default, every card, is refused)
    code = cli(["segment", "-i", str(raw), "-o", str(out), "--no-anndata",
                "--max-epochs", str(epochs), "--seed", str(SEED),
                "--devices", "1",
                *(["--device", device] if device else []),
                *cli_flags(pipeline_kw), *cli_flags(train_kw)])
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    if code != 0:
        raise AssertionError(f"segment exited {code}")
    last = run_segment.last_run
    run_segment.last_run = None     # the trainer's device memory goes
    pipe, tr = last["pipeline"], last["trainer"]
    walls.update(last["walls"])
    g = pipe.graph
    if graph is not None:
        same_graph(g, graph, "cli")
    want, run = run_launches(pipe, tr, epochs)
    seg = pd.read_parquet(out / "segger_segmentation.parquet")
    table = check_table(seg, g, np.asarray(synth.truth_cell), "cli")

    pools = dict(generate_boundaries.pools)
    t0 = time.perf_counter()
    code = cli(["export", "-i", str(raw), "-s", str(out), "-o",
                str(out / "export"), "transcripts", "boundaries"])
    walls["export-boundaries"] = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"export exited {code}")
    pools = {k: v - pools[k] for k, v in generate_boundaries.pools.items()}
    kept = pd.read_parquet(out / "export" / "segger_transcripts.parquet")
    n_kept = kept["segger_cell_id"].nunique()
    rings = pd.read_parquet(out / "export" / "segger_boundaries.parquet")
    n_rings = int((rings.groupby("cell_id").size() >= 3).sum())
    if not n_rings > 0.9 * n_kept:
        raise AssertionError(f"export: {n_rings} rings of 3 or more "
                             f"vertices for {n_kept} kept cells")
    return {"walls": walls, "counts": counts, "want": want,
            "captures": dict(tr.captures), "pools": pools,
            "n_tx": g.n_tx, "n_bd": g.n_bd, "epochs": epochs,
            "steps": len(tr.step_log), "n_tiles": (len(run["fit_tiles"]),
                                                   len(run["ptiles"])),
            "accuracy": table["accuracy"], "n_kept": int(n_kept),
            "n_rings": n_rings, "history": tr.history}


# phase 9's columnar graph against phase 7's (tests/test_columnar.py's
# fields and tolerances)
GRAPH_INT_FIELDS = ("tx_gene", "tx_cluster", "tx_index", "tx_cell_encoding",
                    "bd_cluster", "bd_index", "bd_cell_id", "tt_src",
                    "tt_dst", "sg_src", "sg_dst", "cand_src", "cand_dst")
GRAPH_FLOAT_FIELDS = ("tx_pos", "bd_x", "bd_pos", "gene_embedding",
                      "tx_similarity", "bd_similarity")
COLUMNAR_CHUNKS = 7               # phase 9's slide goes in as 7 chunks
MIN_TABLE_AGREEMENT = 0.99        # phase 9's table vs phase 7's


def columnar_graph_equal(a, b, where) -> None:
    """The integer fields of two HostGraphs equal, the float fields within
    rtol 1e-6, atol 1e-7."""
    import numpy as np

    for name in GRAPH_INT_FIELDS:
        if not np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))):
            raise AssertionError(f"{where}: graph array {name} differs")
    for name in GRAPH_FLOAT_FIELDS:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if not (x.shape == y.shape
                and np.allclose(x, y, rtol=1e-6, atol=1e-7)):
            raise AssertionError(f"{where}: graph array {name} differs")


def gb(x) -> str:
    """A memory reading in GB, or why there is none."""
    return "not reported by this kernel" if x is None else f"{x:.3f} GB"


def frame_chunks(df, n):
    """``df`` in ``n`` consecutive row chunks."""
    import numpy as np

    edges = np.linspace(0, len(df), n + 1).astype(int)
    for a, b in zip(edges[:-1], edges[1:]):
        yield df.iloc[a:b]


def run_plane(plane_dir, gene_names, out_dir, pcfg, tcfg,
              device=None) -> dict:
    """The run phase of the out-of-core path: the graph plane in
    ``plane_dir`` loaded memmapped, tiled at ``pcfg``, fit at ``tcfg`` on
    its margin tiles, predicted by ``predict_streaming`` and written by
    ``write_dense``, with the kernel counts set to 0 just before the fit
    and read just after the write.  Returns the walls by stage, the graph,
    the table, the counts with the launches the run must have made on
    CUDA, the peak device memory (MiB above what the caller held), the
    trainer and its first predict and training tiles."""
    import types

    import numpy as np
    import torch

    from segger_tpu_torch.data.assemble import load_host_graph_plane
    from segger_tpu_torch.data.partition import (
        build_tiling, make_fit_tiles, make_predict_tiles,
    )
    from segger_tpu_torch.data.writer import SegmentationWriter
    from segger_tpu_torch.train.trainer import SeggerTrainer

    walls = {}
    t0 = time.perf_counter()
    g = load_host_graph_plane(plane_dir, mmap=True)
    tree = build_tiling(g, nodes_per_tile=pcfg.tiling_nodes_per_tile,
                        mode=pcfg.tiling_mode,
                        side_length=pcfg.tiling_side_length)
    walls["load-plane"] = time.perf_counter() - t0
    tr = SeggerTrainer(g, tcfg, device=device)
    cuda = tr.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    tr.fit(make_fit_tiles(g, tree, margin=pcfg.tiling_margin_training))
    walls["fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    best_sim, best_enc = tr.predict_streaming(make_predict_tiles(
        g, tree, margin=pcfg.tiling_margin_prediction))
    walls["predict"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gene_by_row = np.zeros(best_sim.size, np.int32)
    gene_by_row[g.tx_index] = g.tx_gene
    seg = SegmentationWriter(out_dir, save_anndata=False).write_dense(
        best_sim, best_enc, gene_by_row, cell_ids=g.bd_cell_id,
        gene_names=gene_names)
    walls["write"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20 if cuda \
        else None
    want, run = run_launches(
        types.SimpleNamespace(graph=g, tree=tree, cfg=pcfg), tr,
        tcfg.max_epochs)
    return {"walls": walls, "graph": g, "table": seg, "counts": counts,
            "want": want, "captures": dict(tr.captures), "peak_mib": peak,
            "trainer": tr, "steps": len(tr.step_log),
            "history": tr.history,
            "n_tiles": (len(run["fit_tiles"]), len(run["ptiles"])),
            "tiles": (first_tile(tr, run["pplans"][0]),
                      first_tile(tr, run["fit_plans"][0]))}


def table_agreement(a, b) -> float:
    """Share of the rows of table ``a`` whose cell id (or its absence)
    equals table ``b``'s for the same ``row_index``."""
    import numpy as np
    import pandas as pd

    ia = pd.Series(a["segger_cell_id"].astype(object).to_numpy(),
                   index=a["row_index"].to_numpy())
    ib = pd.Series(b["segger_cell_id"].astype(object).to_numpy(),
                   index=b["row_index"].to_numpy())
    ib = ib.reindex(ia.index)
    x, y = ia.to_numpy(), ib.to_numpy()
    both_na = pd.isna(x) & pd.isna(y)
    same = np.array([u == v for u, v in zip(x, y)], dtype=bool)
    return float((both_na | (same & ~pd.isna(x))).mean())


def canonical_edges(src, dst):
    import numpy as np

    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    o = np.lexsort((dst, src))
    return np.stack([src[o], dst[o]])


def graph_stage_branches(synth, graph, pcfg) -> dict:
    """Phase 9 (d): the graph stage's tx kNN and candidate join on
    ``graph``'s transcripts and ``synth``'s prediction polygons, through
    the native core (the pipeline's path) and through the KDTree plain
    versions, each inside its ``graph.tx_knn`` / ``graph.prediction``
    substage.  The edge sets must be equal, and the native ones equal
    ``graph``'s own.  Returns both branches' substage walls."""
    import numpy as np

    from segger_tpu_torch.data.neighbors_host import (
        kdtree_neighbors, polygon_areas_batch, prediction_graph,
    )
    from segger_tpu_torch.geometry.query import points_in_polygons_kdtree
    from segger_tpu_torch.io.fields import StandardBoundaryFields
    from segger_tpu_torch.utils_profiling import (
        StageTimer, set_substage_timer, substage,
    )

    bd_f = StandardBoundaryFields()
    btype = (bd_f.cell_value if pcfg.prediction_graph_mode == "cell"
             else bd_f.nucleus_value)
    by_id = {cid: p for (cid, b), p in synth.polygons.items() if b == btype}
    rows = np.array([r for r, c in enumerate(graph.bd_cell_id)
                     if c in by_id], np.int64)
    polys = [np.asarray(by_id[graph.bd_cell_id[r]]) for r in rows]
    pos = np.asarray(graph.tx_pos)
    k, dist = pcfg.transcripts_graph_max_k, pcfg.transcripts_graph_max_dist
    buffers = (np.sqrt(np.maximum(polygon_areas_batch(polys), 0) / np.pi)
               * pcfg.prediction_graph_buffer_ratio)
    walls, edges = {}, {}
    for branch in ("native", "kdtree"):
        timer = StageTimer()
        prev = set_substage_timer(timer)
        try:
            with substage("graph.tx_knn"):
                tt = kdtree_neighbors(pos, max_k=k, max_dist=dist,
                                      backend=branch)
            with substage("graph.prediction"):
                if branch == "native":
                    cand = prediction_graph(
                        pos, graph.bd_pos, mode=pcfg.prediction_graph_mode,
                        max_k=pcfg.prediction_graph_max_k,
                        buffer_ratio=pcfg.prediction_graph_buffer_ratio,
                        polygons=polys)
                else:
                    cand = points_in_polygons_kdtree(pos, polys,
                                                     distances=buffers)
        finally:
            set_substage_timer(prev)
        walls[branch] = dict(timer.seconds)
        edges[branch] = (canonical_edges(*tt),
                         canonical_edges(cand[0], rows[cand[1]]))
    for name, i in (("tt", 0), ("cand", 1)):
        if not np.array_equal(edges["native"][i], edges["kdtree"][i]):
            raise AssertionError(f"native and KDTree {name} edge sets "
                                 "differ")
    if not (np.array_equal(edges["native"][0],
                           canonical_edges(graph.tt_src, graph.tt_dst))
            and np.array_equal(edges["native"][1], canonical_edges(
                graph.cand_src, graph.cand_dst))):
        raise AssertionError("the native branches' edges are not the "
                             "pipeline graph's")
    return {"walls": walls, "n_tt": int(edges["native"][0].shape[1]),
            "n_cand": int(edges["native"][1].shape[1])}


def neighbor_count_branches(A) -> dict:
    """Common-neighbor counts of every edge of the CSR graph ``A``, by the
    native sorted merge (the pipeline's path) and by its plain version,
    the blocked SpGEMM (``data.clustering``): the counts must be equal.
    Returns both walls."""
    import numpy as np

    from segger_tpu_torch import native
    from segger_tpu_torch.data import clustering

    coo = A.tocoo()
    native.load()               # the build is not part of the wall
    t0 = time.perf_counter()
    a = clustering.common_neighbor_counts_spgemm(A.indptr, A.indices,
                                                 coo.row, coo.col)
    t_spgemm = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = native.common_neighbor_counts(A.indptr, A.indices, coo.row, coo.col)
    t_native = time.perf_counter() - t0
    if not np.array_equal(a, b):
        raise AssertionError("native and SpGEMM common-neighbor counts "
                             "differ")
    return {"spgemm_s": t_spgemm, "native_s": t_native, "n": A.shape[0],
            "edges": int(A.nnz)}


def graph_digest(graph) -> str:
    """SHA-256 over every field of a HostGraph: name, dtype, shape,
    bytes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for f in dataclasses.fields(graph):
        a = np.ascontiguousarray(getattr(graph, f.name))
        h.update(f"{f.name} {a.dtype.str} {a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


_PREPARE = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
from segger_tpu_torch.cli.main import main
from segger_tpu_torch.cli.segment import run_segment
rc = main({argv!r})
import torch
last = run_segment.last_run
print(json.dumps({{"rc": rc, "cuda_initialized": torch.cuda.is_initialized(),
                  "walls": last["walls"],
                  "graph": chip_smoke.graph_digest(last["graph"])}}))
"""


def drive_outofcore(work_dir, device=None, n_cells=PIPE_CELLS,
                    n_genes=PIPE_GENES, epochs=PIPE_EPOCHS,
                    tx_per_cell=PIPE_TX_PER_CELL, pipeline_kw=None,
                    train_kw=None, graph=None, table=None) -> dict:
    """Phase 9: the out-of-core whole-slide path on phase 7's slide.

    (a) the slide's DataFrame as ``ColumnarTranscripts.from_chunks`` in
    ``COLUMNAR_CHUNKS`` chunks, spooled under ``work_dir``, through
    ``ISTPipeline(...).load()``: the graph must equal ``graph`` (phase
    7's; ``GRAPH_INT_FIELDS`` exactly, ``GRAPH_FLOAT_FIELDS`` within rtol
    1e-6, atol 1e-7);
    (b) that graph saved as a plane and run by :func:`run_plane` (fit,
    ``predict_streaming``, ``write_dense``): the table passes
    ``check_table`` and agrees with ``table`` (phase 7's) on at least
    ``MIN_TABLE_AGREEMENT`` of the transcripts;
    (c) the slide as a raw MERSCOPE directory through ``segment
    --low-memory --graph-cache C --prepare-only`` in a child process,
    which must initialize no CUDA, then ``segment --low-memory
    --graph-cache C`` in this process, which must load the plane (no read,
    no build), use the graph the prepare run built (equal digests) and
    pass ``check_table``;
    (d) :func:`graph_stage_branches` on phase 7's graph and
    :func:`neighbor_count_branches` on the kNN graph of its cell
    embeddings.

    Returns the walls and substage walls, the peak and anonymous RSS, the
    counts with the launches each run must have made on CUDA, and (b)'s
    first tiles."""
    import json as _json
    import types

    import numpy as np
    import pandas as pd
    import torch

    from segger_tpu_torch.cli.main import main as cli
    from segger_tpu_torch.cli.segment import run_segment
    from segger_tpu_torch.data.assemble import save_host_graph_plane
    from segger_tpu_torch.data.clustering import knn_adjacency
    from segger_tpu_torch.data.columnar import ColumnarTranscripts
    from segger_tpu_torch.data.partition import build_tiling
    from segger_tpu_torch.data.synthetic import write_merscope_like
    from segger_tpu_torch.pipeline import ISTPipeline, PipelineConfig
    from segger_tpu_torch.train.trainer import TrainConfig
    from segger_tpu_torch.utils import peak_rss_gb
    from segger_tpu_torch.utils_profiling import (
        AnonRSSSampler, StageTimer, set_substage_timer,
    )

    work = Path(work_dir)
    cuda = device is None or torch.device(device).type == "cuda"
    pcfg = PipelineConfig(seed=SEED, **(pipeline_kw or {}))
    tcfg = TrainConfig(max_epochs=epochs, **(train_kw or {}))
    synth = pipeline_slide(n_cells, n_genes, tx_per_cell)
    truth = np.asarray(synth.truth_cell)

    # (a) the columnar graph
    sub = StageTimer()
    prev = set_substage_timer(sub)
    anon = AnonRSSSampler().start()
    try:
        t0 = time.perf_counter()
        cols = ColumnarTranscripts.from_chunks(
            frame_chunks(synth.transcripts, COLUMNAR_CHUNKS),
            spool=work / "transcripts_spool")
        walls = {"spool": time.perf_counter() - t0}
        pipe = ISTPipeline(cols, synth.boundaries, synth.polygons, pcfg)
        pipe.load()
        walls.update(pipe.walls)
        if graph is not None:
            columnar_graph_equal(pipe.graph, graph, "columnar")
        gene_names = pipe.adata.var.index.to_numpy().astype(str)

        # (b) the plane: fit, predict_streaming, write_dense
        t0 = time.perf_counter()
        save_host_graph_plane(pipe.graph, work / "plane")
        walls["save-plane"] = time.perf_counter() - t0
        del pipe
        run = run_plane(work / "plane", gene_names, work / "out", pcfg,
                        tcfg, device)
        walls.update(run["walls"])
    finally:
        set_substage_timer(prev)
        anon_gb = anon.stop()
    checked = check_table(run["table"], run["graph"], truth, "out-of-core")
    agree = (table_agreement(run["table"], table) if table is not None
             else None)
    if agree is not None and not agree >= MIN_TABLE_AGREEMENT:
        raise AssertionError(f"out-of-core table agrees with phase 7's on "
                             f"{agree} of transcripts (need >= "
                             f"{MIN_TABLE_AGREEMENT})")

    # (c) the command line: prepare in a child process, then run here
    raw = write_merscope_like(work / "merscope", synth)
    cache = work / "cache"
    flags = [*cli_flags(pipeline_kw), *cli_flags(train_kw),
             "--max-epochs", str(epochs), "--seed", str(SEED),
             "--devices", "1", "--low-memory", "--graph-cache", str(cache)]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", _PREPARE.format(root=str(ROOT), argv=[
            "segment", "-i", str(raw), "-o", str(work / "prep"), *flags,
            "--prepare-only"])],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    prep_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"segment --prepare-only exited "
                             f"{res.returncode}:\n{res.stderr[-3000:]}")
    prep = _json.loads(res.stdout.strip().splitlines()[-1])
    if prep["rc"] != 0 or prep["cuda_initialized"]:
        raise AssertionError(f"segment --prepare-only: {prep}")
    reset_counts()
    code = cli(["segment", "-i", str(work / "no-such-input"), "-o",
                str(work / "cli-out"), *flags,
                *(["--device", device] if device else [])])
    if cuda:
        torch.cuda.synchronize()
    cli_counts = read_counts()
    if code != 0:
        raise AssertionError(f"segment --low-memory --graph-cache exited "
                             f"{code}")
    last = run_segment.last_run
    run_segment.last_run = None
    if set(last["walls"]) != {"load-graph", "fit", "predict", "write"}:
        raise AssertionError(f"the cached run's stages {last['walls']}: "
                             "it read or built")
    if graph_digest(last["graph"]) != prep["graph"]:
        raise AssertionError("the cached run's graph is not the one the "
                             "prepare run built")
    cli_tr = last["trainer"]
    cli_graph = last["graph"]
    cli_want, cli_run = run_launches(types.SimpleNamespace(
        graph=cli_graph, tree=build_tiling(
            cli_graph, nodes_per_tile=pcfg.tiling_nodes_per_tile,
            mode=pcfg.tiling_mode, side_length=pcfg.tiling_side_length),
        cfg=pcfg), cli_tr, epochs)
    cli_table = check_table(
        pd.read_parquet(work / "cli-out" / "segger_segmentation.parquet"),
        cli_graph, truth, "out-of-core cli")

    # (d) the native core against the plain versions
    branches = (graph_stage_branches(synth, graph, pcfg)
                if graph is not None else None)
    counts_cmp = neighbor_count_branches(knn_adjacency(
        np.asarray(run["graph"].bd_x, np.float64),
        pcfg.cells_clusters_n_neighbors))
    return {"walls": walls, "substages": dict(sub.seconds),
            "peak_rss_gb": peak_rss_gb(), "anon_rss_gb": anon_gb,
            "rss_sampled_gb": anon.peak_rss_gb,
            "counts": run["counts"], "want": run["want"],
            "captures": run["captures"], "peak_mib": run["peak_mib"],
            "n_tx": run["graph"].n_tx, "n_bd": run["graph"].n_bd,
            "n_tiles": run["n_tiles"], "steps": run["steps"],
            "history": run["history"], "accuracy": checked["accuracy"],
            "agreement": agree, "tiles": run["tiles"], "cfg": tcfg,
            "cli": {"prepare_s": prep_s, "prepare_walls": prep["walls"],
                    "walls": last["walls"], "counts": cli_counts,
                    "want": cli_want, "captures": dict(cli_tr.captures),
                    "accuracy": cli_table["accuracy"],
                    "n_tiles": (len(cli_run["fit_tiles"]),
                                len(cli_run["ptiles"]))},
            "branches": branches, "neighbor_counts": counts_cmp}


# phase 10: the whole-slide halo-exchange path
WS_LAYOUTS = (("1 strip", 1, None), ("4 strips", 4, None),
              ("2x2 grid", 4, (2, 2)))
WS_F32_SIM_ATOL = 1e-4            # f32 layouts against one strip
WS_MARGIN = 1e-5                  # f32: cells equal where the top-two
                                  # candidate margin exceeds this
WS_GRAD_ATOL = 5e-5               # surrogate gradient, of its scale


def ws_mesh(n, grid, device):
    """``n`` strips, or a ``grid``, with every shard on ``device``."""
    from segger_tpu_torch.parallel.mesh import make_grid_mesh, make_mesh

    if grid is not None:
        return make_grid_mesh(*grid, [device] * n)
    return make_mesh(n, [device] * n)


def ws_trainer(graph, state, device, dtype, epochs, train_kw=None):
    """A trainer at ``TrainConfig(**train_kw)`` width in ``dtype`` holding
    ``state`` (fresh seeded weights when None)."""
    from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

    tr = SeggerTrainer(graph, TrainConfig(
        compute_dtype=dtype, max_epochs=epochs, **(train_kw or {})),
        device=device)
    tr.init()
    if state is not None:
        tr.model.load_state_dict(state)
    return tr


def ws_sorted(pred):
    """Prediction arrays in row order."""
    o = pred["row_index"].argsort()
    return {k: v[o] for k, v in pred.items()}


def ws_margin(tr, graph, device):
    """Each transcript's gap between its best and second-best candidate
    cosine on one strip (inf with fewer than two), in row order."""
    import numpy as np
    import torch

    from segger_tpu_torch.ops.gather_agg import csr_gather
    from segger_tpu_torch.parallel import halo
    from segger_tpu_torch.parallel.mesh import put_sharded

    mesh = ws_mesh(1, None, device)
    stacked, spec, _ = halo.build_sharded_graph(graph, 1)
    (t,), (h,) = put_sharded(stacked, mesh), put_sharded(spec, mesh)
    with torch.no_grad():
        (emb,) = halo.sharded_forward(tr.model, mesh, [t],
                                      halo.strip_exchanges([h])[0])
        cos = torch.einsum("nf,nkf->nk", emb["tx"].float(),
                           csr_gather(emb["bd"].float(), t.cand))
        cos = torch.where(t.cand.mask, cos, -np.inf)
        cos = torch.cat([cos, torch.full_like(cos[:, :1], -np.inf)], 1)
        top = cos.topk(2, dim=1).values
    gap = (top[:, 0] - top[:, 1]).nan_to_num(np.inf).cpu().numpy()
    valid = t.tx_valid.cpu().numpy()
    rows = t.tx_index.cpu().numpy()[valid]
    return gap[valid][rows.argsort()]


def ws_surrogate_grads(tr, graph, n, device):
    """``tests/test_halo_train.py``'s surrogate loss (a node term over
    every transcript, a link term over every supervision edge through a
    final tx exchange) over ``n`` strips: its flat parameter gradient and
    the seconds of its forward and backward (the build not counted)."""
    import torch

    from segger_tpu_torch.parallel import halo
    from segger_tpu_torch.parallel.mesh import put_sharded

    mesh = ws_mesh(n, None, device)
    stacked, spec, _ = halo.build_sharded_graph(graph, n, for_training=True)
    shards, halos = put_sharded(stacked, mesh), put_sharded(spec, mesh)
    ex_tx = halo.strip_exchanges(halos)[0]
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.model.zero_grad(set_to_none=True)
    emb = halo.sharded_forward(tr.model, mesh, shards, ex_tx)
    tx_ext = ex_tx([e["tx"] for e in emb])
    c_node = sum(int(t.tx_valid.sum()) for t in shards)
    c_link = sum(int(t.sg_mask.sum()) for t in shards)
    loss = 0.0
    for t, e, ext in zip(shards, emb, tx_ext):
        node = torch.where(t.tx_valid, (e["tx"] ** 2).sum(-1), 0.0).sum()
        link = (torch.cat(ext)[t.sg_src.long()]
                * e["bd"][t.sg_dst.long()]).sum(-1)
        loss = loss + node / c_node + torch.where(
            t.sg_mask, link, 0.0).sum() / c_link
    loss.backward()
    flat = torch.cat([p.grad.reshape(-1) for p in tr.model.parameters()])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return flat, time.perf_counter() - t0


def ws_counts(n_layers, shards, predicts=0, steps=0) -> dict:
    """The launches of ``predicts`` whole-slide predictions and ``steps``
    train steps over ``shards`` shards: K1 once per conv (tt, tb) a layer
    and shard and K5 once a shard in a predict, K2 and K3 once per conv a
    layer and shard in a step."""
    convs = 2 * n_layers * shards
    return {"fwd": {"nokeep": convs * predicts, "prng": convs * steps,
                    "keep": 0},
            "bwd": {"nokeep": 0, "prng": convs * steps, "keep": 0},
            "score": shards * predicts, "attn": 0, "banded": 0}


def shard_tables(stacked, spec, d) -> dict:
    """Shard ``d``'s own tables with the sizes of the spaces they index:
    tt and tb over its extended tx rows ``[local | halo pieces]``, the
    candidates over its extended bd rows."""
    halo_rows = sum(getattr(spec, f.name).shape[1]
                    for f in dataclasses.fields(spec)
                    if f.name.startswith("tx_send")
                    and not f.name.endswith("mask"))
    return {"tt": (stacked.tt.idx[d], stacked.tt.mask[d]),
            "tb": (stacked.tb.idx[d], stacked.tb.mask[d]),
            "cand": (stacked.cand.idx[d], stacked.cand.mask[d]),
            "n_tx_ext": stacked.tx_gene.shape[1] + halo_rows,
            "n_bd_ext": spec.bd_index_ext.shape[1]}


def drive_whole_slide(work_dir, graph, state, truth, table, device=None,
                      epochs=PIPE_EPOCHS, n_cells=PIPE_CELLS,
                      n_genes=PIPE_GENES, tx_per_cell=PIPE_TX_PER_CELL,
                      pipeline_kw=None, train_kw=None) -> dict:
    """Phase 10: the whole-slide halo-exchange path on phase 7's graph
    with phase 7's trained weights ``state``, every shard on one device
    (``cuda:0`` by default).

    (a) ``predict_whole_slide`` at 1 strip, 4 strips and a 2x2 grid, in
    bf16 and in float32, the kernel counts set to 0 just before each and
    read just after: each covers every transcript once; in bf16 4 strips
    and the grid agree with 1 strip on at least ``MIN_AGREEMENT`` of the
    transcripts with the similarity within ``SIM_ATOL``, and each is more
    accurate than ``MIN_ACCURACY`` against the true cells; in float32 the
    cells are equal wherever the top-two margin exceeds ``WS_MARGIN`` and
    the similarity within ``WS_F32_SIM_ATOL``;
    (b) the surrogate gradient at 4 strips against 1 strip, float32,
    within ``WS_GRAD_ATOL`` of its scale;
    (c) ``fit_whole_slide`` for ``epochs`` at 1 and at 4 strips from one
    seeded init: finite losses;
    (d) with more than one card visible, the 4-strip predict over
    ``min(4, count)`` cards bit-equal to the one-card result, and the
    4-strip fit's losses within ``GRAPH_STEP_RTOL`` of one card's;
    (e) phase 7's slide as a raw Xenium directory through ``segment
    --distributed-predict --distributed-train --devices 1``: the table
    passes ``check_table``.
    On CUDA every run's launches must equal ``ws_counts``.  Returns the
    walls,
    counts, agreements and the shards' own tables for the kernel
    checks."""
    import numpy as np
    import pandas as pd
    import torch

    from segger_tpu_torch.cli.main import main as cli
    from segger_tpu_torch.cli.segment import run_segment
    from segger_tpu_torch.data.synthetic import write_xenium_like
    from segger_tpu_torch.parallel import grid as pgrid
    from segger_tpu_torch.parallel import halo

    cuda = device is None or torch.device(device).type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    n_layers = 4 if train_kw is None else 2 + train_kw.get(
        "n_mid_layers", 2)
    walls, runs, checks = {}, {}, {}

    def counted(key, fn, want):
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[key] = time.perf_counter() - t0
        got = read_counts()
        # the plain versions on the CPU launch nothing
        if cuda and got != want:
            raise AssertionError(f"whole-slide {key}: launches {got}, "
                                 f"expected {want}")
        runs[key] = got
        return out

    # (a) predict at three layouts, two types
    tables = {}
    for name, n, grid in WS_LAYOUTS:
        t0 = time.perf_counter()
        if grid is None:
            stacked, spec, dropped = halo.build_sharded_graph(graph, n)
        else:
            stacked, spec, dropped = pgrid.build_grid_sharded_graph(
                graph, *grid)
        walls[f"build {name}"] = time.perf_counter() - t0
        if dropped.any():
            raise AssertionError(f"{name}: dropped edges {dropped}")
        if n > 1:
            tables[name] = shard_tables(stacked, spec, 1)
    preds = {}
    for dtype in ("bfloat16", "float32"):
        tr = ws_trainer(graph, state, dev, dtype, epochs, train_kw)
        for name, n, grid in WS_LAYOUTS:
            mesh = ws_mesh(n, grid, dev)
            p = counted(f"predict {name} {dtype}",
                        lambda: tr.predict_whole_slide(mesh, grid=grid),
                        ws_counts(n_layers, n, predicts=1))
            p = ws_sorted(p)
            if not np.array_equal(p["row_index"], np.sort(graph.tx_index)):
                raise AssertionError(f"whole-slide {name} {dtype}: not "
                                     "one row per transcript")
            preds[(name, dtype)] = p
        if dtype == "float32":
            margin = ws_margin(tr, graph, dev)
            f32_tr = tr
        else:
            bf16_tr = tr
    ref16, ref32 = preds[("1 strip", "bfloat16")], preds[("1 strip",
                                                          "float32")]
    clear = margin > WS_MARGIN
    for name, _, _ in WS_LAYOUTS:
        p16, p32 = preds[(name, "bfloat16")], preds[(name, "float32")]
        enc = p16["cell_encoding"].astype(np.int64)
        ids = np.where(enc >= 0, graph.bd_cell_id[np.maximum(enc, 0)], None)
        acc = _accuracy(p16["row_index"].astype(np.int64), ids, truth)
        agree = float((enc == ref16["cell_encoding"]).mean())
        sim16 = float(np.abs(p16["similarity"] - ref16["similarity"]).max())
        sim32 = float(np.abs(p32["similarity"] - ref32["similarity"]).max())
        eq32 = bool((p32["cell_encoding"][clear]
                     == ref32["cell_encoding"][clear]).all())
        t = table.set_index("row_index")["segger_cell_id"].astype(object)
        t7 = t.reindex(p16["row_index"]).to_numpy()
        has = pd.notna(t7)
        tiled = float((ids[has] == t7[has]).mean())
        checks[name] = {"accuracy": acc, "agreement_bf16": agree,
                        "max_sim_diff_bf16": sim16,
                        "max_sim_diff_f32": sim32, "cells_equal_f32": eq32,
                        "clear_share_f32": float(clear.mean()),
                        "agreement_with_tiled": tiled}
        if not acc > MIN_ACCURACY:
            raise AssertionError(f"whole-slide {name}: accuracy {acc}")
        if not (agree >= MIN_AGREEMENT and sim16 <= SIM_ATOL):
            raise AssertionError(f"whole-slide {name} bf16 against 1 "
                                 f"strip: agreement {agree}, sim {sim16}")
        if not (eq32 and sim32 <= WS_F32_SIM_ATOL):
            raise AssertionError(f"whole-slide {name} f32 against 1 strip: "
                                 f"cells equal {eq32}, sim {sim32}")

    # (b) the surrogate gradient through the exchange, f32
    grads = {}
    for n in (1, 4, 1):
        t0 = time.perf_counter()
        grads[n] = ws_surrogate_grads(f32_tr, graph, n, dev)
        sync()
        # the second 1-strip run is the warm one
        walls[f"surrogate gradient {n} strip{'s' * (n > 1)}"] = \
            time.perf_counter() - t0
    (g1, step1), (g4, step4) = grads[1], grads[4]
    walls["surrogate forward + backward 1 strip (warm)"] = step1
    walls["surrogate forward + backward 4 strips"] = step4
    scale = float(g1.abs().max()) + 1e-12
    grad_err = float((g4 - g1).abs().max()) / scale
    if not grad_err <= WS_GRAD_ATOL:
        raise AssertionError(f"surrogate gradient 4 strips: {grad_err} of "
                             f"scale, limit {WS_GRAD_ATOL}")
    del f32_tr

    # (c) whole-slide training from one seeded init, 1 and 4 strips
    t0 = time.perf_counter()
    stacked, spec, _ = halo.build_sharded_graph(graph, 4, for_training=True)
    walls["build 4 strips for training"] = time.perf_counter() - t0
    tables["4 strips training"] = shard_tables(stacked, spec, 1)
    histories, epoch_walls = {}, {}
    for name, n, _ in WS_LAYOUTS[:2]:
        tr = ws_trainer(graph, None, dev, "bfloat16", epochs, train_kw)
        mesh = ws_mesh(n, None, dev)
        hist = counted(f"fit {name}",
                       lambda: tr.fit_whole_slide(mesh, max_epochs=epochs),
                       ws_counts(n_layers, n, steps=epochs))
        losses = [h["train:loss"] for h in hist]
        if not (len(hist) == epochs and np.isfinite(losses).all()):
            raise AssertionError(f"fit_whole_slide {name}: {hist}")
        histories[name] = hist
        epoch_walls[name] = [sec for _, _, sec in tr.step_log]
        del tr

    # (d) several cards: the 4-strip predict and fit with shard d on card
    # d mod k, against one card
    multi = None
    n_cards = torch.cuda.device_count() if cuda else 0
    if n_cards > 1:
        k = min(4, n_cards)
        from segger_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=[torch.device("cuda", d % k)
                                  for d in range(4)])
        p = ws_sorted(bf16_tr.predict_whole_slide(mesh))
        ref = preds[("4 strips", "bfloat16")]
        tr = ws_trainer(graph, None, dev, "bfloat16", epochs, train_kw)
        t0 = time.perf_counter()
        hist = tr.fit_whole_slide(mesh, max_epochs=epochs)
        walls[f"fit 4 strips over {k} cards"] = time.perf_counter() - t0
        want = [h["train:loss"] for h in histories["4 strips"]]
        got = [h["train:loss"] for h in hist]
        multi = {"cards": k, "predict_bit_equal": all(
            np.array_equal(p[key], ref[key]) for key in ref),
            "fit_losses": got, "fit_losses_one_card": want}
        if not multi["predict_bit_equal"]:
            raise AssertionError(f"4 strips over {k} cards: the predict "
                                 "differs from one card's")
        # the gradient sums of several cards run in another order
        if not np.allclose(got, want, rtol=GRAPH_STEP_RTOL, atol=0):
            raise AssertionError(f"4 strips over {k} cards: fit losses "
                                 f"{got}, one card {want}")
        del tr
    del bf16_tr

    # (e) the command line, on phase 7's slide as a Xenium directory
    work = Path(work_dir)
    synth = pipeline_slide(n_cells, n_genes, tx_per_cell)
    raw = write_xenium_like(work / "xenium", synth)
    out = work / "out"
    reset_counts()
    code = cli(["segment", "-i", str(raw), "-o", str(out), "--no-anndata",
                "--distributed-predict", "--distributed-train",
                "--devices", "1", "--max-epochs", str(epochs), "--seed",
                str(SEED), *(["--device", device] if device else []),
                *cli_flags(pipeline_kw), *cli_flags(train_kw)])
    sync()
    cli_counts = read_counts()
    if code != 0:
        raise AssertionError(f"segment --distributed-* exited {code}")
    last = run_segment.last_run
    run_segment.last_run = None
    g = last["pipeline"].graph
    want = ws_counts(n_layers, 1, predicts=1, steps=epochs)
    if cuda and cli_counts != want:
        raise AssertionError(f"segment --distributed-*: launches "
                             f"{cli_counts}, expected {want}")
    seg = pd.read_parquet(out / "segger_segmentation.parquet")
    cli_table = check_table(seg, g, np.asarray(synth.truth_cell),
                            "whole-slide cli")
    runs["cli"] = cli_counts
    peak = ((torch.cuda.max_memory_allocated() - base) / 2**20 if cuda
            else None)
    return {"walls": walls, "counts": runs, "checks": checks,
            "grad_err": grad_err, "histories": histories,
            "epoch_walls": epoch_walls, "multi": multi,
            "n_cards": n_cards, "tables": tables,
            "cli": {"walls": last["walls"], "accuracy":
                    cli_table["accuracy"],
                    "history": last["trainer"].history},
            "peak_mib": peak, "n_layers": n_layers}


def print_whole_slide(ws, n_tx, n_bd, card) -> None:
    """Phase 10's walls, checks, fits and launches."""
    print(f"whole-slide: phase 7's graph ({n_tx} tx, {n_bd} "
          f"cells) with its trained weights, every shard on cuda:0, "
          f"TrainConfig() width; walls (s) " + json.dumps(
              {k: round(v, 4) for k, v in ws["walls"].items()})
          + f"; max_memory_allocated {ws['peak_mib']:.1f} MiB above the "
          f"earlier phases' tensors | {card}")
    for name, c in ws["checks"].items():
        print(f"whole-slide {name}: " + json.dumps(c))
    print(f"whole-slide surrogate gradient, 4 strips against 1 strip "
          f"(f32): {ws['grad_err']:.3e} of scale (limit {WS_GRAD_ATOL})")
    for name, hist in ws["histories"].items():
        print(f"whole-slide fit {name}: epoch walls (s) "
              f"{[round(w, 4) for w in ws['epoch_walls'][name]]}; "
              + json.dumps(hist))
    if ws["multi"] is None:
        print(f"whole-slide on several cards: not run, "
              f"{ws['n_cards']} card visible")
    else:
        print(f"whole-slide 4 strips over {ws['multi']['cards']} cards: "
              f"predict bit-equal to one card; " + json.dumps(ws["multi"]))
    print("whole-slide cli: segment --distributed-predict "
          "--distributed-train --devices 1 on phase 7's slide as a Xenium "
          "directory, walls (s) " + json.dumps(
              {k: round(v, 3) for k, v in ws["cli"]["walls"].items()})
          + f", accuracy {ws['cli']['accuracy']:.4f}")
    print(f"whole-slide launches {json.dumps(ws['counts'])}")


# phase 11: tile data parallelism
TILE_DP_SHARDS = 4                # shards of the mesh, all on cuda:0
TILE_DP_TPS = 4                   # tiles_per_step of both trainers
_COUNT_KEYS = ("fwd", "bwd", "score", "attn", "banded")


def _as_counts(launches) -> dict:
    """A compiled step's launch list (``graphs._COUNTED`` order) as
    ``read_counts`` names it."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in zip(_COUNT_KEYS, launches)}


def _add_counts(a: dict, b: dict, times: int = 1) -> dict:
    return {k: ({m: a[k][m] + times * b[k][m] for m in a[k]}
                if isinstance(a[k], dict) else a[k] + times * b[k])
            for k in a}


def shard_counts(tr) -> list:
    """Each shard's launches of a tile-data-parallel trainer's compiled
    steps on CUDA: a step's warm-up and each replay launch what its
    capture recorded (a split train step: forward and backward)."""
    zero = {k: (dict.fromkeys(("nokeep", "prng", "keep"), 0)
                if k in ("fwd", "bwd") else 0) for k in _COUNT_KEYS}
    out = [zero for _ in range(tr.mesh.size)]
    for (kind, _, d), step in tr._steps.items():
        if step.launches is None:
            continue
        runs = step.replays + 1
        out[d] = _add_counts(out[d], _as_counts(step.launches), runs)
        if kind == "train":
            out[d] = _add_counts(out[d], _as_counts(step.bwd_launches), runs)
    return out


def drive_tile_dp(work_dir, graph, tree, truth, device=None,
                  epochs=PIPE_EPOCHS, n_cells=PIPE_CELLS, n_genes=PIPE_GENES,
                  tx_per_cell=PIPE_TX_PER_CELL, pipeline_kw=None,
                  train_kw=None) -> dict:
    """Phase 11: tile data parallelism on phase 7's graph and tiling at
    ``TrainConfig()`` width with ``tiles_per_step = TILE_DP_TPS``, the
    kernel counts set to 0 just before each run and read just after.

    (a) the one-device trainer: ``fit`` for ``epochs`` from the seeded
    initial weights, then ``predict``;
    (b) ``SeggerTrainer(mesh=)`` over ``TILE_DP_SHARDS`` shards on one
    device (``cuda:0`` by default), from the same initial weights: every
    step's loss within ``GRAPH_STEP_RTOL`` of (a)'s, the launches of K1,
    K2, K3 and K5 equal to (a)'s (each shard's counted from its steps'
    replays);
    (c) the mesh's ``predict`` with (a)'s trained weights: the arrays of
    (a)'s predict (cells equal on at least ``MIN_AGREEMENT`` of the
    transcripts, bit-equality recorded), the same launches;
    (d) with several cards visible, shard ``d`` on card ``d mod k`` (k up
    to 4): the fit's losses within ``GRAPH_STEP_RTOL`` of (b)'s, the
    predict bit-equal to (c)'s; with four cards also ``segment --devices
    4`` on phase 7's slide as a Xenium directory (the table passes
    ``check_table``).
    Returns the walls, counts, losses and agreements, and one shard's
    tiles for the kernel checks."""
    import numpy as np
    import torch

    from segger_tpu_torch.data.partition import (
        make_fit_tiles, make_predict_tiles,
    )
    from segger_tpu_torch.parallel.mesh import make_mesh
    from segger_tpu_torch.pipeline import PipelineConfig
    from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

    cuda = device is None or torch.device(device).type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    pcfg = PipelineConfig(seed=SEED, **(pipeline_kw or {}))
    fit_tiles = make_fit_tiles(graph, tree,
                               margin=pcfg.tiling_margin_training)
    ptiles = make_predict_tiles(graph, tree,
                                margin=pcfg.tiling_margin_prediction)
    cfg = TrainConfig(max_epochs=epochs, tiles_per_step=TILE_DP_TPS,
                      **(train_kw or {}))
    walls, counts, peaks = {}, {}, {}

    def run(key, fn):
        reset_counts()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[key] = time.perf_counter() - t0
        counts[key] = read_counts()
        if cuda:    # the run's own peak on cuda:0, above what it found
            top = torch.cuda.max_memory_allocated()
            peaks[key] = (top - held) / 2**20
            peaks["phase"] = max(peaks.get("phase", 0.0),
                                 (top - base) / 2**20)
        return out

    def trainer(mesh):
        tr = SeggerTrainer(graph, cfg, device=dev, mesh=mesh)
        tr.init()
        return tr

    def losses(tr):
        return [row[0] for _, row, _ in tr.step_log]

    # (a) one device
    one = trainer(None)
    init = {k: v.clone() for k, v in one.model.state_dict().items()}
    run("fit one device", lambda: one.fit(fit_tiles, max_epochs=epochs))
    pred_one = run("predict one device", lambda: one.predict(ptiles))
    # (b) the mesh, every shard on one device
    mesh = make_mesh(TILE_DP_SHARDS, [dev] * TILE_DP_SHARDS)
    dp = trainer(mesh)
    if not all(torch.equal(v, init[k])
               for k, v in dp.model.state_dict().items()):
        raise AssertionError("tile-dp: the initial weights differ")
    run("fit mesh", lambda: dp.fit(fit_tiles, max_epochs=epochs))
    fit_shards = shard_counts(dp) if cuda else None
    got, want = losses(dp), losses(one)
    loss_rel = float(np.max(np.abs(np.subtract(got, want))
                            / np.abs(want)))
    if not (len(got) == len(want) > 0 and loss_rel <= GRAPH_STEP_RTOL):
        raise AssertionError(f"tile-dp fit losses {got}, one device {want}")
    # (c) the mesh's predict with the one-device weights
    dp.model.load_state_dict(one.model.state_dict())
    pred_dp = run("predict mesh", lambda: dp.predict(ptiles))
    shards = shard_counts(dp) if cuda else None
    pred_shards = ([_add_counts(b, a, -1) for a, b in zip(fit_shards,
                                                          shards)]
                   if cuda else None)
    agree = float((pred_dp["cell_encoding"]
                   == pred_one["cell_encoding"]).mean())
    bit_equal = all(np.array_equal(pred_dp[k], pred_one[k])
                    for k in pred_one)
    if not agree >= MIN_AGREEMENT:
        raise AssertionError(f"tile-dp predict agrees with one device on "
                             f"{agree} of the transcripts")
    enc = pred_dp["cell_encoding"].astype(np.int64)
    ids = np.where(enc >= 0, graph.bd_cell_id[np.maximum(enc, 0)], None)
    acc = _accuracy(pred_dp["row_index"].astype(np.int64), ids, truth)
    if not acc > MIN_ACCURACY:
        raise AssertionError(f"tile-dp predict accuracy {acc}")
    # the launches: the same kernels on the same tiles, split over shards
    for a, b in (("fit mesh", "fit one device"),
                 ("predict mesh", "predict one device")):
        if cuda and counts[a] != counts[b]:
            raise AssertionError(f"tile-dp {a}: launches {counts[a]}, one "
                                 f"device {counts[b]}")
    for shard_list, key in ((fit_shards, "fit mesh"),
                            (pred_shards, "predict mesh")):
        if not cuda:
            continue
        total = shard_list[0]
        for c in shard_list[1:]:
            total = _add_counts(total, c)
        if total != counts[key]:
            raise AssertionError(f"tile-dp {key}: the shards' launches "
                                 f"{shard_list} do not sum to {counts[key]}")
    tables = {}
    for kind in ("predict", "train"):
        key = next(k for k in dp._steps if k[0] == kind and k[2] == 1)
        tables[kind] = dp._steps[key].inputs.batch.map_arrays(
            lambda a: a[0])
    result = {"walls": walls, "counts": counts, "peaks_mib": peaks,
              "fit_shards": fit_shards,
              "predict_shards": pred_shards, "losses": got,
              "losses_one": want, "loss_rel": loss_rel,
              "history": dp.history, "history_one": one.history,
              "agreement": agree, "bit_equal": bit_equal, "accuracy": acc,
              "step_s": [sec for _, _, sec in dp.step_log],
              "step_s_one": [sec for _, _, sec in one.step_log],
              "captures": dict(dp.captures), "n_tiles": (len(fit_tiles),
                                                        len(ptiles)),
              "steps": len(dp.step_log), "tiles": tables, "multi": None,
              "cli": None}
    del one
    # (d) several cards: shard d on card d mod k
    n_cards = torch.cuda.device_count() if cuda else 0
    result["n_cards"] = n_cards
    if n_cards > 1:
        k = min(TILE_DP_SHARDS, n_cards)
        cards = make_mesh(TILE_DP_SHARDS, [torch.device("cuda", d % k)
                                           for d in range(TILE_DP_SHARDS)])
        multi = trainer(cards)
        run(f"fit mesh over {k} cards",
            lambda: multi.fit(fit_tiles, max_epochs=epochs))
        got_k = losses(multi)
        rel_k = float(np.max(np.abs(np.subtract(got_k, got))
                             / np.abs(got)))
        multi.model.load_state_dict(dp.model.state_dict())
        pred_k = run(f"predict mesh over {k} cards",
                     lambda: multi.predict(ptiles))
        result["multi"] = {"cards": k, "losses": got_k, "loss_rel": rel_k,
                           "predict_bit_equal": all(
                               np.array_equal(pred_k[key], pred_dp[key])
                               for key in pred_dp)}
        if not result["multi"]["predict_bit_equal"]:
            raise AssertionError(f"tile-dp over {k} cards: the predict "
                                 "differs from one card's")
        if not rel_k <= GRAPH_STEP_RTOL:
            raise AssertionError(f"tile-dp over {k} cards: losses {got_k}, "
                                 f"one card {got}")
        del multi
    if n_cards >= 4:
        from segger_tpu_torch.cli.main import main as cli
        from segger_tpu_torch.cli.segment import run_segment
        from segger_tpu_torch.data.synthetic import write_xenium_like

        import pandas as pd

        work = Path(work_dir)
        synth = pipeline_slide(n_cells, n_genes, tx_per_cell)
        raw = write_xenium_like(work / "xenium", synth)
        out = work / "out"
        reset_counts()
        code = cli(["segment", "-i", str(raw), "-o", str(out),
                    "--no-anndata", "--devices", "4", "--max-epochs",
                    str(epochs), "--seed", str(SEED),
                    *cli_flags(pipeline_kw), *cli_flags(train_kw)])
        sync()
        if code != 0:
            raise AssertionError(f"segment --devices 4 exited {code}")
        last = run_segment.last_run
        run_segment.last_run = None
        tr = last["trainer"]
        if not (tr.tile_dp and tr.mesh.size == 4
                and tr.cfg.tiles_per_step == 4):
            raise AssertionError("segment --devices 4: not tile data "
                                 "parallel over 4 cards")
        seg = pd.read_parquet(out / "segger_segmentation.parquet")
        table = check_table(seg, last["pipeline"].graph,
                            np.asarray(synth.truth_cell), "segment "
                            "--devices 4")
        result["cli"] = {"walls": last["walls"], "counts": read_counts(),
                         "accuracy": table["accuracy"],
                         "history": tr.history}
    result["peak_mib"] = (max(peaks.pop("phase"),
                              (torch.cuda.max_memory_allocated() - base)
                              / 2**20) if cuda else None)
    return result


def print_tile_dp(td, card) -> None:
    """Phase 11's walls, losses, agreements and launches."""
    print(f"tile-dp: phase 7's graph and tiling ({td['n_tiles'][0]} fit, "
          f"{td['n_tiles'][1]} predict tiles), TrainConfig() width, "
          f"tiles_per_step {TILE_DP_TPS}, one device against "
          f"{TILE_DP_SHARDS} shards on cuda:0, {td['steps']} steps; walls "
          f"(s) " + json.dumps({k: round(v, 4)
                                for k, v in td["walls"].items()})
          + f"; max_memory_allocated {td['peak_mib']:.1f} MiB above the "
          f"earlier phases' tensors, each run's on cuda:0 above what it "
          f"found (MiB) " + json.dumps({k: round(v, 1) for k, v in
                                        td["peaks_mib"].items()})
          + f"; captures {td['captures']} | {card}")
    print(f"tile-dp fit: step losses {json.dumps(td['losses'])}, one device "
          f"{json.dumps(td['losses_one'])}, largest relative difference "
          f"{td['loss_rel']:.3e} (limit {GRAPH_STEP_RTOL})")
    print("tile-dp step walls (s): mesh " + json.dumps(
        [round(v, 4) for v in td["step_s"]]) + ", one device " + json.dumps(
        [round(v, 4) for v in td["step_s_one"]]))
    for a, b in zip(td["history"], td["history_one"]):
        print("tile-dp fit epoch " + json.dumps(a) + " | one device "
              + json.dumps(b))
    print(f"tile-dp predict with the one-device weights: cells agree on "
          f"{td['agreement']:.6f} of the transcripts (need >= "
          f"{MIN_AGREEMENT}), bit-equal {td['bit_equal']}, accuracy "
          f"{td['accuracy']:.4f}")
    print(f"tile-dp launches {json.dumps(td['counts'])}")
    print(f"tile-dp launches by shard: fit {json.dumps(td['fit_shards'])}; "
          f"predict {json.dumps(td['predict_shards'])}")
    if td["multi"] is None:
        print(f"tile-dp on several cards: not run, {td['n_cards']} card "
              "visible")
    else:
        print(f"tile-dp over {td['multi']['cards']} cards: "
              + json.dumps(td["multi"]))
    if td["cli"] is None:
        print("tile-dp cli: segment --devices 4 not run (needs four cards)")
    else:
        print("tile-dp cli: segment --devices 4 on phase 7's slide as a "
              "Xenium directory, walls (s) " + json.dumps(
                  {k: round(v, 3) for k, v in td["cli"]["walls"].items()})
              + f", accuracy {td['cli']['accuracy']:.4f}, launches "
              f"{json.dumps(td['cli']['counts'])}")


# phase 12: the whole-slide paths over several processes
MP_WORLD = 2                      # ranks on one card (gloo)
MP_TIMEOUT = 300                  # seconds for every rank of a run
MP_GRACE = 10                     # seconds left to the others once a
                                  # rank has failed
MP_PREDICTS = 2                   # predicts a layout (the second warm)


def mp_layouts(world: int) -> tuple:
    """A ``world``-rank run's layouts, one shard a rank: ``world`` strips
    and a grid, ``(2, 2)`` on four ranks, else ``(world, 1)``."""
    grid = (2, 2) if world == 4 else (world, 1)
    return (("strips", None), (f"{grid[0]}x{grid[1]} grid", grid))


def mp_devices(world: int, backend: str, device=None) -> list:
    """Rank ``r``'s device: ``cuda:r`` under NCCL, ``cuda:0`` for every
    rank under gloo, or ``device`` (the CPU rehearsal)."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)] * world
    return [torch.device("cuda", r if backend == "nccl" else 0)
            for r in range(world)]


def mp_predicts(tr, world, mesh_of, sync) -> tuple:
    """``MP_PREDICTS`` whole-slide predicts a layout of a ``world``-rank
    run over ``mesh_of(grid)``, the kernel counts set to 0 just before
    each and read just after: the last predict, every run's counts and
    walls, by layout; the runs must agree bit for bit."""
    import numpy as np

    preds, counts, walls = {}, {}, {}
    for name, grid in mp_layouts(world):
        for i in range(MP_PREDICTS):
            reset_counts()
            t0 = time.perf_counter()
            p = ws_sorted(tr.predict_whole_slide(mesh_of(grid), grid=grid))
            sync()
            walls.setdefault(name, []).append(time.perf_counter() - t0)
            counts.setdefault(name, []).append(read_counts())
            if name in preds and not all(np.array_equal(p[k], preds[name][k])
                                         for k in p):
                raise AssertionError(f"multi-process {name}: two predicts "
                                     "differ")
            preds[name] = p
    return preds, counts, walls


def mp_fit(graph, dev, epochs, train_kw, mesh) -> dict:
    """``fit_whole_slide`` for ``epochs`` from the seeded init, counted:
    its history, epoch walls, launches and flat parameters."""
    from segger_tpu_torch.parallel.mesh import flat_parameters

    tr = ws_trainer(graph, None, dev, "bfloat16", epochs, train_kw)
    reset_counts()
    hist = tr.fit_whole_slide(mesh, max_epochs=epochs)
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize()
    return {"history": hist, "counts": read_counts(),
            "epoch_walls": [sec for _, _, sec in tr.step_log],
            "params": flat_parameters(tr.model).cpu().numpy()}


def rank_main(argv) -> int:
    """One rank of phase 12, started by :func:`drive_multiprocess` as
    ``chip_smoke.py --rank R --world W --addr HOST:PORT --work DIR
    --backend gloo|nccl``: joins the group on its device, reads phase
    7's graph (a graph plane) and weights and the run's settings from
    ``DIR``, runs
    :func:`mp_predicts` and :func:`mp_fit` over the global mesh, and
    writes what it saw to ``DIR/rank<R>.pkl``."""
    import pickle

    import torch

    opts = dict(zip(argv[0::2], argv[1::2]))
    rank, world = int(opts["--rank"]), int(opts["--world"])
    work = Path(opts["--work"])
    run = json.loads((work / "run.json").read_text())
    if run["device"] == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from segger_tpu_torch.data.assemble import load_host_graph_plane
    from segger_tpu_torch.parallel.mesh import (
        initialize_multihost, make_mesh, shutdown_multihost,
    )

    dev = mp_devices(world, opts["--backend"], run["device"])[rank]
    # the ranks share the host's cores, as torchrun's workers do
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    t0 = time.perf_counter()
    initialize_multihost(opts["--addr"], world, rank,
                         backend=opts["--backend"], devices=[dev])
    walls = {"initialize_multihost": time.perf_counter() - t0}
    t0 = time.perf_counter()
    graph = load_host_graph_plane(work / "graph", mmap=False)
    state = torch.load(work / "state.pt")
    walls["load graph and weights"] = time.perf_counter() - t0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    tr = ws_trainer(graph, state, dev, "bfloat16", run["epochs"],
                    run["train_kw"])
    preds, counts, pwalls = mp_predicts(tr, world, lambda grid: None, sync)
    fit = mp_fit(graph, dev, run["epochs"], run["train_kw"], make_mesh())
    shutdown_multihost()
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps({
        "preds": preds, "counts": counts, "walls": walls,
        "predict_walls": pwalls, "fit": fit,
        "device": str(dev)}))
    print(f"rank {rank} of {world}: done", flush=True)
    return 0


def start_ranks(argv_of, work, world: int) -> list:
    """Start ``world`` processes ``python *argv_of(rank, "HOST:PORT")``
    on one free port of this host, rank ``r`` writing its output to
    ``work/rank<r>.log``: their ``(process, log path)`` pairs."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    ranks = []
    for r in range(world):
        log = Path(work) / f"rank{r}.log"
        with open(log, "w") as f:
            ranks.append((subprocess.Popen(
                [sys.executable, *argv_of(r, addr)], stdout=f,
                stderr=subprocess.STDOUT, cwd=ROOT), log))
    return ranks


def wait_ranks(ranks, timeout: float) -> list:
    """Wait for the ranks of :func:`start_ranks`, at most ``timeout``
    seconds, and once one has failed at most ``MP_GRACE`` more (its peers
    would wait for it in their next collective): every rank still running
    then is killed.  Each rank's ``(returncode, log)``, negative for a
    killed rank."""
    deadline = time.monotonic() + timeout
    try:
        while (any(p.poll() is None for p, _ in ranks)
               and time.monotonic() < deadline):
            if any(p.poll() for p, _ in ranks):
                deadline = min(deadline, time.monotonic() + MP_GRACE)
            time.sleep(0.1)
    finally:
        for p, _ in ranks:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [(p.returncode, log.read_text()) for p, log in ranks]


def mp_run(work, world: int, backend: str) -> list:
    """Run ``world`` ranks of this script over ``work`` (:func:`rank_main`)
    for at most ``MP_TIMEOUT`` seconds; a rank that fails or is stopped
    fails the run.  Each rank's results."""
    import pickle

    runs = wait_ranks(start_ranks(
        lambda r, addr: [str(ROOT / "chip_smoke.py"), "--rank", str(r),
                         "--world", str(world), "--addr", addr, "--work",
                         str(work), "--backend", backend], work, world),
        MP_TIMEOUT)
    bad = [r for r, (code, _) in enumerate(runs) if code != 0]
    if bad:
        raise AssertionError(
            f"multi-process ({backend}, {world} ranks): ranks {bad} failed "
            f"or were stopped (codes {[code for code, _ in runs]}, limit "
            f"{MP_TIMEOUT} s):\n" + "\n".join(
                f"-- rank {r}\n{log[-3000:]}"
                for r, (_, log) in enumerate(runs)))
    return [pickle.loads((Path(work) / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def drive_multiprocess(work_dir, graph, state, device=None,
                       epochs=PIPE_EPOCHS, train_kw=None, world=MP_WORLD,
                       backend="gloo") -> dict:
    """Phase 12: the whole-slide paths over ``world`` processes on phase
    7's graph with phase 7's trained weights ``state``, one shard a rank:
    under gloo every rank on ``cuda:0`` (NCCL refuses two ranks on one
    card), under NCCL rank ``r`` on ``cuda:r``.

    First the references in this process, one process over the ranks'
    devices: ``MP_PREDICTS`` predicts at ``world`` strips and the grid
    of :func:`mp_layouts`, and ``fit_whole_slide`` for ``epochs`` from
    the seeded init.  Then the ranks (this script with ``--rank``), each
    joining the group with ``initialize_multihost`` and running the same
    over the global mesh.  Every rank's predicts must equal the
    reference's bit for bit, its fit's epoch losses lie within
    ``GRAPH_STEP_RTOL`` of the reference's, the parameters after the fit
    be equal on every rank, and on CUDA each rank's launches be its
    shard's share: 8 K1 and 1 K5 a predict, 8 K2 and 8 K3 a step.
    Returns the walls, counts and checks."""
    import numpy as np
    import torch

    from segger_tpu_torch.data.assemble import save_host_graph_plane
    from segger_tpu_torch.parallel.mesh import make_grid_mesh, make_mesh

    devs = mp_devices(world, backend, device)
    cuda = devs[0].type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def mesh_of(grid):
        return (make_mesh(devices=devs) if grid is None
                else make_grid_mesh(*grid, devs))

    n_layers = 4 if train_kw is None else 2 + train_kw.get(
        "n_mid_layers", 2)
    tr = ws_trainer(graph, state, devs[0], "bfloat16", epochs, train_kw)
    want, want_counts, ref_walls = mp_predicts(tr, world, mesh_of, sync)
    del tr
    ref_fit = mp_fit(graph, devs[0], epochs, train_kw, mesh_of(None))
    work = Path(work_dir)
    save_host_graph_plane(graph, work / "graph", with_edge_groups=False)
    torch.save({k: v.cpu() for k, v in state.items()}, work / "state.pt")
    (work / "run.json").write_text(json.dumps({
        "device": devs[0].type, "epochs": epochs, "train_kw": train_kw}))
    t0 = time.perf_counter()
    ranks = mp_run(work, world, backend)
    wall = time.perf_counter() - t0

    pred_want = ws_counts(n_layers, 1, predicts=1)
    fit_want = ws_counts(n_layers, 1, steps=epochs)
    ref_losses = [h["train:loss"] for h in ref_fit["history"]]
    checks = {}
    for r, got in enumerate(ranks):
        for name, p in got["preds"].items():
            if not all(np.array_equal(p[k], want[name][k]) for k in p):
                raise AssertionError(f"multi-process rank {r} {name}: the "
                                     "predict differs from one process's")
        losses = [h["train:loss"] for h in got["fit"]["history"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        if not (len(losses) == epochs and rel <= GRAPH_STEP_RTOL):
            raise AssertionError(f"multi-process rank {r}: fit losses "
                                 f"{losses}, one process {ref_losses}")
        if not np.array_equal(got["fit"]["params"],
                              ranks[0]["fit"]["params"]):
            raise AssertionError(f"multi-process rank {r}: parameters "
                                 "differ from rank 0's after the fit")
        if cuda and (any(c != pred_want for cs in got["counts"].values()
                         for c in cs) or got["fit"]["counts"] != fit_want):
            raise AssertionError(
                f"multi-process rank {r}: launches {got['counts']}, fit "
                f"{got['fit']['counts']}, expected {pred_want} a predict "
                f"and {fit_want} a fit")
        checks[r] = {"device": got["device"], "loss_rel": rel,
                     "losses": losses}
    return {"world": world, "backend": backend, "ranks": ranks,
            "checks": checks, "wall": wall, "ref_walls": ref_walls,
            "ref_epoch_walls": ref_fit["epoch_walls"],
            "ref_losses": ref_losses, "ref_counts": want_counts,
            "ref_fit_counts": ref_fit["counts"], "n_layers": n_layers}


def multiprocess_counts(mp) -> dict:
    """Every rank's launches of phase 12 (its predicts and its fit),
    summed, by kernel mode."""
    total = {"fwd": dict.fromkeys(("nokeep", "prng", "keep"), 0),
             "bwd": dict.fromkeys(("nokeep", "prng", "keep"), 0),
             "score": 0}
    for got in mp["ranks"]:
        runs = [c for cs in got["counts"].values() for c in cs]
        for c in runs + [got["fit"]["counts"]]:
            for mode in ("nokeep", "prng", "keep"):
                total["fwd"][mode] += c["fwd"][mode]
                total["bwd"][mode] += c["bwd"][mode]
            total["score"] += c["score"]
    return total


def print_multiprocess(mp, card) -> None:
    """Phase 12's walls, checks and launches."""
    def r(xs):
        return [round(x, 4) for x in xs]

    print(f"multi-process: {mp['world']} ranks ({mp['backend']}) on "
          f"{sorted({g['device'] for g in mp['ranks']})}, phase 7's graph "
          f"with its trained weights, TrainConfig() width, one shard a "
          f"rank; ranks started, run and joined in {mp['wall']:.3f} s | "
          f"{card}")
    print("multi-process one process (reference): predict walls (s) "
          + json.dumps({k: r(v) for k, v in mp["ref_walls"].items()})
          + f"; fit epoch walls (s) {r(mp['ref_epoch_walls'])}; losses "
          f"{mp['ref_losses']}")
    for rank, got in enumerate(mp["ranks"]):
        c = mp["checks"][rank]
        print(f"multi-process rank {rank} on {c['device']}: walls (s) "
              + json.dumps({k: round(v, 4) for k, v in got["walls"].items()})
              + "; predict walls (s) " + json.dumps(
                  {k: r(v) for k, v in got["predict_walls"].items()})
              + f"; bit-equal to one process; fit epoch walls (s) "
              f"{r(got['fit']['epoch_walls'])}, losses {c['losses']} "
              f"(largest relative difference {c['loss_rel']:.3e}, limit "
              f"{GRAPH_STEP_RTOL}); parameters equal to rank 0's")
    print(f"multi-process launches, every rank summed "
          f"{json.dumps(multiprocess_counts(mp))}")


def multiprocess_phase(graph, state, card) -> list:
    """Phase 12 as the script runs it: two gloo ranks on ``cuda:0``, then
    with several cards ``min(4, count)`` NCCL ranks, one a card; each
    run printed.  The runs' results."""
    import tempfile

    import torch

    runs = [(MP_WORLD, "gloo")]
    if torch.cuda.device_count() > 1:
        runs.append((min(4, torch.cuda.device_count()), "nccl"))
    mps = []
    for world, backend in runs:
        with tempfile.TemporaryDirectory() as work_dir:
            mps.append(drive_multiprocess(work_dir, graph, state,
                                          world=world, backend=backend))
        print_multiprocess(mps[-1], card)
    return mps


def helper_tile(n_tx=N_BENCH, seed=SEED):
    """``bench.py::build_tile``'s tt table from the port's host modules:
    ``n_tx`` transcripts uniform at Xenium density in strip-major order,
    kNN 5 within 5 um, padded to a multiple of 8; and its transpose
    table."""
    import numpy as np

    from segger_tpu_torch.data.neighbors_host import kdtree_neighbors
    from segger_tpu_torch.data.partition import _strip_major_order
    from segger_tpu_torch.ops.padded_csr import (
        coo_to_padded_csr, transpose_csr,
    )

    rng = np.random.default_rng(seed)
    ext = 600.0 * float(np.sqrt(n_tx / 50_000))
    pos = rng.uniform(0, ext, (n_tx, 2)).astype(np.float32)
    pos = pos[_strip_major_order(pos)]
    src, dst = kdtree_neighbors(pos, max_k=5, max_dist=5.0)
    tt = coo_to_padded_csr(dst, src, n_dst=n_tx, pad_to_multiple=8)
    return tt, transpose_csr(tt, n_src=n_tx)


def helper_calls(n_tx: int) -> dict:
    """Phase 13's calls by name: every sparse-op helper of ``ops`` that
    no main path runs, forward, then the backwards of ``take_rows``,
    ``csr_gather_t`` and ``csr_spmm`` to their source rows through
    ``torch.autograd.grad`` (each source row's gradient sums the few
    slots that read it; the weights' gradient of ``csr_spmm``, a
    128-term sum whose order the device picks, is held against JAX on
    the CPU by ``tests/test_torch_port_ops_helpers.py``).
    Each takes a dict of tensors on one device (``helper_inputs``) and
    the tt table and its transpose there."""
    import torch

    from segger_tpu_torch import ops
    from segger_tpu_torch.ops.gather_agg import take_rows

    def grad(out, wrt, ct):
        return torch.autograd.grad(out, wrt, ct)

    def leaf(t):
        return t.detach().requires_grad_()

    return {
        "csr_spmm": lambda t, c, ct: ops.csr_spmm(t["x"], c),
        "csr_spmm (N, K)": lambda t, c, ct: ops.csr_spmm(t["x"], c, t["w2"]),
        "csr_spmm (N, K, H)": lambda t, c, ct: ops.csr_spmm(t["x"], c,
                                                            t["w3"]),
        "csr_sddmm": lambda t, c, ct: ops.csr_sddmm(t["x"], t["xd"], c),
        "row_gather_1d": lambda t, c, ct: ops.row_gather_1d(t["table"],
                                                            t["pos"]),
        "take_rows": lambda t, c, ct: take_rows(t["x"], t["src"]),
        "csr_gather_t": lambda t, c, ct: ops.csr_gather_t(t["x"], c, ct),
        "segment_sum": lambda t, c, ct: ops.segment_sum(t["msg"], t["dst"],
                                                        n_tx),
        "segment_max": lambda t, c, ct: ops.segment_max(t["msg"], t["dst"],
                                                        n_tx),
        "segment_softmax": lambda t, c, ct: ops.segment_softmax(
            t["logits"], t["dst"], n_tx),
        "take_rows backward": lambda t, c, ct: grad(
            take_rows(x := leaf(t["x"]), t["src"]), x, t["ct_rows"]),
        "csr_gather_t backward": lambda t, c, ct: grad(
            ops.csr_gather_t(x := leaf(t["x"]), c, ct), x, t["ct_gather"]),
        "csr_spmm (N, K, H) backward": lambda t, c, ct: grad(
            ops.csr_spmm(x := leaf(t["x"]), c, t["w3"]), x, t["ct_spmm"]),
    }


def helper_inputs(tt, n_bd: int, heads: int, hc: int, seed=SEED) -> dict:
    """Phase 13's inputs on the host, made with numpy from ``seed``:
    source and destination rows (F = ``hc``), per-slot weights of both
    forms, a 1-D table of ``n_bd`` rows and positions that reach into
    its 128-row pad, per-edge messages and logits of the table's COO
    form, and the backwards' cotangents."""
    import numpy as np
    import torch

    from segger_tpu_torch.ops.padded_csr import padded_csr_to_coo

    rng = np.random.default_rng(seed)
    n_tx = tt.n_dst
    dst, src = padded_csr_to_coo(tt)
    m_pad = -(-n_bd // 128) * 128
    floats = {"x": (n_tx, hc), "xd": (n_tx, hc), "w2": tt.idx.shape,
              "w3": (*tt.idx.shape, heads), "table": (n_bd,),
              "msg": (dst.size, hc), "logits": (dst.size, heads),
              "ct_rows": (src.size, hc), "ct_gather": (*tt.idx.shape, hc),
              "ct_spmm": (n_tx, heads, hc)}
    out = {k: torch.from_numpy(rng.standard_normal(shape, np.float32))
           for k, shape in floats.items()}
    out["pos"] = torch.from_numpy(rng.integers(0, m_pad, n_tx,
                                               dtype=np.int32))
    out["dst"], out["src"] = torch.from_numpy(dst), torch.from_numpy(src)
    return out


def helper_err(got, want, where: str) -> float:
    """Largest difference of two outputs (tensors or tuples of them);
    raises unless integers are equal and floats within ``HELPER_ATOL``
    + ``HELPER_RTOL`` of the reference's magnitude, infinities in the
    same places."""
    import torch

    if isinstance(want, (tuple, list)):
        return max(helper_err(g, w, where) for g, w in zip(got, want))
    got = got.detach().cpu()
    want = want.detach()
    if not want.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{where}: integer outputs differ")
        return 0.0
    inf = torch.isinf(want)
    if not (torch.equal(torch.isinf(got), inf)
            and torch.equal(got[inf], want[inf])):
        raise AssertionError(f"{where}: infinities differ")
    err = (got[~inf] - want[~inf]).abs()
    if not (err <= HELPER_ATOL + HELPER_RTOL * want[~inf].abs()).all():
        raise AssertionError(f"{where}: err {err.max().item()}")
    return err.max().item() if err.numel() else 0.0


def drive_helpers(device=None, n_tx=N_BENCH, n_bd=2_500, heads=2, hc=128,
                  seed=SEED) -> dict:
    """Phase 13: every sparse-op helper of ``ops`` that no main path runs
    (``helper_calls``), on ``device`` (``cuda:0`` by default) and on the
    CPU from the same inputs, over ``bench.py::build_tile``'s tt table
    (``helper_tile``) and its COO form, in float32 at F = ``hc``, H =
    ``heads``.  Each must agree with its CPU run (``helper_err``), the
    COO form read back from the device table must equal the host's, and
    no kernel wrapper may count a launch.  Returns each helper's error
    and, on a CUDA device, its ``cuda_ms``."""
    import numpy as np
    import torch

    from segger_tpu_torch.ops.padded_csr import padded_csr_to_coo

    device = torch.device(device or "cuda:0")
    before = read_counts()
    tt, tt_t = helper_tile(n_tx, seed)
    host = helper_inputs(tt, n_bd, heads, hc, seed)
    on = {k: v.to(device) for k, v in host.items()}
    c, ct = tt.to(device), tt_t.to(device)
    c_cpu, ct_cpu = tt.to("cpu"), tt_t.to("cpu")
    rec = {}
    for name, call in helper_calls(n_tx).items():
        err = helper_err(call(on, c, ct), call(host, c_cpu, ct_cpu), name)
        rec[name] = {"max_abs_err": err, "cuda_ms": (
            cuda_ms(lambda: call(on, c, ct), 10)
            if device.type == "cuda" else None)}
    coo = padded_csr_to_coo(c)
    if not all(np.array_equal(a, b) for a, b in zip(
            coo, padded_csr_to_coo(tt))):
        raise AssertionError("padded_csr_to_coo of the device table")
    if read_counts() != before:
        raise AssertionError("the helpers launched a kernel wrapper")
    return {"n": n_tx, "k": tt.k, "edges": int(coo[0].size), "f": hc,
            "heads": heads, "n_table": n_bd, "helpers": rec}


def whole_slide_only(card) -> int:
    """``--whole-slide``: phase 7's pipeline run for its graph and
    weights, then phases 10, 11 and 12, with no timing of kernels; on a
    host of several cards this holds the 4-strip runs and the tile-data-
    parallel fit and predict over the cards against one card, runs
    ``segment --devices 4`` with four cards, and one NCCL rank a card
    against one process over the cards, at a fraction of the full
    script's chip time."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as out_dir:
        pipe = drive_pipeline(out_dir)
    with tempfile.TemporaryDirectory() as work_dir:
        ws = drive_whole_slide(work_dir, pipe["graph"], pipe["state"],
                               pipe["truth"], pipe["table"])
    print_whole_slide(ws, pipe["n_tx"], pipe["n_bd"], card)
    with tempfile.TemporaryDirectory() as work_dir:
        td = drive_tile_dp(work_dir, pipe["graph"], pipe["tree"],
                           pipe["truth"])
    print_tile_dp(td, card)
    multiprocess_phase(pipe["graph"], pipe["state"], card)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv) -> int:
    if "--rank" in argv:
        return rank_main(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from segger_tpu_torch.data.partition import (
        build_tiling, make_fit_tiles, make_predict_tiles,
    )
    from segger_tpu_torch.models.positional import dense
    from segger_tpu_torch.ops import _build
    from segger_tpu_torch.ops.banded import (
        BLOCK, WINDOW, band_graph, banded_edge_stage,
    )
    from segger_tpu_torch.ops.gatv2_attn import gatv2_attention
    from segger_tpu_torch.ops.padded_csr import PaddedCSR
    from segger_tpu_torch.ops.postgather import edge_stage_fwd
    from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

    card = gpu_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build (the CUDA kernels, one nvcc each, started
    # together; meanwhile the host's native spatial core, one g++)
    from segger_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        host = ex.submit(native.load)
        report = _build.build()
        host.result()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(report)} and the native core "
          f"({native.library_path().name})")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    if "--whole-slide" in argv:
        return whole_slide_only(card)

    # -- host planning of the slide (gives the widths of the real tiles)
    t0 = time.perf_counter()
    graph = synthetic_slide()
    tree = build_tiling(graph, nodes_per_tile=50_000)
    specs = make_predict_tiles(graph, tree, margin=20.0)
    fit_specs = make_fit_tiles(graph, tree, margin=20.0)
    cfg = TrainConfig()
    trainer = SeggerTrainer(graph, cfg)
    plans = trainer._batch_plans(specs, use_xlo=True)
    bucket = plans[0][1]
    train_tiles, val_tiles = trainer.split_tiles(fit_specs)
    fit_plans = trainer._batch_plans(
        train_tiles, shuffle=True, rng=trainer.epoch_streams(0)[0])
    val_plans = trainer._batch_plans(val_tiles)
    fit_bucket = fit_plans[0][1]
    print(f"slide: {graph.n_tx} tx, {graph.n_bd} cells, {len(specs)} "
          f"predict tiles, {len(plans)} batches, bucket {bucket}; "
          f"{len(fit_specs)} fit tiles ({len(train_tiles)} train, "
          f"{len(val_tiles)} val), {len(fit_plans)} train and "
          f"{len(val_plans)} val batches per epoch, bucket {fit_bucket}; "
          f"host {time.perf_counter() - t0:.1f} s")
    if not (bucket.n_xlo and bucket.n_lo):
        raise AssertionError("predict bucket lost its degree segments")
    if not fit_bucket.n_lo or fit_bucket.n_xlo:
        raise AssertionError("fit bucket is not the lo + hi split")

    # -- phase 2: kernels against their plain versions.  (a) N = 50,000
    # rows at the real tiles' widths, random tables
    rng = np.random.default_rng(SEED)
    heads, hc = cfg.n_heads, cfg.n_heads * cfg.hidden_channels
    bf16, f32 = torch.bfloat16, torch.float32
    checks = []
    for k in sorted({bucket.k_xlo, bucket.k_lo, bucket.k_tt, bucket.k_tb}):
        idx, mask = random_table(N_BENCH, k, N_BENCH, rng)
        for dt in (bf16, f32):
            checks.append(("K1", "N=50000", check_edge_stage(
                idx, mask, N_BENCH, dt, rng, heads, hc)))
    for k in sorted({fit_bucket.k_lo, fit_bucket.k_tt, fit_bucket.k_tb}):
        idx, mask = random_table(N_BENCH, k, N_BENCH, rng)
        dts = (bf16, f32) if k == fit_bucket.k_tt else (bf16,)
        for dt in dts:
            checks.append(("K2", "N=50000", check_edge_stage(
                idx, mask, N_BENCH, dt, rng, heads, hc, "prng")))
            for mode in ("prng", "nokeep"):
                checks.append(("K3", "N=50000", check_edge_stage_bwd(
                    idx, mask, N_BENCH, dt, rng, heads, hc, mode)))
        if k == fit_bucket.k_tt:
            checks.append(("K4", "N=50000", check_edge_stage(
                idx, mask, N_BENCH, bf16, rng, heads, hc, "keep")))
            checks.append(("K4", "N=50000", check_edge_stage_bwd(
                idx, mask, N_BENCH, bf16, rng, heads, hc, "keep")))
    idx, mask = random_table(N_BENCH, bucket.k_cand, 2_500, rng)
    checks.append(("K5", "N=50000", check_score(
        idx, mask, 2_500, rng, f=cfg.out_channels)))
    # (b) the launches the main paths make on their first tile, on that
    # tile's own tables: one layer's tt segments and tb, and scoring
    tile = first_tile(trainer, plans[0])
    segs = tile_tables(tile)
    for name, i, m in segs:
        checks.append(("K1", f"tile {name}", check_edge_stage(
            i, m, tile.n_tx, bf16, rng, heads, hc)))
    checks.append(("K5", "tile cand", check_score(
        tile.cand.idx, tile.cand.mask, tile.n_bd, rng,
        f=cfg.out_channels)))
    ttile = first_tile(trainer, fit_plans[0])
    for name, i, m in tile_tables(ttile):
        where = f"train tile {name}"
        checks.append(("K2", where, check_edge_stage(
            i, m, ttile.n_tx, bf16, rng, heads, hc, "prng")))
        for mode in ("prng", "nokeep"):
            checks.append(("K3", where, check_edge_stage_bwd(
                i, m, ttile.n_tx, bf16, rng, heads, hc, mode)))
        checks.append(("K4", where, check_edge_stage(
            i, m, ttile.n_tx, bf16, rng, heads, hc, "keep")))
        checks.append(("K4", where, check_edge_stage_bwd(
            i, m, ttile.n_tx, bf16, rng, heads, hc, "keep")))
    # (c) the fused attention (K6) at N = 50,000 at the real tiles'
    # widths, and the banded edge stage (K7) on the slide-wide
    # strip-major tt table, random features
    for k in sorted({bucket.k_xlo, bucket.k_lo, bucket.k_tt, bucket.k_tb}):
        idx, mask = random_table(N_BENCH, k, N_BENCH, rng)
        for dt in (bf16, f32):
            xl, xr, att = _features(idx, N_BENCH, dt, rng, heads, hc)[:3]
            bias = torch.randn(hc, device="cuda")
            checks.append(("K6", "N=50000", check_attention(
                idx, mask, xl, xr, att, bias, heads)[0]))
    order, slide_csr, banded, span, band_s = strip_major_table(graph)
    lo, idxl, bmask = (torch.from_numpy(a).cuda() for a in banded)
    n_pad = idxl.shape[0]
    print(f"K7 band: {graph.n_tx} rows in {lo.numel()} blocks of "
          f"{BLOCK}, widest block span {span} rows (window {WINDOW}), "
          f"band_graph {band_s:.3f} s on the host")
    xl, xr, att = _features(idxl, graph.n_tx, f32, rng, heads, hc)[:3]
    checks.append(("K7", "N=200000 random", check_attention(
        idxl, bmask, xl, xr, att, torch.randn(hc, device="cuda"), heads,
        lo)[0]))
    del xl, xr, att    # keep the later phases' peak memory their own
    for kernel, where, r in checks:
        print(f"{kernel} [{where}] " + json.dumps(r))

    # -- phase 3: the predict path
    n_layers = 2 + cfg.n_mid_layers
    trainer.init()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    got = trainer.predict(specs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    predict_counts = read_counts()
    n_tiles = sum(len(s) for s, _ in plans)
    caps = dict(trainer.captures)
    print(f"predict: {n_tiles} tiles, {len(plans)} batches, "
          f"{got['row_index'].size} transcripts, "
          f"{int((got['cell_encoding'] >= 0).sum())} assigned, "
          f"wall {wall:.3f} s (the capture included), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"captures {caps}, launches {predict_counts}")
    if caps != {"train": 0, "eval": 0, "predict": 1}:
        raise AssertionError(f"predict captures {caps}, expected one")
    want = expected_launches(trainer, caps, pplans=plans)
    if predict_counts != want:
        raise AssertionError(f"launches {predict_counts}, expected {want}")
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

    # -- phase 4: the training path, from the same initial weights
    trainer.init()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    caps0 = dict(trainer.captures)
    t0 = time.perf_counter()
    ends = [t0]      # when each epoch (its validation included) ended
    history = trainer.fit(fit_specs, max_epochs=TRAIN_EPOCHS,
                          on_epoch_end=lambda *_: ends.append(
                              time.perf_counter()))
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_counts = read_counts()
    fit_peak = torch.cuda.max_memory_allocated() / 2**20
    for rec in history:
        print("fit epoch " + json.dumps(rec))
    steps = trainer.step_log
    step_s = [sec for _, _, sec in steps]
    fit_caps = {k: n - caps0[k] for k, n in trainer.captures.items()}
    by_epoch = [float(np.median([sec for ep, _, sec in steps[1:]
                                 if ep == e])) for e in range(TRAIN_EPOCHS)]
    print(f"fit: {TRAIN_EPOCHS} epochs, {len(steps)} steps, wall "
          f"{fit_wall:.3f} s, step wall first (with its capture) "
          f"{step_s[0]:.4f} s, median of the rest "
          f"{float(np.median(step_s[1:])):.4f} s, by epoch {by_epoch} s "
          f"(all "
          f"{[round(x, 4) for x in step_s]}), max_memory_allocated "
          f"{fit_peak:.1f} MiB, captures {fit_caps}, launches {fit_counts}")
    if not (fit_caps["predict"] == 0 and 1 <= fit_caps["train"]
            <= TRAIN_EPOCHS and fit_caps["eval"] == 1):
        raise AssertionError(f"fit captures {fit_caps}")
    want = expected_launches(trainer, fit_caps, steps=len(steps),
                             epochs=TRAIN_EPOCHS, fit_plans=fit_plans,
                             val_plans=val_plans)
    if fit_counts != want:
        raise AssertionError(f"fit launches {fit_counts}, expected {want}")
    if len(steps) != TRAIN_EPOCHS * len(fit_plans) or not all(
            np.isfinite(v) for rec in history for v in rec.values()):
        raise AssertionError("fit: wrong step count or non-finite losses")

    # -- K4's own path: the op in keep mode, forward and backward
    reset_counts()
    n_keep = drive_keep_op(ttile, heads, hc, bf16, rng)
    keep_counts = read_counts()
    print(f"keep-mode op: {n_keep} launches of one layer, launches "
          f"{keep_counts}")
    if keep_counts["fwd"]["keep"] != n_keep or \
            keep_counts["bwd"]["keep"] != n_keep:
        raise AssertionError(f"keep-mode launches {keep_counts}")

    # -- phase 4b: the first epoch again on the card, eagerly, from the
    # same initial weights and generators
    eager = SeggerTrainer(graph, cfg)
    eager.init()
    e_train, _ = eager.split_tiles(fit_specs)
    erng, gen = eager.epoch_streams(0)
    weights = eager.weights(0, TRAIN_EPOCHS)
    reset_counts()
    eager_loss, eager_s = [], []
    for p in eager._batch_plans(e_train, shuffle=True, rng=erng):
        batch = eager._build_batch(p, cache=False)
        t0 = time.perf_counter()
        eager_loss.append(eager.train_step(batch.to("cuda"), gen,
                                           weights)[0])
        eager_s.append(time.perf_counter() - t0)
    eager_counts = read_counts()
    eager_want = expected_launches(
        eager, dict.fromkeys(eager.captures, 0), steps=len(eager_loss),
        fit_plans=fit_plans)
    del eager
    graph_loss = [rec[0] for ep, rec, _ in steps if ep == 0]
    rel = [abs(g - e) / abs(e) for g, e in zip(graph_loss, eager_loss)]
    print(f"eager epoch on the card: {len(eager_loss)} steps, step wall "
          f"median {float(np.median(eager_s[1:])):.4f} s; losses graphed "
          f"{graph_loss} eager {eager_loss}; first step equal: "
          f"{graph_loss[0] == eager_loss[0]}; worst relative step diff "
          f"{max(rel):.3e} (need <= {GRAPH_STEP_RTOL}); launches "
          f"{eager_counts}")
    if len(eager_loss) != len(graph_loss) or graph_loss[0] != eager_loss[0] \
            or max(rel) > GRAPH_STEP_RTOL:
        raise AssertionError("graphed and eager training disagree")
    if eager_counts != eager_want:
        raise AssertionError(f"eager epoch launches {eager_counts}, "
                             f"expected {eager_want}")

    # -- phase 4c: the same fit from the same initial weights with the
    # loss rows read back SCAN_STEPS steps at a time
    scan = SeggerTrainer(graph, dataclasses.replace(cfg,
                                                    scan_steps=SCAN_STEPS))
    scan.init()
    s_ends = [time.perf_counter()]
    scan.fit(fit_specs, max_epochs=TRAIN_EPOCHS,
             on_epoch_end=lambda *_: s_ends.append(time.perf_counter()))
    scan_loss = [rec[0] for _, rec, _ in scan.step_log]
    del scan
    fit_loss = [rec[0] for _, rec, _ in steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(scan_loss, fit_loss)]
    print(f"scan_steps={SCAN_STEPS} fit: {len(scan_loss)} steps, epoch "
          f"walls {np.diff(s_ends).tolist()} s against scan_steps=0's "
          f"{np.diff(ends).tolist()} s (validation included); worst "
          f"relative step diff to scan_steps=0 {max(rel):.3e} (need <= "
          f"{GRAPH_STEP_RTOL})")
    if len(scan_loss) != len(fit_loss) or max(rel) > GRAPH_STEP_RTOL:
        raise AssertionError("scan_steps changed the training losses")

    # -- phase 5: the first training steps again on the CPU
    cpu = SeggerTrainer(graph, cfg, device="cpu")
    cpu.init()
    c_train, _ = cpu.split_tiles(fit_specs)
    erng, gen = cpu.epoch_streams(0)
    weights = cpu.weights(0, TRAIN_EPOCHS)
    t0 = time.perf_counter()
    cpu_loss = [
        cpu.train_step(cpu._build_batch(p, cache=False).to("cpu"), gen,
                       weights)[0]
        for p in cpu._batch_plans(c_train, shuffle=True,
                                  rng=erng)[:CPU_STEPS]
    ]
    cpu_wall = time.perf_counter() - t0
    gpu_loss = [rec[0] for _, rec, _ in steps[:CPU_STEPS]]
    rel = [abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss)]
    mean_rel = abs(np.mean(gpu_loss) - np.mean(cpu_loss)) / abs(
        np.mean(cpu_loss))
    print(f"cpu train: {CPU_STEPS} steps in {cpu_wall:.1f} s; losses gpu "
          f"{gpu_loss} cpu {cpu_loss}; relative diff per step {rel} "
          f"(first need <= {FIRST_STEP_RTOL}), of the mean {mean_rel:.3e} "
          f"(need <= {MEAN_STEP_RTOL})")
    if rel[0] > FIRST_STEP_RTOL or mean_rel > MEAN_STEP_RTOL:
        raise AssertionError("GPU and CPU training losses disagree")
    if "--profile" in argv:
        profile_train_step(trainer, fit_plans[0],
                           ROOT / "chiprun_out" / "train_profile.txt")

    # -- phase 6: the forward-only path.  The initialized encoder in f32,
    # its first tt conv on the slide's layer-0 features over the
    # slide-wide strip-major table: K1 + bias, K6, K7 and the unfused
    # conv; then the encoder's capture forward on the first predict tile
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gpu32 = SeggerTrainer(graph, cfg32)
    gpu32.init()
    enc = gpu32.model.eval()
    conv = enc.conv_0.tt
    table = slide_csr.to("cuda")
    n = graph.n_tx
    tile32 = gpu32._build_batch(plans[0], cache=False).to(
        "cuda").map_arrays(lambda a: a[0])
    reset_counts()
    with torch.no_grad():
        x0 = F.gelu(torch.cat([
            enc.gene_embedding(torch.from_numpy(graph.tx_gene[order]).cuda()),
            enc.pos_emb(torch.from_numpy(graph.tx_pos[order]).cuda(),
                        torch.ones(n, dtype=torch.bool, device="cuda"))],
            dim=-1))
        xl, xr = dense(conv.lin_l, x0), dense(conv.lin_r, x0)
        att, bias = conv.att[0], conv.bias
        k1 = edge_stage_fwd(xl, xr, att, table.idx, table.mask,
                            heads)[0] + bias
        k6 = gatv2_attention(xl, xr, table.idx, table.mask, att, bias, heads)
        xr_pad = torch.cat([xr, xr.new_zeros(n_pad - n, hc)])
        k7 = banded_edge_stage(xl, xr_pad, lo, idxl, bmask, att, bias,
                               heads)[:n]
        inter = {}
        unfused = conv(x0, x0, table, intermediates=inter)
        fused_emb = enc(tile32)
        cap_inter = {}
        cap_emb = enc(tile32, capture_attention=True,
                      intermediates=cap_inter)
    torch.cuda.synchronize()
    fwd_counts = read_counts()
    want = {"fwd": {"nokeep": 1 + n_layers * len(segs), "prng": 0,
                    "keep": 0},
            "bwd": {"nokeep": 0, "prng": 0, "keep": 0}, "score": 0,
            "attn": 1, "banded": 1}
    print(f"forward-only path: launches {fwd_counts}")
    if fwd_counts != want:
        raise AssertionError(f"forward-only launches {fwd_counts}, "
                             f"expected {want}")
    errs = {}
    for name, a in (("K6", k6), ("K7", k7), ("unfused", unfused)):
        err = (a - k1).abs()
        errs[name] = err.max().item()
        if not (err <= 1e-5 + 1e-5 * k1.abs()).all():
            raise AssertionError(f"forward-only path: {name} differs from "
                                 f"K1 + bias by {errs[name]}")
    alpha = inter["attention"]
    valid = table.mask.any(1)
    sum_err = (alpha[valid].sum(1) - 1).abs().max().item()
    if sum_err > 1e-5 or (alpha[~valid] != 0).any():
        raise AssertionError(f"unfused attention sums off 1 by {sum_err}")
    cpu32 = SeggerTrainer(graph, cfg32, device="cpu")
    cpu32.init()
    with torch.no_grad():
        cpu_emb = cpu32.model.eval()(
            cpu32._build_batch(plans[0], cache=False).to("cpu").map_arrays(
                lambda a: a[0]), capture_attention=True)
    emb_err = {key: ((cap_emb[key] - fused_emb[key]).abs().max().item(),
                     (cap_emb[key].cpu() - cpu_emb[key]).abs().max().item())
               for key in ("tx", "bd")}
    n_att = sum(key.endswith("/attention") for key in cap_inter)
    tile_band = band_graph(PaddedCSR(tile32.tt.idx.cpu().numpy(),
                                     tile32.tt.mask.cpu().numpy()),
                           n_src=tile32.n_tx)[3]
    print(f"forward-only path: {n} rows, K={table.idx.shape[1]}, max abs "
          f"diff to K1 + bias {errs} (need <= 1e-5 + 1e-5 |x|); unfused "
          f"attention sums to 1 within {sum_err:.3e}.  Capture forward on "
          f"the first predict tile ({tile32.n_tx} tx, {n_att} attentions): "
          f"max abs diff (to the fused forward, to the CPU capture) "
          f"{emb_err} (need <= 1e-5, 1e-4); band_graph accepts the tile's "
          f"degree-bucketed tt table (K={tile32.tt.idx.shape[1]}): "
          f"{tile_band}")
    if n_att != 2 * n_layers or any(
            a > 1e-5 or b > 1e-4 for a, b in emb_err.values()):
        raise AssertionError("capture forward disagrees")
    # the kernels at the forward-only path's inputs, against their plain
    # versions, timed
    checks.append(("K6", "slide", check_attention(
        table.idx, table.mask, xl, xr, att, bias, heads)[0]))
    checks.append(("K7", "slide", check_attention(
        idxl, bmask, xl, xr_pad, att, bias, heads, lo)[0]))
    for kernel, where, r in checks[-2:]:
        print(f"{kernel} [{where}] " + json.dumps(r))

    # -- phase 7: the pipeline users run, transcripts and polygons to the
    # segmentation table, at PipelineConfig() and TrainConfig() widths
    import tempfile

    with tempfile.TemporaryDirectory() as out_dir:
        pipe = drive_pipeline(out_dir)
    pipe_counts = pipe["counts"]
    walls = {k: round(v, 3) for k, v in pipe["walls"].items()}
    print(f"pipeline: make_synthetic({PIPE_CELLS} cells, {PIPE_GENES} "
          f"genes, {PIPE_TX_PER_CELL} tx a cell) -> {pipe['n_tx']} tx, "
          f"{pipe['n_bd']} cells, {pipe['n_tt']} tt edges, "
          f"{pipe['n_cand']} candidates ({pipe['n_with_cand']} tx with one "
          f"or more, {pipe['n_multi']} with two or more); "
          f"{pipe['n_tiles'][0]} fit and {pipe['n_tiles'][1]} predict "
          f"tiles; {pipe['epochs']} epochs, {pipe['steps']} steps; "
          f"save_anndata=False (this machine has no h5py)")
    print(f"pipeline walls (s): {json.dumps(walls)}; predict_streaming + "
          f"write_dense {pipe['stream_s']:.3f} s; max_memory_allocated "
          f"{pipe['peak_mib']:.1f} MiB above the earlier phases' "
          f"tensors; captures {pipe['captures']}")
    for rec in pipe["history"]:
        print("pipeline fit epoch " + json.dumps(rec))
    print(f"pipeline accuracy: {pipe['accuracy']:.4f} of the transcripts "
          f"of a cell (need > {MIN_ACCURACY}); on the {pipe['n_multi']} "
          f"with two or more candidate cells {pipe['accuracy_multi']:.4f} "
          f"trained, {pipe['accuracy_multi_init']:.4f} with the initial "
          f"weights (recorded, not held); write_dense equals write")
    q = pipe["quality"]
    print("pipeline segmentation_report against the true cells: "
          + json.dumps(q["report"]) + f" ({q['report_s']:.3f} s)")
    print(f"pipeline contamination QC of the table's {q['cells']} cells "
          f"(calculate_contamination, reference from "
          f"expression_summary_from_anndata over the synthetic cell types): "
          f"median percent_contamination "
          f"{q['median_percent_contamination']:.4f}, mean "
          f"{q['mean_percent_contamination']:.4f} "
          f"({q['contamination_s']:.3f} s)")
    print(f"pipeline launches {pipe_counts}")
    if not (pipe["captures"]["predict"] == 1 and pipe["captures"]["eval"]
            == 1 and 1 <= pipe["captures"]["train"] <= PIPE_EPOCHS):
        raise AssertionError(f"pipeline captures {pipe['captures']}")
    if pipe_counts != pipe["want"]:
        raise AssertionError(f"pipeline launches {pipe_counts}, expected "
                             f"{pipe['want']}")
    # the kernels against their plain versions on the pipeline's own
    # first tiles: K1 on the predict tile's tables, K5 on its variable-K
    # candidate table with its empty rows, K2 and K3 on the training tile
    ptile, ftile = pipe["tiles"]
    pcfg = pipe["cfg"]
    p_heads = pcfg.n_heads
    p_hc = pcfg.n_heads * pcfg.hidden_channels
    n_checked = len(checks)
    for name, i, m in tile_tables(ptile):
        checks.append(("K1", f"pipeline tile {name}", check_edge_stage(
            i, m, ptile.n_tx, bf16, rng, p_heads, p_hc)))
    checks.append(("K5", "pipeline tile cand", check_score(
        ptile.cand.idx, ptile.cand.mask, ptile.n_bd, rng,
        f=pcfg.out_channels)))
    for name, i, m in tile_tables(ftile):
        where = f"pipeline train tile {name}"
        checks.append(("K2", where, check_edge_stage(
            i, m, ftile.n_tx, bf16, rng, p_heads, p_hc, "prng")))
        for mode in ("prng", "nokeep"):
            checks.append(("K3", where, check_edge_stage_bwd(
                i, m, ftile.n_tx, bf16, rng, p_heads, p_hc, mode)))
    for kernel, where, r in checks[n_checked:]:
        print(f"{kernel} [{where}] " + json.dumps(r))
    del ptile, ftile, pipe["tiles"]

    # -- phase 8: the command line users run, on phase 7's slide written
    # as a raw Xenium directory: segment, then export
    with tempfile.TemporaryDirectory() as work_dir:
        cli = drive_cli(work_dir, graph=pipe["graph"])
    cli_counts = cli["counts"]
    print(f"cli: write_xenium_like -> segger-tpu-torch segment "
          f"--no-anndata --max-epochs {cli['epochs']} --seed {SEED} -> "
          f"{cli['n_tx']} tx, {cli['n_bd']} cells, {cli['n_tiles'][0]} fit "
          f"and {cli['n_tiles'][1]} predict tiles, {cli['steps']} steps; "
          f"the graph from the vendor files equals phase 7's; export "
          f"transcripts boundaries: {cli['n_rings']} rings of 3 or more "
          f"vertices for {cli['n_kept']} kept cells, boundary pools "
          f"{cli['pools']}, {len(os.sched_getaffinity(0))} cores")
    print("cli walls (s): " + json.dumps(
        {k: round(v, 3) for k, v in cli["walls"].items()}))
    for rec in cli["history"]:
        print("cli fit epoch " + json.dumps(rec))
    print(f"cli accuracy: {cli['accuracy']:.4f} of the transcripts of a "
          f"cell (need > {MIN_ACCURACY})")
    print(f"cli launches {cli_counts}")
    if not (cli["captures"]["predict"] == 1 and cli["captures"]["eval"]
            == 1 and 1 <= cli["captures"]["train"] <= PIPE_EPOCHS):
        raise AssertionError(f"cli captures {cli['captures']}")
    if cli_counts != cli["want"]:
        raise AssertionError(f"cli launches {cli_counts}, expected "
                             f"{cli['want']}")
    if cli["pools"] != {"fork": 0, "spawn": 1}:
        raise AssertionError(f"export boundary pools {cli['pools']}: the "
                             "spawn pool did not run")

    # -- phase 9: the out-of-core whole-slide path on phase 7's slide:
    # columnar transcripts, the memmapped graph plane, fit and
    # predict_streaming on the card, the --low-memory --graph-cache
    # command line, and the native spatial core against its plain versions
    table7 = pipe.pop("table")
    with tempfile.TemporaryDirectory() as work_dir:
        ooc = drive_outofcore(work_dir, graph=pipe["graph"], table=table7)
    ooc_counts, ooc_cli = ooc["counts"], ooc["cli"]
    print(f"out-of-core: phase 7's slide as ColumnarTranscripts in "
          f"{COLUMNAR_CHUNKS} spooled chunks -> {ooc['n_tx']} tx, "
          f"{ooc['n_bd']} cells; the columnar graph equals phase 7's; "
          f"plane memmapped -> {ooc['n_tiles'][0]} fit and "
          f"{ooc['n_tiles'][1]} predict tiles, {ooc['steps']} steps, "
          f"predict_streaming + write_dense; accuracy "
          f"{ooc['accuracy']:.4f}, agreement with phase 7's table "
          f"{ooc['agreement']:.4f} (need >= {MIN_TABLE_AGREEMENT})")
    print(f"out-of-core walls (s): " + json.dumps(
        {k: round(v, 3) for k, v in ooc["walls"].items()}) + "; substages "
        + json.dumps({k: round(v, 3) for k, v in ooc["substages"].items()})
        + f"; peak_rss_gb {ooc['peak_rss_gb']:.2f}; over the phase, RSS "
        f"peak {gb(ooc['rss_sampled_gb'])}, anonymous RSS peak "
        f"{gb(ooc['anon_rss_gb'])} (sampled every 0.25 s); "
        f"max_memory_allocated "
        f"{ooc['peak_mib']:.1f} MiB above the earlier phases' tensors; "
        f"captures {ooc['captures']} | {card}")
    for rec in ooc["history"]:
        print("out-of-core fit epoch " + json.dumps(rec))
    print(f"out-of-core launches {ooc_counts}")
    print(f"out-of-core cli: segment --low-memory --graph-cache "
          f"--prepare-only in a child process, {ooc_cli['prepare_s']:.3f} s "
          f"with the process start, no CUDA initialized, walls "
          + json.dumps({k: round(v, 3)
                        for k, v in ooc_cli["prepare_walls"].items()})
          + "; then segment --low-memory --graph-cache here: walls "
          + json.dumps({k: round(v, 3) for k, v in ooc_cli["walls"].items()})
          + f", the plane's graph, accuracy {ooc_cli['accuracy']:.4f}, "
          f"launches {ooc_cli['counts']} | {card}")
    br, nc = ooc["branches"], ooc["neighbor_counts"]
    print(f"native core (host of this card, {len(os.sched_getaffinity(0))} "
          f"cores): phase 7's graph stage, {br['n_tt']} tt and "
          f"{br['n_cand']} candidate edges, equal sets; substage walls (s) "
          f"native {json.dumps(br['walls']['native'])}, KDTree "
          f"{json.dumps(br['walls']['kdtree'])}; common-neighbor counts "
          f"of the {nc['n']}-cell kNN graph ({nc['edges']} entries), "
          f"equal: SpGEMM {nc['spgemm_s']:.4f} s, native "
          f"{nc['native_s']:.4f} s | {card}")
    for where, got, want, caps in (
            ("out-of-core", ooc_counts, ooc["want"], ooc["captures"]),
            ("out-of-core cli", ooc_cli["counts"], ooc_cli["want"],
             ooc_cli["captures"])):
        if not (caps["predict"] == 1 and caps["eval"] == 1
                and 1 <= caps["train"] <= PIPE_EPOCHS):
            raise AssertionError(f"{where} captures {caps}")
        if got != want:
            raise AssertionError(f"{where} launches {got}, expected "
                                 f"{want}")
    # the kernels against their plain versions on this path's first tiles
    ptile, ftile = ooc.pop("tiles")
    n_checked = len(checks)
    for name, i, m in tile_tables(ptile):
        checks.append(("K1", f"out-of-core tile {name}", check_edge_stage(
            i, m, ptile.n_tx, bf16, rng, p_heads, p_hc)))
    checks.append(("K5", "out-of-core tile cand", check_score(
        ptile.cand.idx, ptile.cand.mask, ptile.n_bd, rng,
        f=pcfg.out_channels)))
    for name, i, m in tile_tables(ftile):
        where = f"out-of-core train tile {name}"
        checks.append(("K2", where, check_edge_stage(
            i, m, ftile.n_tx, bf16, rng, p_heads, p_hc, "prng")))
        for mode in ("prng", "nokeep"):
            checks.append(("K3", where, check_edge_stage_bwd(
                i, m, ftile.n_tx, bf16, rng, p_heads, p_hc, mode)))
    for kernel, where, r in checks[n_checked:]:
        print(f"{kernel} [{where}] " + json.dumps(r))
    del ptile, ftile

    # -- phase 10: the whole-slide halo-exchange path on phase 7's graph
    # with its trained weights: predict at 1 strip, 4 strips and a 2x2
    # grid, the surrogate gradient, fit_whole_slide, several cards when
    # there are, and segment --distributed-predict --distributed-train
    graph7, tree7, truth7 = pipe["graph"], pipe.pop("tree"), pipe["truth"]
    state7 = pipe["state"]
    with tempfile.TemporaryDirectory() as work_dir:
        ws = drive_whole_slide(work_dir, pipe.pop("graph"),
                               pipe.pop("state"), pipe.pop("truth"), table7)
    del table7
    ws_counts_sum = {"fwd": dict.fromkeys(("nokeep", "prng", "keep"), 0),
                     "bwd": dict.fromkeys(("nokeep", "prng", "keep"), 0),
                     "score": 0}
    for c in ws["counts"].values():
        for mode in ("nokeep", "prng", "keep"):
            ws_counts_sum["fwd"][mode] += c["fwd"][mode]
            ws_counts_sum["bwd"][mode] += c["bwd"][mode]
        ws_counts_sum["score"] += c["score"]
    print_whole_slide(ws, pipe['n_tx'], pipe['n_bd'], card)
    # the kernels against their plain versions on a shard's own extended
    # tables: the middle strip's of the predict and the training builds,
    # and a grid shard's, whose sources include the y relay
    n_checked = len(checks)

    def cu(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    for name in ("4 strips", "2x2 grid"):
        t = ws["tables"][name]
        for conv in ("tt", "tb"):
            checks.append(("K1", f"whole-slide {name} shard {conv}",
                           check_edge_stage(*map(cu, t[conv]), t["n_tx_ext"],
                                            bf16, rng, p_heads, p_hc)))
        checks.append(("K5", f"whole-slide {name} shard cand", check_score(
            *map(cu, t["cand"]), t["n_bd_ext"], rng, f=pcfg.out_channels,
            dtype=f32)))
    t = ws["tables"]["4 strips training"]
    for conv in ("tt", "tb"):
        where = f"whole-slide train shard {conv}"
        idx, mask = map(cu, t[conv])
        checks.append(("K2", where, check_edge_stage(
            idx, mask, t["n_tx_ext"], bf16, rng, p_heads, p_hc, "prng")))
        for mode in ("prng", "nokeep"):
            checks.append(("K3", where, check_edge_stage_bwd(
                idx, mask, t["n_tx_ext"], bf16, rng, p_heads, p_hc, mode)))
    for kernel, where, r in checks[n_checked:]:
        print(f"{kernel} [{where}] " + json.dumps(r))
    del ws["tables"]

    # -- phase 11: tile data parallelism on phase 7's graph and tiling,
    # one device against a mesh of 4 shards on cuda:0 (and over the cards
    # when there are several), then the kernels on one shard's tiles
    with tempfile.TemporaryDirectory() as work_dir:
        td = drive_tile_dp(work_dir, graph7, tree7, truth7)
    del tree7, truth7
    print_tile_dp(td, card)
    ptile, ftile = td["tiles"]["predict"], td["tiles"]["train"]
    n_checked = len(checks)
    for name, i, m in tile_tables(ptile):
        checks.append(("K1", f"tile-dp shard {name}", check_edge_stage(
            i, m, ptile.n_tx, bf16, rng, p_heads, p_hc)))
    checks.append(("K5", "tile-dp shard cand", check_score(
        ptile.cand.idx, ptile.cand.mask, ptile.n_bd, rng,
        f=pcfg.out_channels)))
    for name, i, m in tile_tables(ftile):
        where = f"tile-dp train shard {name}"
        checks.append(("K2", where, check_edge_stage(
            i, m, ftile.n_tx, bf16, rng, p_heads, p_hc, "prng")))
        for mode in ("prng", "nokeep"):
            checks.append(("K3", where, check_edge_stage_bwd(
                i, m, ftile.n_tx, bf16, rng, p_heads, p_hc, mode)))
    for kernel, where, r in checks[n_checked:]:
        print(f"{kernel} [{where}] " + json.dumps(r))
    del ptile, ftile, td["tiles"]

    # -- phase 12: the whole-slide paths over several processes on phase
    # 7's graph with its trained weights: two gloo ranks on cuda:0, and
    # with several cards one NCCL rank a card
    mps = multiprocess_phase(graph7, state7, card)
    del graph7, state7

    # -- phase 13: the sparse-op helpers no main path runs, on the card
    # against the CPU, over bench.py's tile table
    helpers = drive_helpers()
    print(f"helpers [N={helpers['n']}, K={helpers['k']}, "
          f"{helpers['edges']} edges, F={helpers['f']}, H={helpers['heads']}"
          f", float32, {card}] " + json.dumps(helpers["helpers"]))

    def summary(kernel, tile_prefix, modes=None):
        rs = [r for k, w, r in checks if k == kernel]
        # the checks of that tile ("tile-dp shard ..." is not "tile ...")
        tile_rs = [r for k, w, r in checks if k == kernel
                   and (w == tile_prefix or w.startswith(tile_prefix + " "))
                   and (modes is None or r.get("mode") in modes)]
        return {
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            # one layer's launches on one tile, at the main path's shapes
            "ms": sum(r["ms"] for r in tile_rs),
            "device_ms": sum(r["device_ms"] for r in tile_rs),
            "graph_ms": sum(r["graph_ms"] for r in tile_rs),
            "plain_ms": sum(r["plain_ms"] for r in tile_rs),
            "bound_ms": sum(r["bound_ms"] for r in tile_rs),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in tile_rs) else "operations",
            "shape": " + ".join(f"{r['n']}x{r['k']}" for r in tile_rs),
        }

    def on_pipeline(kernel, tile_prefix, modes=None):
        """One layer's launches on the pipeline's first tile."""
        rec = summary(kernel, tile_prefix, modes)
        del rec["max_abs_err"]      # the kernel's own covers every check
        return rec

    sc_tile = [r for k, w, r in checks if k == "K5"
               and w == "tile cand"][0]
    sc_pipe = [r for k, w, r in checks if k == "K5"
               and w == "pipeline tile cand"][0]
    # device memory a slide-table call takes beyond its output
    slide_extra = {k: r["extra_bytes"] for k, w, r in checks
                   if w == "slide"}
    pg = "segger_tpu/ops/pallas/postgather.py"
    src = "segger_tpu_torch/csrc/"
    kernels = [
        {"name": "edge_stage_fwd", "route": "cuda",
         "source": src + "edge_stage_fwd.cu", "replaces": f"{pg}:175",
         "launches": predict_counts["fwd"]["nokeep"]
         + fit_counts["fwd"]["nokeep"] + fwd_counts["fwd"]["nokeep"]
         + pipe_counts["fwd"]["nokeep"] + cli_counts["fwd"]["nokeep"],
         "launches_by_path": {"predict": predict_counts["fwd"]["nokeep"],
                              "fit": fit_counts["fwd"]["nokeep"],
                              "forward-only": fwd_counts["fwd"]["nokeep"],
                              "pipeline": pipe_counts["fwd"]["nokeep"],
                              "cli": cli_counts["fwd"]["nokeep"]},
         **summary("K1", "tile"), "library_ms": None,
         "pipeline_tile": on_pipeline("K1", "pipeline tile")},
        {"name": "edge_stage_fwd_prng", "route": "cuda",
         "source": src + "edge_stage_fwd.cu", "replaces": f"{pg}:226",
         "launches": fit_counts["fwd"]["prng"] + pipe_counts["fwd"]["prng"]
         + cli_counts["fwd"]["prng"],
         "launches_by_path": {"fit": fit_counts["fwd"]["prng"],
                              "pipeline": pipe_counts["fwd"]["prng"],
                              "cli": cli_counts["fwd"]["prng"]},
         **summary("K2", "train tile"), "library_ms": None,
         "pipeline_tile": on_pipeline("K2", "pipeline train tile")},
        {"name": "edge_stage_bwd", "route": "cuda",
         "source": src + "edge_stage_bwd.cu",
         "replaces": f"{pg}:309", "also_replaces": f"{pg}:334",
         "launches": fit_counts["bwd"]["prng"] + fit_counts["bwd"]["nokeep"]
         + pipe_counts["bwd"]["prng"] + pipe_counts["bwd"]["nokeep"]
         + cli_counts["bwd"]["prng"] + cli_counts["bwd"]["nokeep"],
         "launches_by_path": {"fit": fit_counts["bwd"]["prng"]
                              + fit_counts["bwd"]["nokeep"],
                              "pipeline": pipe_counts["bwd"]["prng"]
                              + pipe_counts["bwd"]["nokeep"],
                              "cli": cli_counts["bwd"]["prng"]
                              + cli_counts["bwd"]["nokeep"]},
         **summary("K3", "train tile", ("prng",)), "library_ms": None,
         "pipeline_tile": on_pipeline("K3", "pipeline train tile",
                                      ("prng",))},
        {"name": "edge_stage_keep", "route": "cuda",
         "source": src + "edge_stage_bwd.cu",
         "also_source": src + "edge_stage_fwd.cu",
         "replaces": f"{pg}:288", "also_replaces": f"{pg}:148",
         "launches": keep_counts["fwd"]["keep"] + keep_counts["bwd"]["keep"],
         "path": "gatv2_edge_stage op in keep mode, forward + backward",
         **summary("K4", "train tile"), "library_ms": None},
        {"name": "score_max", "route": "cuda",
         "source": src + "score.cu",
         "replaces": "segger_tpu/ops/pallas/score.py:60",
         "launches": predict_counts["score"] + pipe_counts["score"]
         + cli_counts["score"],
         "launches_by_path": {"predict": predict_counts["score"],
                              "pipeline": pipe_counts["score"],
                              "cli": cli_counts["score"]},
         **summary("K5", "tile"),
         "library_ms": sc_tile["library_ms"],
         "library_device_ms": sc_tile["library_device_ms"],
         "layout": sc_tile["layout"],
         "pipeline_tile": {**on_pipeline("K5", "pipeline tile"),
                           "library_device_ms": sc_pipe["library_device_ms"],
                           "empty_rows": sc_pipe["empty_rows"]}},
        {"name": "gatv2_attention", "route": "cuda",
         "source": src + "attn_fwd.cu",
         "replaces": "segger_tpu/ops/pallas/gatv2_attn.py:57",
         "launches": fwd_counts["attn"],
         "path": "forward-only path, slide-wide table",
         **summary("K6", "slide"), "extra_bytes": slide_extra["K6"],
         "library_ms": None},
        {"name": "banded_edge_stage", "route": "cuda",
         "source": src + "attn_fwd.cu",
         "replaces": "segger_tpu/ops/pallas/banded.py:112",
         "launches": fwd_counts["banded"],
         "path": "forward-only path, slide-wide banded table",
         **summary("K7", "slide"), "extra_bytes": slide_extra["K7"],
         "library_ms": None},
    ]
    # phase 9's launches and its first tiles' checks
    ooc_paths = {"out-of-core": ooc_counts,
                 "out-of-core cli": ooc_cli["counts"]}
    for rec, get, kernel, prefix, modes in (
            (kernels[0], lambda c: c["fwd"]["nokeep"], "K1",
             "out-of-core tile", None),
            (kernels[1], lambda c: c["fwd"]["prng"], "K2",
             "out-of-core train tile", None),
            (kernels[2], lambda c: c["bwd"]["prng"] + c["bwd"]["nokeep"],
             "K3", "out-of-core train tile", ("prng",)),
            (kernels[4], lambda c: c["score"], "K5", "out-of-core tile",
             None)):
        extra = {path: get(c) for path, c in ooc_paths.items()}
        rec["launches"] += sum(extra.values())
        rec["launches_by_path"].update(extra)
        rec["out_of_core_tile"] = on_pipeline(kernel, prefix, modes)
    # phase 10's launches and its shards' checks
    for rec, n, kernel, prefix, modes in (
            (kernels[0], ws_counts_sum["fwd"]["nokeep"], "K1",
             "whole-slide 4 strips shard", None),
            (kernels[1], ws_counts_sum["fwd"]["prng"], "K2",
             "whole-slide train shard", None),
            (kernels[2], ws_counts_sum["bwd"]["prng"]
             + ws_counts_sum["bwd"]["nokeep"], "K3",
             "whole-slide train shard", ("prng",)),
            (kernels[4], ws_counts_sum["score"], "K5",
             "whole-slide 4 strips shard", None)):
        rec["launches"] += n
        rec["launches_by_path"]["whole-slide"] = n
        rec["whole_slide_shard"] = on_pipeline(kernel, prefix, modes)
    # phase 11's launches, by shard, and its shard's checks
    td_paths = {"tile-dp": ("fit mesh", "predict mesh"),
                "tile-dp one-device": ("fit one device",
                                       "predict one device")}
    for key in td["counts"]:
        if "cards" in key:
            td_paths.setdefault("tile-dp cards", ())
            td_paths["tile-dp cards"] += (key,)
    for rec, get, kernel, prefix, modes in (
            (kernels[0], lambda c: c["fwd"]["nokeep"], "K1",
             "tile-dp shard", None),
            (kernels[1], lambda c: c["fwd"]["prng"], "K2",
             "tile-dp train shard", None),
            (kernels[2], lambda c: c["bwd"]["prng"] + c["bwd"]["nokeep"],
             "K3", "tile-dp train shard", ("prng",)),
            (kernels[4], lambda c: c["score"], "K5", "tile-dp shard",
             None)):
        for path, keys in td_paths.items():
            n = sum(get(td["counts"][k]) for k in keys)
            rec["launches"] += n
            rec["launches_by_path"][path] = n
        if td["cli"] is not None:
            n = get(td["cli"]["counts"])
            rec["launches"] += n
            rec["launches_by_path"]["tile-dp cli"] = n
        rec["tile_dp_by_shard"] = [
            get(f) + get(p) for f, p in zip(td["fit_shards"],
                                            td["predict_shards"])]
        rec["tile_dp_shard"] = on_pipeline(kernel, prefix, modes)
    # phase 12's launches, every rank's
    mp_counts = [multiprocess_counts(mp) for mp in mps]
    for rec, get in ((kernels[0], lambda c: c["fwd"]["nokeep"]),
                     (kernels[1], lambda c: c["fwd"]["prng"]),
                     (kernels[2], lambda c: c["bwd"]["prng"]
                      + c["bwd"]["nokeep"]),
                     (kernels[4], lambda c: c["score"])):
        n = sum(get(c) for c in mp_counts)
        rec["launches"] += n
        rec["launches_by_path"]["multi-process"] = n
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
