#!/usr/bin/env python3
"""The segmentation pipeline on a larger synthetic slide: where its wall
and its host memory go as the slide grows.

Default mode: runs ``chip_smoke.drive_pipeline`` (``chip_smoke.py``'s
phase 7: ``make_synthetic`` at the phase's density of cells,
``ISTPipeline.run`` at ``PipelineConfig(seed=0)`` and ``TrainConfig()``
width for 2 epochs, then the checks of the table) at ``--cells`` cells,
``--genes`` genes and ``--tx-per-cell`` transcripts a cell, and splits
the features and graph stages by timing the functions they call:

- features: ``phenograph`` (cells, then genes), inside it
  ``knn_jaccard_graph`` (the exact kNN up to ``ANN_THRESHOLD`` points,
  the IVF search above with its ``minibatch_kmeans``, then the Jaccard
  weights from the native ``common_neighbor_counts``; with the Jaccard
  graph's largest and mean degree) and ``louvain``;
  the rest is the count matrix, normalisation, the two PCAs and the
  similarity matrices;
- graph: ``transcripts_graph``, ``prediction_graph`` and
  ``segmentation_graph``.

``--low-memory``: the out-of-core path on a slide of the same size from
``make_synthetic_columnar`` (the same generative model, streamed by
chunks of cells into a disk-spooled columnar table): ``ISTPipeline
(columnar).load()``, the graph saved as a plane, then
``chip_smoke.run_plane`` on the plane loaded memmapped (fit,
``predict_streaming``, ``write_dense``) and the checks of the table.

Both modes install a ``StageTimer`` for the library's substages
(``graph.tx_knn``, ``graph.prediction``, ``phenograph.*``,
``plan.tile_bucket``, ``extract.tile``, ...), sample the anonymous
resident memory (``AnonRSSSampler``) and read ``peak_rss_gb``; and both
time the common-neighbor counts of the largest Jaccard graph the run
built (the cells') by the native core (the pipeline's path) and by its
plain version, the SpGEMM, after the run, on the same host.

    python3 tools/pipeline_scale.py --cells 150000 --genes 5000 \
        --tx-per-cell 50 [--low-memory]

Needs one CUDA device; ``--device cpu`` runs the plain versions (small
slides only).  Prints the card's name and power limit, one line a
stage as it ends, and one JSON line with the walls, the substages, the
memory high-water marks, the graph's sizes, the launches, peak device
memory and the accuracies.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def timed(module, name, walls, key, note=None):
    """Wrap ``module.name`` so that each call adds its seconds to
    ``walls[key]`` (and, when ``note`` is given, records what
    ``note(args, result)`` returns under ``walls[key + ' calls']``)."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sec = time.perf_counter() - t0
        walls[key] = walls.get(key, 0.0) + sec
        entry = {"s": sec}
        if note is not None:
            entry.update(note(args, out))
        walls.setdefault(key + " calls", []).append(entry)
        print(f"  {key}: {sec:.3f} s {entry}", flush=True)
        return out

    wrapper.__wrapped__ = fn
    setattr(module, name, wrapper)


def low_memory_run(args, tmp: Path, chip_smoke) -> dict:
    """The ``--low-memory`` path: generate, load, save the plane (the
    prepare phase, with its own anonymous-RSS sampler), then
    ``chip_smoke.run_plane`` on the memmapped plane (the run phase, with
    another) and the checks of the table."""
    import gc

    import numpy as np

    from segger_tpu_torch.data.assemble import save_host_graph_plane
    from segger_tpu_torch.data.synthetic import make_synthetic_columnar
    from segger_tpu_torch.pipeline import ISTPipeline, PipelineConfig
    from segger_tpu_torch.train.trainer import TrainConfig
    from segger_tpu_torch.utils_profiling import AnonRSSSampler

    pcfg = PipelineConfig(seed=chip_smoke.SEED)
    anon = AnonRSSSampler().start()
    t0 = time.perf_counter()
    synth = make_synthetic_columnar(
        n_cells=args.cells, n_genes=args.genes,
        mean_tx_per_cell=args.tx_per_cell,
        extent=400.0 * float(np.sqrt(args.cells / 200)),
        seed=chip_smoke.SEED, spool=tmp / "transcripts_spool")
    walls = {"make-data": time.perf_counter() - t0}
    print(f"  make-data: {walls['make-data']:.3f} s, "
          f"{synth.transcripts.n} tx", flush=True)
    pipe = ISTPipeline(synth.transcripts, synth.boundaries, synth.polygons,
                       pcfg)
    pipe.load()
    walls.update(pipe.walls)
    t0 = time.perf_counter()
    save_host_graph_plane(pipe.graph, tmp / "plane")
    walls["save-plane"] = time.perf_counter() - t0
    gene_names = pipe.adata.var.index.to_numpy().astype(str)
    g = pipe.graph
    sizes = {"n_tx": g.n_tx, "n_bd": g.n_bd, "n_tt": int(g.tt_src.size),
             "n_cand": int(g.cand_src.size)}
    del pipe, g
    gc.collect()
    prepare_anon = anon.stop()
    prepare_rss = anon.peak_rss_gb
    print(f"  prepare: {json.dumps(walls)}, RSS peak "
          f"{chip_smoke.gb(prepare_rss)}, anonymous RSS peak "
          f"{chip_smoke.gb(prepare_anon)}", flush=True)

    anon = AnonRSSSampler().start()
    r = chip_smoke.run_plane(
        tmp / "plane", gene_names, tmp / "out", pcfg,
        TrainConfig(max_epochs=args.epochs), args.device)
    run_anon = anon.stop()
    run_rss = anon.peak_rss_gb
    walls.update(r["walls"])
    tc = np.asarray(synth.truth_code)
    truth = np.where(tc >= 0, synth.transcripts.cell_ids[np.maximum(tc, 0)],
                     "")
    table = chip_smoke.check_table(r["table"], r["graph"], truth,
                                   "low-memory")
    del r["tiles"]
    return {**sizes, "walls": walls, "counts": r["counts"],
            "want": r["want"], "peak_mib": r["peak_mib"],
            "n_tiles": r["n_tiles"], "steps": r["steps"],
            "epochs": args.epochs, "accuracy": table["accuracy"],
            "accuracy_multi": table["accuracy_multi"],
            "n_with_cand": table["n_with_cand"],
            "n_multi": int(table["multi"].size),
            "anon_rss_gb": {"prepare": prepare_anon, "run": run_anon},
            "rss_sampled_gb": {"prepare": prepare_rss, "run": run_rss}}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=150_000)
    ap.add_argument("--genes", type=int, default=5_000)
    ap.add_argument("--tx-per-cell", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--low-memory", action="store_true",
                    help="the out-of-core path: columnar transcripts, the "
                         "memmapped graph plane, predict_streaming")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: CUDA)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("pipeline_scale: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from segger_tpu_torch import native
    from segger_tpu_torch.data import assemble, clustering, features, pca
    from segger_tpu_torch.utils import peak_rss_gb
    from segger_tpu_torch.utils_profiling import (
        AnonRSSSampler, StageTimer, set_substage_timer,
    )

    if args.device is None:
        print(chip_smoke.gpu_line(), flush=True)
    parts: dict = {}
    timed(features, "phenograph", parts, "phenograph")
    timed(clustering, "knn_jaccard_graph", parts, "knn_jaccard_graph",
          lambda a, out: {
              "n": int(a[0].shape[0]),
              "branch": "ivf" if a[0].shape[0] > clustering.ANN_THRESHOLD
              else "exact",
              "max_degree": int(np.diff(out.indptr).max()),
              "mean_degree": float(np.diff(out.indptr).mean())})
    timed(clustering, "minibatch_kmeans", parts, "minibatch_kmeans")
    largest: list = []       # the largest graph whose counts the run took

    def keep_largest(a, out):
        if not largest or a[0].size > largest[0][0].size:
            largest[:] = [tuple(np.array(x) for x in a[:4])]
        return {"edges": int(out.size)}

    timed(native, "common_neighbor_counts", parts,
          "common_neighbor_counts", keep_largest)
    native_counts = native.common_neighbor_counts.__wrapped__
    timed(clustering, "louvain", parts, "louvain")
    solvers = []
    fit = pca.PCA._fit

    def fit_noted(self, x):
        out = fit(self, x)
        solvers.append({"shape": list(x.shape), "solver": self.svd_solver_})
        return out

    pca.PCA._fit = fit_noted
    for name in ("transcripts_graph", "prediction_graph",
                 "segmentation_graph"):
        timed(assemble, name, parts, name)

    sub = StageTimer()
    set_substage_timer(sub)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if args.low_memory:
            r = low_memory_run(args, Path(tmp), chip_smoke)
        else:
            anon = AnonRSSSampler().start()
            r = chip_smoke.drive_pipeline(tmp, device=args.device,
                                          n_cells=args.cells,
                                          n_genes=args.genes,
                                          epochs=args.epochs,
                                          tx_per_cell=args.tx_per_cell)
            r["anon_rss_gb"] = {"run": anon.stop()}
            r["rss_sampled_gb"] = {"run": anon.peak_rss_gb}
    total = time.perf_counter() - t0
    set_substage_timer(None)
    if args.device is None and r["counts"] != r["want"]:
        raise AssertionError(f"launches {r['counts']}, expected "
                             f"{r['want']}")
    walls = r["walls"]
    split = {k: v for k, v in parts.items() if not k.endswith(" calls")}
    split["features, the rest"] = walls["features"] - parts["phenograph"]
    split["graph, the rest"] = walls["graph"] - sum(
        parts.get(k, 0.0) for k in ("transcripts_graph", "prediction_graph",
                                    "segmentation_graph"))

    # the cells' common-neighbor counts again, by both paths, on this host
    indptr, indices, eu, ev = largest[0]
    t0 = time.perf_counter()
    a = clustering.common_neighbor_counts_spgemm(indptr, indices, eu, ev)
    spgemm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = native_counts(indptr, indices, eu, ev)
    native_s = time.perf_counter() - t0
    if not np.array_equal(a, b):
        raise AssertionError("native and SpGEMM common-neighbor counts "
                             "differ")
    stages = ("make-data", "features", "graph", "tiling", "fit", "predict",
              "write") + (("save-plane", "load-plane") if args.low_memory
                          else ())
    print(json.dumps({
        "mode": "low-memory" if args.low_memory else "dataframe",
        "cells": args.cells, "genes": args.genes,
        "tx_per_cell": args.tx_per_cell, "epochs": r["epochs"],
        "n_tx": r["n_tx"], "n_bd": r["n_bd"], "n_tt": r["n_tt"],
        "n_cand": r["n_cand"], "n_with_cand": r["n_with_cand"],
        "n_multi": r["n_multi"], "n_tiles": r["n_tiles"],
        "steps": r["steps"], "walls": walls,
        "slide_wall": sum(walls[k] for k in stages if k != "make-data"),
        "split": split, "substages": dict(sub.seconds),
        "calls": {k: v for k, v in parts.items() if k.endswith(" calls")},
        "common_neighbor_counts": {
            "n": int(len(indptr) - 1), "edges": int(eu.size),
            "spgemm_s": spgemm_s, "native_s": native_s},
        "pca": solvers, "launches": r["counts"],
        "peak_mib": r["peak_mib"], "peak_rss_gb": peak_rss_gb(),
        "anon_rss_gb": r["anon_rss_gb"],
        "rss_sampled_gb": r["rss_sampled_gb"], "accuracy": r["accuracy"],
        "accuracy_multi": r["accuracy_multi"],
        "accuracy_multi_init": r.get("accuracy_multi_init"),
        "script_s": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
