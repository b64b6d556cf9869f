#!/usr/bin/env python3
"""The segmentation pipeline on a larger synthetic slide: where its wall
goes as the slide grows.

Runs ``chip_smoke.drive_pipeline`` (``chip_smoke.py``'s phase 7:
``make_synthetic`` at the phase's density of cells, ``ISTPipeline.run``
at ``PipelineConfig(seed=0)`` and ``TrainConfig()`` width for 2 epochs,
then the checks of the table) at ``--cells`` cells, ``--genes`` genes
and ``--tx-per-cell`` transcripts a cell, and splits the features and
graph stages by timing the functions they call:

- features: ``phenograph`` (cells, then genes), inside it
  ``knn_jaccard_graph`` (the exact kNN up to ``ANN_THRESHOLD`` points,
  the IVF search above with its ``minibatch_kmeans``, then the Jaccard
  weights from ``common_neighbor_counts``; with the Jaccard graph's
  largest and mean degree) and ``louvain``;
  the rest is the count matrix, normalisation, the two PCAs and the
  similarity matrices;
- graph: ``transcripts_graph``, ``prediction_graph`` and
  ``segmentation_graph``.

    python3 tools/pipeline_scale.py --cells 150000 --genes 5000 \
        --tx-per-cell 50

Needs one CUDA device; ``--device cpu`` runs the plain versions (small
slides only).  Prints the card's name and power limit, one line a
stage as it ends, and one JSON line with the walls, the PCA solvers
taken, the kNN branches, the graph's sizes, the launches, peak device
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

    setattr(module, name, wrapper)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=150_000)
    ap.add_argument("--genes", type=int, default=5_000)
    ap.add_argument("--tx-per-cell", type=int, default=50)
    ap.add_argument("--epochs", type=int, default=2)
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
    from segger_tpu_torch.data import assemble, clustering, features, pca

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
    timed(clustering, "common_neighbor_counts", parts,
          "common_neighbor_counts")
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

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        r = chip_smoke.drive_pipeline(out_dir, device=args.device,
                                      n_cells=args.cells,
                                      n_genes=args.genes,
                                      epochs=args.epochs,
                                      tx_per_cell=args.tx_per_cell)
    total = time.perf_counter() - t0
    if args.device is None and r["counts"] != r["want"]:
        raise AssertionError(f"launches {r['counts']}, expected "
                             f"{r['want']}")
    walls = r["walls"]
    split = {k: v for k, v in parts.items() if not k.endswith(" calls")}
    split["features, the rest"] = walls["features"] - parts["phenograph"]
    split["graph, the rest"] = walls["graph"] - sum(
        parts.get(k, 0.0) for k in ("transcripts_graph", "prediction_graph",
                                    "segmentation_graph"))
    print(json.dumps({
        "cells": args.cells, "genes": args.genes,
        "tx_per_cell": args.tx_per_cell, "epochs": r["epochs"],
        "n_tx": r["n_tx"], "n_bd": r["n_bd"], "n_tt": r["n_tt"],
        "n_cand": r["n_cand"], "n_with_cand": r["n_with_cand"],
        "n_multi": r["n_multi"], "n_tiles": r["n_tiles"],
        "steps": r["steps"], "walls": walls,
        "slide_wall": sum(walls[k] for k in ("features", "graph", "tiling",
                                             "fit", "predict", "write")),
        "split": split, "calls": {k: v for k, v in parts.items()
                                  if k.endswith(" calls")},
        "pca": solvers, "launches": r["counts"],
        "peak_mib": r["peak_mib"], "accuracy": r["accuracy"],
        "accuracy_multi": r["accuracy_multi"],
        "accuracy_multi_init": r["accuracy_multi_init"],
        "script_s": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
