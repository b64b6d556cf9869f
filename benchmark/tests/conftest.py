"""Fixtures of the benchmark's CPU tests: the benchmark's folder on the
import path, and a tiny copy of the benchmark (its slides cut to a few
hundred cells) that the harness can drive on the CPU."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(BENCH))

TINY_SLIDE = {"n_cells": 300, "mean_tx_per_cell": 25}
TINY_GENES = {"xenium5k": 40, "merscope500": 30, "xenium5k-2x": 40}
# a configuration cut to more cells than TINY_SLIDE's: the 4-card slide
# keeps 2 times xenium5k's, so that its 4-tile steps fill their batches
TINY_CELLS = {"xenium5k-2x": 600}
# limits of numbers whose rounding depends on the size: the worst of the
# compared steps' loss gaps, limited at the 4-card cell's size, reads
# 1.2e-4 to 1.9e-4 on sound runs at this size, ten times as high as
# there, and 3.1e-3 and more with half of each tile's rows left out
TINY_LIMITS = {"fit-mesh": {"loss_gap_worst": 1e-3}}
# the 4-card cell, which the tests drive on the CPU and BENCHMARK.json does
# not hold (its rate spread too widely for the bound): its entries, and the
# metrics that read it besides every metric of the one-card fit cells
MESH_CELL = {
    "config": {"name": "xenium5k-2x", "source": "as xenium5k",
               "file": "benchmark/configs/xenium5k-2x.json",
               "reduced": ["n_cells", "genes_min_counts"],
               "why": "tile data parallelism over 4 cards"},
    "workload": {"name": "xenium5k-fit-4card", "config": "xenium5k-2x",
                 "traffic": "fit-mesh", "chips": 4,
                 "why": "steady epochs over 4 cards, a tile a card a step"},
    "per_layer": [{"name": "peer_copy_ms_per_step.fit", "unit": "ms",
                   "better": "lower", "source": "device_trace",
                   "layer": "device", "moves": "fit_tx_per_s",
                   "workloads": ["xenium5k-fit-4card"]}],
}


def with_mesh_cell(spec: dict) -> dict:
    """``spec`` with ``MESH_CELL`` in it, unless it holds that cell."""
    name = MESH_CELL["workload"]["name"]
    if any(w["name"] == name for w in spec["workloads"]):
        return spec
    spec["configs"].append(MESH_CELL["config"])
    spec["workloads"].append(MESH_CELL["workload"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "xenium5k-fit" in m.get("workloads", []):
            m["workloads"].append(name)
    spec["per_layer"] += MESH_CELL["per_layer"]
    return spec


def tiny_copy(dst: Path) -> Path:
    """A checkout at ``dst`` with BENCHMARK.json and ``MESH_CELL``, a copy
    of this folder whose configurations are cut to a tiny size (tiles of
    1,500 nodes, a 16-wide gene embedding, 3 epochs a fit) and whose
    limits of ``TINY_LIMITS`` are this size's, and the program linked
    in."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns(".work", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(with_mesh_cell(spec)))
    (dst / "segger_tpu_torch").symlink_to(REPO / "segger_tpu_torch")
    for name, genes in TINY_GENES.items():
        p = dst / "benchmark" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["slide"].update(TINY_SLIDE, n_genes=genes)
        c["slide"]["n_cells"] = TINY_CELLS.get(name, TINY_SLIDE["n_cells"])
        c["pipeline"].update(tiling_nodes_per_tile=1500,
                             cells_embedding_size=16)
        c["model"].update(in_channels=16, max_epochs=3)
        p.write_text(json.dumps(c))
    for name, limits in TINY_LIMITS.items():
        p = dst / "benchmark" / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t["limits"].update(limits)
        p.write_text(json.dumps(t))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny"))
