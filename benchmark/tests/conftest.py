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
TINY_GENES = {"xenium5k": 40, "merscope500": 30}


def tiny_copy(dst: Path) -> Path:
    """A checkout at ``dst`` with BENCHMARK.json, a copy of this folder
    whose configurations are cut to a tiny size (tiles of 1,500 nodes, a
    16-wide gene embedding, 3 epochs a fit), and the program linked
    in."""
    shutil.copytree(BENCH, dst / "benchmark",
                    ignore=shutil.ignore_patterns(".work", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "segger_tpu_torch").symlink_to(REPO / "segger_tpu_torch")
    for name, genes in TINY_GENES.items():
        p = dst / "benchmark" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["slide"].update(TINY_SLIDE, n_genes=genes)
        c["pipeline"].update(tiling_nodes_per_tile=1500,
                             cells_embedding_size=16)
        c["model"].update(in_channels=16, max_epochs=3)
        p.write_text(json.dumps(c))
    return dst


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny"))
