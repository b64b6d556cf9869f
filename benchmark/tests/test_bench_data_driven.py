"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as new files (and entries in BENCHMARK.json) are
found by name with no edit; a run without a CUDA device fails with a
clear message and prints no result."""
import json
import os
import subprocess
import sys

import harness
from conftest import REPO, tiny_copy


def add_cell(root):
    """A new configuration, traffic mix, per-layer metric and cell, each
    as a new file, and their entries."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "xenium5k.json").read_text())
    cfg["name"] = "cosmx1k"
    cfg["slide"]["n_genes"] = 50
    (bench / "configs" / "cosmx1k.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "fit.json").read_text())
    traffic["compare_steps"] = 2
    (bench / "traffic" / "fit_short.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "epochs_traced.fit.py").write_text(
        "def read(view):\n    return float(view.units)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="cosmx1k",
                                file="benchmark/configs/cosmx1k.json"))
    spec["workloads"].append({"name": "cosmx1k-fit", "config": "cosmx1k",
                              "traffic": "fit_short", "chips": 1,
                              "why": "a cell added by data"})
    spec["per_layer"].append({
        "name": "epochs_traced.fit", "unit": "epochs", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "fit_tx_per_s", "workloads": ["cosmx1k-fit"]})
    for m in spec["end_to_end"]:
        if m["name"] == "fit_tx_per_s":
            m["workloads"].append("cosmx1k-fit")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_added_files_are_found_by_name(tmp_path):
    root = tiny_copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*.py")}
    add_cell(root)
    cell = harness.cell_spec("cosmx1k-fit", root=root,
                             bench=root / "benchmark")
    assert cell["config"]["slide"]["n_genes"] == 50
    assert cell["traffic"]["compare_steps"] == 2
    names = [m["name"] for m in cell["per_layer"]]
    assert "epochs_traced.fit" in names and "K2_roofline" not in names
    reader = dict(zip(names, cell["per_layer"]))["epochs_traced.fit"]
    assert reader["reader"].read(type("V", (), {"units": 3})()) == 3.0
    assert {m["name"] for m in cell["end_to_end"]} == {"fit_tx_per_s",
                                                      "setup_s"}
    # the files that were there are unchanged
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_run_without_cuda_fails_clearly_and_prints_no_result(tmp_path):
    root = tiny_copy(tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "xenium5k-fit",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no result."""
    root = tiny_copy(tmp_path)
    (root / "segger_tpu_torch").unlink()
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "xenium5k-fit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_an_unknown_workload_is_refused():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nope",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no workload 'nope'" in out.stderr
