"""The port stands alone: ``segger_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, nothing of scikit-learn or h5py
at module level (the GPU machine has neither), and a small fit and
prediction, the segmentation pipeline from a synthetic slide to its
table, the command line from a raw Xenium directory to the exported
boundaries, the out-of-core path (columnar transcripts, the memmapped
graph plane, ``segment --low-memory --graph-cache``, the native spatial
core) and the whole-slide halo-exchange path run with all of them
blocked, the table's quality report and contamination QC
(``metrics/``, ``validation/``) included."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "segger_tpu")
# absent on the GPU machine: imported, if at all, inside the functions
# that need them
NOT_ON_CARD = ("sklearn", "h5py")

_SCRIPT = textwrap.dedent("""
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None          # any import of it raises
    sys.path.insert(0, {root!r})
    import numpy as np
    import segger_tpu_torch
    import chip_smoke
    from segger_tpu_torch.data.partition import (
        build_tiling, make_fit_tiles, make_predict_tiles)
    from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

    g = chip_smoke.synthetic_slide(n_tx=3000, n_cells=150, n_genes=30,
                                   f_bd=12)
    specs = make_predict_tiles(g, build_tiling(g, nodes_per_tile=900),
                               margin=20.0)
    tr = SeggerTrainer(g, TrainConfig(hidden_channels=16, out_channels=16,
                                      n_mid_layers=0), device="cpu")
    tr.init()
    hist = tr.fit(make_fit_tiles(g, build_tiling(g, nodes_per_tile=900),
                                 margin=20.0), max_epochs=1)
    assert np.isfinite(hist[0]["train:loss"])
    out = tr.predict(specs)
    assert len(specs) > 1
    assert np.array_equal(np.sort(out["row_index"]), np.arange(3000))
    ok = out["cell_encoding"] >= 0
    assert ok.mean() > 0.99 and np.isfinite(out["similarity"][ok]).all()

    # the attention slice: the banded table of the strip-major slide, both
    # attention ops on it, and one capture forward of the encoder
    import torch
    from segger_tpu_torch.data.neighbors_host import kdtree_neighbors
    from segger_tpu_torch.data.partition import _strip_major_order
    from segger_tpu_torch.ops import (
        band_graph, banded_edge_stage, gatv2_attention)
    from segger_tpu_torch.ops.padded_csr import coo_to_padded_csr
    pos = g.tx_pos[_strip_major_order(g.tx_pos)]
    src, dst = kdtree_neighbors(pos, max_k=5, max_dist=5.0)
    csr = coo_to_padded_csr(dst, src, n_dst=len(pos), pad_to_multiple=8)
    lo, idxl, mask, ok = band_graph(csr, n_src=len(pos))
    assert ok
    x = torch.randn(idxl.shape[0], 32)
    att, bias = torch.randn(2, 16), torch.randn(32)
    k6 = gatv2_attention(x[:len(pos)], x[:len(pos)], torch.from_numpy(
        csr.idx), torch.from_numpy(csr.mask), att, bias, 2)
    k7 = banded_edge_stage(x[:len(pos)], x, torch.from_numpy(lo),
                           torch.from_numpy(idxl), torch.from_numpy(mask),
                           att, bias, 2)
    assert torch.allclose(k6, k7[:len(pos)], atol=1e-5)
    plan = tr._batch_plans(specs, use_xlo=True)[0]
    tile = tr._build_batch(plan, cache=False).to("cpu").map_arrays(
        lambda a: a[0])
    inter = dict()
    with torch.no_grad():
        emb = tr.model(tile, capture_attention=True, intermediates=inter)
    assert torch.isfinite(emb["tx"]).all()
    assert sum(k.endswith("/attention") for k in inter) == 4  # 2 layers

    # the segmentation pipeline (chip_smoke.py's phase 7, small, on the
    # CPU): make_synthetic -> ISTPipeline.load() -> run(device="cpu",
    # save_anndata=False) -> the checks of the table
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        r = chip_smoke.drive_pipeline(
            out, device="cpu", n_cells=60, n_genes=20, epochs=1,
            pipeline_kw=dict(cells_embedding_size=8, genes_min_counts=5,
                             cells_min_counts=3, tiling_nodes_per_tile=600,
                             prediction_graph_buffer_ratio=0.2),
            train_kw=dict(hidden_channels=16, out_channels=16,
                          n_mid_layers=0))
    assert r["accuracy"] > 0.6 and r["n_tiles"][1] > 1
    assert r["quality"]["report"]["ari"] > 0.5
    assert r["quality"]["median_percent_contamination"] >= 0
    assert set(r["walls"]) == {{"make-data", "features", "graph", "tiling",
                               "fit", "predict", "write"}}

    # the command line (chip_smoke.py's phase 8, small, on the CPU): the
    # same slide as a raw Xenium directory -> segment --device cpu
    # --no-anndata -> export transcripts boundaries; the graph from the
    # vendor files equals the pipeline's from the in-memory tables
    with tempfile.TemporaryDirectory() as work:
        c = chip_smoke.drive_cli(
            work, device="cpu", n_cells=60, n_genes=20, epochs=1,
            pipeline_kw=dict(cells_embedding_size=8, genes_min_counts=5,
                             cells_min_counts=3, tiling_nodes_per_tile=600,
                             prediction_graph_buffer_ratio=0.2),
            train_kw=dict(hidden_channels=16, out_channels=16,
                          n_mid_layers=0), graph=r["graph"])
    assert c["accuracy"] > 0.6 and c["n_rings"] > 0
    assert set(c["walls"]) == {{"write-vendor", "read", "features + graph",
                               "fit", "predict", "write",
                               "export-boundaries"}}
    assert "cv2" not in sys.modules     # a Xenium run never imports it

    # the out-of-core path (chip_smoke.py's phase 9, small, on the CPU):
    # the slide as spooled columnar chunks -> the graph equals the
    # pipeline's, the memmapped plane -> fit, predict_streaming,
    # write_dense; the MERSCOPE directory through segment --low-memory
    # --graph-cache (prepare in a child process, then the cached run);
    # the native core (built by g++ at first use) against the KDTree
    # and SpGEMM plain versions
    with tempfile.TemporaryDirectory() as work:
        o = chip_smoke.drive_outofcore(
            work, device="cpu", n_cells=60, n_genes=20, epochs=1,
            pipeline_kw=dict(cells_embedding_size=8, genes_min_counts=5,
                             cells_min_counts=3, tiling_nodes_per_tile=600,
                             prediction_graph_buffer_ratio=0.2),
            train_kw=dict(hidden_channels=16, out_channels=16,
                          n_mid_layers=0), graph=r["graph"],
            table=r["table"])
    assert o["agreement"] == 1.0 and o["accuracy"] > 0.6
    assert set(o["cli"]["walls"]) == {{"load-graph", "fit", "predict",
                                      "write"}}
    assert {{"graph.tx_knn", "graph.prediction"}} <= set(o["substages"])
    assert set(o["branches"]["walls"]) == {{"native", "kdtree"}}
    from segger_tpu_torch import native
    assert native.library_path().exists()

    # the whole-slide path (chip_smoke.py's phase 10, small, on the CPU):
    # predict_whole_slide at 1 strip, 4 strips and a 2x2 grid in bf16 and
    # f32, the surrogate gradient, fit_whole_slide, and segment
    # --distributed-predict --distributed-train
    with tempfile.TemporaryDirectory() as work:
        w = chip_smoke.drive_whole_slide(
            work, r["graph"], r["state"], r["truth"], r["table"],
            device="cpu", n_cells=60, n_genes=20, epochs=1,
            pipeline_kw=dict(cells_embedding_size=8, genes_min_counts=5,
                             cells_min_counts=3, tiling_nodes_per_tile=600,
                             prediction_graph_buffer_ratio=0.2),
            train_kw=dict(hidden_channels=16, out_channels=16,
                          n_mid_layers=0))
    assert set(w["checks"]) == {{"1 strip", "4 strips", "2x2 grid"}}
    assert w["grad_err"] <= chip_smoke.WS_GRAD_ATOL
    assert w["cli"]["accuracy"] > 0.6 and len(w["cli"]["history"]) == 1
    assert not any(m.split(".")[0] in {blocked!r}
                   for m in sys.modules if sys.modules[m] is not None)
    print("OK")
""")


def test_port_predicts_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c",
         _SCRIPT.format(blocked=BLOCKED + NOT_ON_CARD, root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-3000:]


def _imported_modules(path: Path, top_level_only: bool = False):
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted((ROOT / "segger_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "bwd_device_ms.py",
    ROOT / "tools" / "fwd_phase_ms.py", ROOT / "tools" / "pipeline_scale.py",
    ROOT / "tests" / "_torch_multiprocess_worker.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_sklearn_or_h5py(path):
    bad = [m for m in _imported_modules(path, top_level_only=True)
           if m.split(".")[0] in NOT_ON_CARD]
    assert not bad, f"{path} imports {bad} at module level"


def test_port_builds_its_own_native_source():
    """The native core the port builds is its own copy of the C++ source,
    never the JAX package's ``csrc/spatial.cpp``, and the new host modules
    are among the files checked above."""
    from segger_tpu_torch import native

    assert native.SOURCE == ROOT / "segger_tpu_torch" / "csrc" / "spatial.cpp"
    assert native.library_path().parent == ROOT / "build" / "native"
    for rel in ("native.py", "utils_profiling.py", "data/columnar.py"):
        assert ROOT / "segger_tpu_torch" / rel in PORT_FILES


@pytest.mark.parametrize("rel", ["metrics/__init__.py", "metrics/segment.py",
                                 "validation/__init__.py",
                                 "validation/contamination.py"])
def test_metrics_and_validation_are_checked(rel):
    """The quality metrics and the contamination QC are among the files
    whose imports are checked above (no JAX, no scikit-learn)."""
    assert ROOT / "segger_tpu_torch" / rel in PORT_FILES


def test_parallel_modules_are_checked():
    """Every module of the whole-slide layer, and the worker the
    multi-process tests start their ranks with, are among the files whose
    imports are checked above."""
    for rel in ("__init__.py", "mesh.py", "_build_common.py", "halo.py",
                "grid.py", "transport.py"):
        assert ROOT / "segger_tpu_torch" / "parallel" / rel in PORT_FILES
    assert ROOT / "tests" / "_torch_multiprocess_worker.py" in PORT_FILES
