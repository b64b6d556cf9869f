"""The port stands alone: ``segger_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, nothing of scikit-learn or h5py
at module level (the GPU machine has neither), and a small fit and
prediction run with all of them blocked.  The other drives run the same
way, each in a subprocess of its own (``run_standalone``), from
``tests/test_torch_port_standalone_*.py``: the segmentation pipeline from
a synthetic slide to its table (with the table's quality report and
contamination QC, ``metrics/`` and ``validation/``), the command line from
a raw Xenium directory to the exported boundaries, the out-of-core path
(columnar transcripts, the memmapped graph plane, ``segment --low-memory
--graph-cache``, the native spatial core) and the whole-slide
halo-exchange path."""
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

# every drive runs in a subprocess of its own with the modules above
# blocked, and ends by checking that none of them was imported
_PRELUDE = textwrap.dedent("""
    import sys
    for name in {blocked!r}:
        sys.modules[name] = None          # any import of it raises
    sys.path.insert(0, {root!r})
    import numpy as np
    import segger_tpu_torch
    import chip_smoke
""")
_EPILOGUE = textwrap.dedent("""
    assert not any(m.split(".")[0] in {blocked!r}
                   for m in sys.modules if sys.modules[m] is not None)
    print("OK")
""")

# the small pipeline of chip_smoke.py's phase 7, whose graph, weights,
# truth and table the CLI, out-of-core and whole-slide drives start from
PIPELINE = textwrap.dedent("""
    import tempfile
    PIPE_KW = dict(device="cpu", n_cells=60, n_genes=20, epochs=1,
                   pipeline_kw=dict(cells_embedding_size=8,
                                    genes_min_counts=5, cells_min_counts=3,
                                    tiling_nodes_per_tile=600,
                                    prediction_graph_buffer_ratio=0.2),
                   train_kw=dict(hidden_channels=16, out_channels=16,
                                 n_mid_layers=0))
    with tempfile.TemporaryDirectory() as out:
        r = chip_smoke.drive_pipeline(out, **PIPE_KW)
""")

_PREDICT = textwrap.dedent("""
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
""")


def run_standalone(body: str) -> None:
    """``body`` in a fresh interpreter with jax, the JAX package,
    scikit-learn and h5py blocked, within 300 s; it must finish and have
    imported none of them."""
    script = (_PRELUDE + body + _EPILOGUE).format(
        blocked=BLOCKED + NOT_ON_CARD, root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-3000:]


def test_port_predicts_with_jax_blocked():
    """A small fit and prediction, and the attention slice."""
    run_standalone(_PREDICT)


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
    ROOT / "tools" / "device_ms_trace.py",
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
