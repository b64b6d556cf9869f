"""The port stands alone: ``segger_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, and a small fit and prediction
run with both blocked."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "segger_tpu")

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
    assert not any(m == "jax" or m.startswith(("jax.", "flax", "optax"))
                   for m in sys.modules if sys.modules[m] is not None)
    print("OK")
""")


def test_port_predicts_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c",
         _SCRIPT.format(blocked=BLOCKED, root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert res.returncode == 0 and "OK" in res.stdout, res.stderr[-3000:]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "segger_tpu_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path} imports {bad}"
