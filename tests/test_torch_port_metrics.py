"""The port's ``metrics/`` against the JAX package's on seeded label
sets: accuracy, pairwise F1, the adjusted Rand index (the JAX package's
calls scikit-learn; the port's forms it from the contingency table),
cluster purity and the segmentation report, with missing and unassigned
cells and the degenerate partitions, within 1e-12."""
import numpy as np
import pandas as pd
import pytest

from segger_tpu import metrics as jm

from segger_tpu_torch import metrics as tm

FUNCS = ("assignment_accuracy", "assignment_f1", "assignment_ari",
         "cluster_purity")


def _series(values, index=None):
    return pd.Series(values, index=index if index is not None
                     else range(len(values)), dtype=object)


def _labels(rng, n, n_cells, missing=0.0, prefix="c"):
    ids = np.array([f"{prefix}{i}" for i in rng.integers(0, n_cells, n)],
                   dtype=object)
    ids[rng.uniform(size=n) < missing] = None
    return ids


def _close(got, want):
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(got - want) <= 1e-12, (got, want)


CASES = {
    # truth, then a prediction that mostly agrees, with cells missing in
    # both and the indexes only partly shared
    "seeded": lambda rng: (
        _series(_labels(rng, 400, 30, 0.1)),
        _series(_labels(rng, 380, 30, 0.2), index=rng.permutation(420)[
            :380])),
    "same partition, other ids": lambda rng: (
        _series(["a", "a", "b", "b", "c"]), _series(["x", "x", "y", "y",
                                                     "z"])),
    "one cell each": lambda rng: (_series(["a"] * 6), _series(["x"] * 6)),
    "all singletons": lambda rng: (_series(list("abcdef")),
                                   _series(list("uvwxyz"))),
    "one cell against singletons": lambda rng: (_series(["a"] * 5),
                                                _series(list("vwxyz"))),
    "nothing left": lambda rng: (_series([None, None, "a"]),
                                 _series(["x", "y", None])),
    "no shared index": lambda rng: (_series(["a", "b"]),
                                    _series(["x", "y"], index=[5, 6])),
    "a single transcript": lambda rng: (_series(["a"]), _series(["x"])),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("func", FUNCS)
def test_metric_matches_jax(case, func):
    rng = np.random.default_rng(list(CASES).index(case))
    truth, pred = CASES[case](rng)
    want = getattr(jm, func)(pred, truth)
    got = getattr(tm, func)(pred, truth)
    _close(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_f1_and_ari_with_unassigned_match_jax(seed):
    """An ``unassigned`` marker drops those transcripts on both sides,
    at several agreement levels (noise shares 0.05 to 0.8)."""
    rng = np.random.default_rng(seed)
    n = 600
    truth = _labels(rng, n, 40, 0.05)
    pred = truth.copy()
    noisy = rng.uniform(size=n) < [0.05, 0.2, 0.5, 0.8][seed]
    pred[noisy] = _labels(rng, int(noisy.sum()), 40, prefix="c")
    pred[rng.uniform(size=n) < 0.1] = "UNASSIGNED"
    p, t = _series(pred), _series(truth)
    for func in ("assignment_f1", "assignment_ari"):
        _close(getattr(tm, func)(p, t, unassigned="UNASSIGNED"),
               getattr(jm, func)(p, t, unassigned="UNASSIGNED"))


def test_segmentation_report_matches_jax():
    rng = np.random.default_rng(3)
    n = 300
    seg = pd.DataFrame({
        "row_index": rng.permutation(n),
        "segger_cell_id": _labels(rng, n, 25, 0.15),
        "segger_similarity": rng.uniform(size=n),
        "similarity_threshold": rng.uniform(0.2, 0.6, n),
    })
    truth = _series(_labels(rng, n, 25, 0.1))
    want = jm.segmentation_report(seg, truth)
    got = tm.segmentation_report(seg, truth)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
    # without the threshold columns the report has no threshold keys
    short = seg[["row_index", "segger_cell_id"]]
    assert tm.segmentation_report(short, truth).keys() == \
        jm.segmentation_report(short, truth).keys()


def test_ari_needs_no_sklearn():
    import ast
    from pathlib import Path

    import segger_tpu_torch.metrics.segment as mod

    tree = ast.parse(Path(mod.__file__).read_text())
    names = {a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not any(n.split(".")[0] == "sklearn" for n in names)
