"""The port's native spatial core (``segger_tpu_torch/native.py`` over its
copy of ``csrc/spatial.cpp``) against the JAX package's native core on
the same inputs (the same source, so the same arrays) and against the
port's own plain versions (the KDTree and NumPy branches: the same sets
and counts), its build (one library per source, flags and host, built
at once by several processes) and a broken source, which must raise."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import pytest

from segger_tpu import native as j_native

from segger_tpu_torch import native
from segger_tpu_torch.data import clustering as t_cl
from segger_tpu_torch.data.neighbors_host import kdtree_neighbors
from segger_tpu_torch.geometry import query as t_query
from segger_tpu_torch.geometry.quadtree import QuadTree

ROOT = Path(__file__).resolve().parents[1]


def test_jax_side_is_native():
    """The parity tests below and the graph parity of
    ``test_torch_port_pipeline.py`` compare the two packages' C++ paths:
    the JAX package must have built its core, not fallen back to NumPy."""
    assert j_native.available()
    assert native.load().sgt_version() == j_native._build_lib().sgt_version()


def _polygons(rng, n=25, extent=80.0):
    polys = []
    for cx, cy in rng.uniform(5, extent - 5, (n, 2)):
        th = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        r = 3 * (1 + rng.uniform(-0.3, 0.3, 12))
        polys.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], 1))
    return polys


def _canonical(a, b):
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    o = np.lexsort((a, b))
    return a[o], b[o]


@pytest.mark.parametrize("k,r,with_query", [(5, 5.0, False), (3, 2.0, False),
                                            (4, np.inf, True)])
def test_grid_knn_matches_jax(k, r, with_query):
    rng = np.random.default_rng(k)
    pts = rng.uniform(0, 100, (3000, 2)).astype(np.float32)
    q = rng.uniform(0, 100, (200, 2)) if with_query else None
    got = native.grid_knn(pts, max_k=k, max_dist=r, query=q,
                          return_dist=True)
    want = j_native.grid_knn(pts, max_k=k, max_dist=r, query=q,
                             return_dist=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,r", [(5, 5.0), (8, 3.0)])
def test_grid_knn_sets_match_kdtree(k, r):
    """The native kNN and the KDTree give each query the same neighbor set
    (ties may be ordered differently), both as int32 COO."""
    rng = np.random.default_rng(k)
    pts = rng.uniform(0, 100, (4000, 2)).astype(np.float32)
    got = kdtree_neighbors(pts, max_k=k, max_dist=r)
    want = kdtree_neighbors(pts, max_k=k, max_dist=r, backend="kdtree")
    assert got[0].dtype == got[1].dtype == np.int32
    for a, b in zip(_canonical(got[1], got[0]), _canonical(want[1],
                                                            want[0])):
        np.testing.assert_array_equal(a, b)
    # the JAX package's native branch: the same arrays, order included
    from segger_tpu.data.neighbors_host import kdtree_neighbors as j_knn

    for a, b in zip(got, j_knn(pts, max_k=k, max_dist=r)):
        np.testing.assert_array_equal(a, b)


def test_knn_backend_rejects_unknown():
    with pytest.raises(ValueError, match="backend"):
        kdtree_neighbors(np.zeros((3, 2)), 2, 1.0, backend="grid")


@pytest.mark.parametrize("buffered", [False, True],
                         ids=["unbuffered", "buffered"])
def test_points_in_polygons_matches_jax_and_kdtree(buffered):
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 80, (4000, 2))
    polys = _polygons(rng)
    dists = rng.uniform(0, 1.0, len(polys)) if buffered else None
    raw = native.points_in_polygons(pts, polys, dists)
    want = j_native.points_in_polygons(pts, polys, dists)
    for a, b in zip(_canonical(*raw), _canonical(*want)):
        np.testing.assert_array_equal(a, b)
    got = t_query.points_in_polygons(pts, polys, distances=dists)
    plain = t_query.points_in_polygons_kdtree(pts, polys, distances=dists)
    assert got[0].size > 100
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)


def test_points_in_boxes_matches_jax_and_numpy(rng):
    pts = rng.uniform(0, 100, (5000, 2))
    tree = QuadTree.build(pts, max_leaf_size=400)
    assert tree.n_leaves > 4
    for margin in (0.0, 3.5):
        got = tree.expanded_label_multi(pts, margin)
        want = j_native.points_in_boxes(pts, tree.leaf_bounds, margin)
        for a, b in zip(_canonical(*got), _canonical(*want)):
            np.testing.assert_array_equal(a, b)
        plain = tree.expanded_label_multi_plain(pts, margin)
        for a, b in zip(_canonical(*got), _canonical(*plain)):
            np.testing.assert_array_equal(a, b)


def test_common_neighbor_counts_matches_jax_and_spgemm(rng):
    X = rng.normal(size=(500, 12))
    A = (t_cl.knn_jaccard_graph(X, 8) > 0).astype(np.float64).tolil()
    A[0, 1:200] = 1.0      # a hub
    A[1:200, 0] = 1.0
    A = A.tocsr()
    A.sort_indices()
    coo = A.tocoo()
    p = rng.permutation(coo.nnz)
    args = (A.indptr, A.indices, coo.row[p], coo.col[p])
    got = native.common_neighbor_counts(*args)
    np.testing.assert_array_equal(got, j_native.common_neighbor_counts(*args))
    np.testing.assert_array_equal(got, t_cl.common_neighbor_counts_spgemm(*args))
    assert native.common_neighbor_counts(
        np.zeros(1), np.zeros(0), np.zeros(0), np.zeros(0)).size == 0
    with pytest.raises(ValueError, match="out of range"):
        native.common_neighbor_counts(A.indptr, A.indices, [0], [A.shape[0]])


def test_morton_codes_match_jax_and_numpy(rng):
    pts = rng.uniform(0, 100, (2000, 2))
    codes = native.morton_codes(pts)
    np.testing.assert_array_equal(codes, j_native.morton_codes(pts))
    np.testing.assert_array_equal(codes, native.morton_codes_plain(pts))
    np.testing.assert_array_equal(native.morton_decode(codes),
                                  j_native.morton_decode(codes))
    # decoded grid coordinates never decrease along either axis
    grid = native.morton_decode(codes)
    for axis in range(2):
        assert (np.diff(grid[np.argsort(pts[:, axis]), axis]) >= 0).all()


def test_library_is_keyed_and_reused():
    """One library per source, flags and host CPU, under build/native/ at
    the root of the checkout; a second load returns the same handle."""
    so = native.library_path()
    assert so.parent == ROOT / "build" / "native"
    assert native.load() is native.load()
    assert so.exists()


def test_broken_source_raises(tmp_path):
    """A source that does not compile raises with the compiler's message
    and leaves no library behind; nothing falls back."""
    src = tmp_path / "spatial.cpp"
    src.write_text(native.SOURCE.read_text().replace(
        "int sgt_version() { return 3; }", "int sgt_version() { return }"))
    with pytest.raises(RuntimeError, match="error"):
        native.load(source=src, build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_wrong_version_raises(tmp_path):
    src = tmp_path / "spatial.cpp"
    src.write_text(native.SOURCE.read_text().replace(
        "int sgt_version() { return 3; }", "int sgt_version() { return 2; }"))
    with pytest.raises(RuntimeError, match="sgt_version"):
        native.load(source=src, build_dir=tmp_path / "build")


_BUILD = """
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from segger_tpu_torch import native
print(native.load(Path({src!r}), Path({out!r})).sgt_version())
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Four processes building the same source into one directory at once
    each compile to their own temporary file and all load one library."""
    src = tmp_path / "spatial.cpp"
    src.write_text(native.SOURCE.read_text() + "\n// a fresh hash\n")
    out = tmp_path / "build"
    code = _BUILD.format(root=str(ROOT), src=str(src), out=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    results = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, results
    assert [r[0].strip() for r in results] == ["3"] * 4
    assert [p.name for p in out.iterdir()] == [
        native.library_path(src, out).name]
