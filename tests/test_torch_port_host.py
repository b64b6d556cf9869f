"""The port's host modules against the JAX package's on the same seeded
inputs: field schemas, the synthetic slide, geometry (spatial joins,
polygon shape features, square tiling, the quadtree check), the graph
builders, the histogram thresholds, PCA against scikit-learn at each of
its solvers, the PhenoGraph chain, the segmentation writer and the h5ad
container."""
import dataclasses
import sys

import numpy as np
import pandas as pd
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import pytest
from scipy import sparse as sp

from segger_tpu.compat import anndata_lite as j_ad
from segger_tpu.data import clustering as j_cl
from segger_tpu.data import neighbors_host as j_nb
from segger_tpu.data import partition as j_part
from segger_tpu.data import threshold as j_thr
from segger_tpu.data import writer as j_wr
from segger_tpu.data.synthetic import make_synthetic as j_make_synthetic
from segger_tpu.geometry import morphology as j_morph
from segger_tpu.geometry import query as j_query
from segger_tpu.geometry.quadtree import QuadTree as JQuadTree
from segger_tpu.io import fields as j_fields
from segger_tpu import native as j_native

from segger_tpu_torch.compat import anndata_lite as t_ad
from segger_tpu_torch.data import clustering as t_cl
from segger_tpu_torch.data import neighbors_host as t_nb
from segger_tpu_torch.data import partition as t_part
from segger_tpu_torch.data import pca as t_pca
from segger_tpu_torch.data import threshold as t_thr
from segger_tpu_torch.data import writer as t_wr
from segger_tpu_torch.data.synthetic import make_synthetic as t_make_synthetic
from segger_tpu_torch.geometry import morphology as t_morph
from segger_tpu_torch.geometry import query as t_query
from segger_tpu_torch.geometry.quadtree import QuadTree as TQuadTree
from segger_tpu_torch.io import fields as t_fields


@pytest.fixture(scope="module")
def slide():
    """One seeded slide from each package (the e2e fixture's size)."""
    kw = dict(n_cells=200, n_genes=40, mean_tx_per_cell=25, seed=0)
    return j_make_synthetic(**kw), t_make_synthetic(**kw)


def _canonical(src, dst):
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    o = np.lexsort((dst, src))
    return src[o], dst[o]


def _assert_edges_equal(a, b):
    for x, y in zip(_canonical(*a), _canonical(*b)):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# schemas and the synthetic slide
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", [
    "StandardTranscriptFields", "StandardBoundaryFields",
    "TrainingTranscriptFields",
])
def test_fields_match_jax(name):
    assert dataclasses.asdict(getattr(t_fields, name)()) \
        == dataclasses.asdict(getattr(j_fields, name)())


def test_make_synthetic_matches_jax(slide):
    j, t = slide
    pd.testing.assert_frame_equal(t.transcripts, j.transcripts)
    pd.testing.assert_frame_equal(t.boundaries, j.boundaries)
    np.testing.assert_array_equal(t.truth_cell, j.truth_cell)
    assert t.polygons.keys() == j.polygons.keys()
    for k in j.polygons:
        np.testing.assert_array_equal(t.polygons[k], j.polygons[k])


# ----------------------------------------------------------------------
# geometry
# ----------------------------------------------------------------------
@pytest.mark.parametrize("buffered", [False, True],
                         ids=["unbuffered", "buffered"])
def test_points_in_polygons_matches_jax(slide, buffered):
    """Equal (point, polygon) pair arrays in canonical order, both from
    the packages' C++ grid joins (the port's KDTree path is held to its
    join in ``test_torch_port_native.py``)."""
    j, _ = slide
    pts = j.transcripts[["x", "y"]].to_numpy()
    polys = [p for (_, b), p in j.polygons.items() if b == "cell"]
    dist = (np.sqrt(j_nb.polygon_areas_batch(polys) / np.pi) * 0.2
            if buffered else None)
    got = t_query.points_in_polygons(pts, polys, distances=dist)
    want = j_query.points_in_polygons(pts, polys, distances=dist)
    assert got[0].size > 1000
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("distance", [0.0, 1.5])
def test_points_in_polygon_matches_jax(rng, distance):
    poly = np.array([[0, 0], [4, 0], [4, 3], [2, 1.5], [0, 3]], float)
    pts = rng.uniform(-2, 6, (2000, 2))
    np.testing.assert_array_equal(
        t_query.points_in_polygon(pts, poly, distance),
        j_query.points_in_polygon(pts, poly, distance))


@pytest.mark.parametrize("mode", ["centroid", "all"])
def test_polygons_in_polygons_matches_jax(slide, mode):
    j, _ = slide
    inner = [p for (_, b), p in j.polygons.items() if b == "nucleus"]
    outer = [p for (_, b), p in j.polygons.items() if b == "cell"][:60]
    got = t_query.polygons_in_polygons(inner, outer, mode=mode)
    want = j_query.polygons_in_polygons(inner, outer, mode=mode)
    assert got[0].size >= 60
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_polygon_props_matches_jax(slide):
    j, _ = slide
    polys = list(j.polygons.values())
    polys.append(np.array([[0, 0], [1, 0], [2, 0]], float))  # degenerate
    got, want = t_morph.polygon_props(polys), j_morph.polygon_props(polys)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0,
                               atol=1e-12)


def test_polygon_areas_batch_matches_jax(slide):
    j, _ = slide
    polys = list(j.polygons.values())
    np.testing.assert_allclose(t_nb.polygon_areas_batch(polys),
                               j_nb.polygon_areas_batch(polys), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("side", [25.0, 60.0])
def test_square_tiling_matches_jax(rng, side):
    pos = rng.uniform(0, 100, (3000, 2))
    got = t_part.square_tiling(pos, side_length=side)
    want = j_part.square_tiling(pos, side_length=side)
    np.testing.assert_array_equal(got.leaf_bounds, want.leaf_bounds)
    np.testing.assert_array_equal(got.leaf_counts, want.leaf_counts)
    np.testing.assert_array_equal(got.label(pos), want.label(pos))
    assert got.is_exactly_once(pos) and want.is_exactly_once(pos)


def test_quadtree_is_exactly_once_matches_jax(rng):
    pos = rng.uniform(0, 50, (4000, 2))
    got = TQuadTree.build(pos, max_leaf_size=300)
    want = JQuadTree.build(pos, max_leaf_size=300)
    np.testing.assert_array_equal(got.leaf_bounds, want.leaf_bounds)
    outside = np.vstack([pos, [[-5.0, -5.0], [80.0, 10.0]]])
    assert got.is_exactly_once(outside) and want.is_exactly_once(outside)
    # two leaves that overlap: both packages refuse them
    bad = dict(bounds=np.array([0.0, 0.0, 50.0, 50.0]),
               leaf_bounds=np.array([[0, 0, 30, 50], [20, 0, 50, 50.0]]),
               leaf_counts=np.zeros(2, np.int64), max_leaf_size=0)
    assert not TQuadTree(**bad).is_exactly_once(pos)
    assert not JQuadTree(**bad).is_exactly_once(pos)


# ----------------------------------------------------------------------
# graph builders
# ----------------------------------------------------------------------
@pytest.mark.parametrize("max_k,max_dist", [(5, 5.0), (3, 2.0)])
def test_transcripts_graph_matches_jax(slide, max_k, max_dist):
    j, _ = slide
    pos = j.transcripts[["x", "y"]].to_numpy(np.float32)
    got = t_nb.transcripts_graph(pos, max_k=max_k, max_dist=max_dist)
    want = j_nb.transcripts_graph(pos, max_k=max_k, max_dist=max_dist)
    assert got[0].dtype == np.int32 and got[0].size > len(pos)
    _assert_edges_equal(got, want)


@pytest.mark.parametrize("mode", ["cell", "nucleus", "uniform"])
def test_prediction_graph_matches_jax(slide, mode):
    j, _ = slide
    pos = j.transcripts[["x", "y"]].to_numpy(np.float32)
    btype = "nucleus" if mode == "nucleus" else "cell"
    polys = [p for (_, b), p in j.polygons.items() if b == btype]
    cents = np.array([p.mean(axis=0) for p in polys], np.float32)
    kw = dict(mode=mode, max_k=3, buffer_ratio=0.2,
              polygons=None if mode == "uniform" else polys)
    got = t_nb.prediction_graph(pos, cents, **kw)
    want = j_nb.prediction_graph(pos, cents, **kw)
    assert got[0].size > 100
    assert got[1].max() < len(polys) and got[0].max() < len(pos)
    _assert_edges_equal(got, want)


def test_segmentation_graph_matches_jax(rng):
    enc = rng.integers(-1, 50, 3000)
    mask = rng.uniform(size=3000) < 0.6
    for a, b in zip(t_nb.segmentation_graph(enc, mask),
                    j_nb.segmentation_graph(enc, mask)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ----------------------------------------------------------------------
# thresholds
# ----------------------------------------------------------------------
def _threshold_inputs(kind, rng):
    if kind == "bimodal":
        return np.concatenate([rng.normal(0.2, 0.05, 4000),
                               rng.normal(0.8, 0.05, 1000)])
    if kind == "skewed":
        return rng.beta(5, 1.2, 3000)
    if kind == "constant":
        return np.full(50, 0.37)
    if kind == "two-values":
        return np.array([0.1] * 30 + [0.9] * 5)
    return np.array([0.42])


THRESHOLD_INPUTS = ["bimodal", "skewed", "constant", "two-values", "single"]


@pytest.mark.parametrize("kind", THRESHOLD_INPUTS)
def test_threshold_yen_matches_jax(kind):
    v = _threshold_inputs(kind, np.random.default_rng(3))
    assert t_thr.threshold_yen(v) == j_thr.threshold_yen(v)


@pytest.mark.parametrize("kind", THRESHOLD_INPUTS)
def test_threshold_li_matches_jax(kind):
    v = _threshold_inputs(kind, np.random.default_rng(3))
    assert t_thr.threshold_li(v) == j_thr.threshold_li(v)


def test_threshold_li_stop_iteration_kept(rng):
    v = np.concatenate([rng.normal(0.2, 0.05, 400),
                        rng.normal(0.8, 0.05, 100)])
    for mod in (t_thr, j_thr):
        with pytest.raises(StopIteration):
            mod.threshold_li(v, max_iter=1, tol=1e-30)


# ----------------------------------------------------------------------
# PCA against scikit-learn, one shape per solver
# ----------------------------------------------------------------------
PCA_CASES = {
    # (n_samples, n_features), n_components: the cell PCA of a real slide
    "covariance_eigh": ((3000, 60), 16),
    # the test fixtures and gene-correlation PCA of panels up to 500 genes
    "full": ((200, 40), 16),
    # the gene-correlation PCA of a 5,000-gene panel, cut down
    "randomized": ((600, 520), 64),
}


def _pca_data(shape, dtype):
    rng = np.random.default_rng(11)
    x = rng.gamma(0.5, 1.0, shape) @ rng.normal(size=(shape[1], shape[1]))
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("solver", list(PCA_CASES))
def test_pca_matches_sklearn(solver, dtype):
    """Components, fit_transform and transform equal scikit-learn's at
    each solver, signs included, within 1e-10 of scale in f64 (1e-4 in
    f32, where both compute in f32)."""
    from sklearn.decomposition import PCA

    shape, k = PCA_CASES[solver]
    x = _pca_data(shape, dtype)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    ours, ref = t_pca.PCA(k, random_state=0), PCA(k, random_state=0)
    got_ft, want_ft = ours.fit_transform(x), ref.fit_transform(x)
    assert ours.svd_solver_ == ref._fit_svd_solver == solver
    assert got_ft.dtype == want_ft.dtype == dtype
    np.testing.assert_allclose(ours.components_, ref.components_, rtol=0,
                               atol=tol)
    scale = np.abs(want_ft).max()
    np.testing.assert_allclose(got_ft, want_ft, rtol=0, atol=tol * scale)
    fitted, ref_fitted = t_pca.PCA(k, 0).fit(x), PCA(k, random_state=0).fit(x)
    np.testing.assert_allclose(fitted.transform(x), ref_fitted.transform(x),
                               rtol=0, atol=tol * scale)
    np.testing.assert_allclose(fitted.mean_, ref_fitted.mean_, rtol=0,
                               atol=tol * np.abs(x).max())


@pytest.mark.parametrize("shape,k", [
    ((5000, 400), 16), ((400, 400), 16), ((600, 600), 32),
    ((600, 600), 500), ((100, 2000), 16), ((6000, 1001), 16),
])
def test_pca_solver_choice_matches_sklearn(shape, k):
    from sklearn.decomposition import PCA

    ref = PCA(k, random_state=0).fit(_pca_data(shape, np.float32))
    assert t_pca.choose_solver(shape, k) == ref._fit_svd_solver


# ----------------------------------------------------------------------
# PhenoGraph chain
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,d,k", [(300, 8, 6), (600, 32, 10),
                                   (80, 20, 50)],
                         ids=["kd_tree", "brute", "brute-large-k"])
def test_exact_knn_matches_sklearn(n, d, k):
    from sklearn.neighbors import NearestNeighbors

    X = np.random.default_rng(n).normal(size=(n, d))
    got = t_cl.exact_knn(X, k)
    want = NearestNeighbors(n_neighbors=k).fit(X).kneighbors(X)[1]
    assert got.shape == want.shape
    assert all(set(a) == set(b) for a, b in zip(got, want))
    assert (got[:, 0] == np.arange(n)).all()        # the query itself


@pytest.mark.parametrize("n,d,k", [(300, 8, 6), (600, 32, 10)])
def test_knn_jaccard_graph_matches_jax(n, d, k):
    X = np.random.default_rng(n).normal(size=(n, d))
    got, want = t_cl.knn_jaccard_graph(X, k), j_cl.knn_jaccard_graph(X, k)
    assert got.nnz == want.nnz > 0
    d = got - want
    assert (abs(d).max() if d.nnz else 0.0) < 1e-12
    labels = t_cl.louvain(got, resolution=1.0, seed=0)
    np.testing.assert_array_equal(
        labels, j_cl.louvain(want, resolution=1.0, seed=0))


def test_common_neighbor_counts_matches_spgemm(rng):
    X = rng.normal(size=(400, 16))
    J = t_cl.knn_jaccard_graph(X, 8)
    A = (J > 0).astype(np.float64)
    coo = A.tocoo()
    got = t_cl.common_neighbor_counts_spgemm(A.indptr, A.indices, coo.row,
                                             coo.col)
    truth = np.asarray((A @ A).multiply(A).todense())[coo.row, coo.col]
    np.testing.assert_array_equal(got, truth)
    assert t_cl.common_neighbor_counts_spgemm(
        np.zeros(1, np.int64), np.zeros(0, np.int64),
        np.zeros(0, np.int64), np.zeros(0, np.int64)).size == 0


@pytest.mark.parametrize("block_nnz", [1, 97, t_cl.BLOCK_NNZ])
def test_common_neighbor_counts_blocks_and_hub(block_nnz, monkeypatch):
    # a kNN graph with one hub joined to a third of the nodes, its edges
    # in a random order: every block size gives the JAX package's counts
    rng = np.random.default_rng(block_nnz % 1000)
    X = rng.normal(size=(300, 8))
    A = (t_cl.knn_jaccard_graph(X, 6) > 0).astype(np.float64).tolil()
    hub = rng.choice(np.arange(1, 300), size=100, replace=False)
    A[0, hub] = 1.0
    A[hub, 0] = 1.0
    A = A.tocsr()
    A.sort_indices()
    coo = A.tocoo()
    p = rng.permutation(coo.nnz)
    monkeypatch.setattr(t_cl, "BLOCK_NNZ", block_nnz)
    got = t_cl.common_neighbor_counts_spgemm(A.indptr, A.indices, coo.row[p],
                                      coo.col[p])
    want = j_native.common_neighbor_counts(A.indptr, A.indices, coo.row[p],
                                           coo.col[p])
    np.testing.assert_array_equal(got, want)
    assert np.diff(A.indptr).max() >= 100  # the hub's row


def test_phenograph_matches_jax():
    rng = np.random.default_rng(4)
    truth = rng.integers(0, 5, 800)
    X = rng.normal(size=(5, 24))[truth] * 6 + rng.normal(size=(800, 24))
    for kw in (dict(n_neighbors=10, resolution=2.0, min_size=20),
               dict(n_neighbors=5, resolution=1.0, min_size=-1)):
        np.testing.assert_array_equal(t_cl.phenograph(X, seed=0, **kw),
                                      j_cl.phenograph(X, seed=0, **kw))


def test_ivf_knn_recall():
    """The IVF branch on blob data (the PCA regime): recall@k >= 0.9
    against the exact neighbours, and every point finds itself."""
    rng = np.random.default_rng(0)
    n, d, k = 20_000, 32, 10
    X = rng.normal(size=(40, d))[rng.integers(0, 40, n)] * 5 \
        + rng.normal(size=(n, d))
    from sklearn.neighbors import NearestNeighbors

    approx = t_cl._ivf_knn(X, k, seed=0)
    rows = np.arange(0, n, 37)
    exact = NearestNeighbors(n_neighbors=k).fit(X).kneighbors(X[rows])[1]
    hits = [np.intersect1d(approx[r], e).size for r, e in zip(rows, exact)]
    assert np.mean(hits) / k >= 0.9
    assert (approx[rows] == rows[:, None]).any(axis=1).all()


def test_phenograph_ann_path_ari():
    """Phenograph through the IVF branch (forced by a small threshold)
    recovers planted blobs and the exact branch's clustering: ARI > 0.99
    against both."""
    from sklearn.metrics import adjusted_rand_score

    rng = np.random.default_rng(0)
    n, d = 3_000, 16
    truth = rng.integers(0, 6, n)
    X = rng.normal(size=(6, d))[truth] * 12 + rng.normal(size=(n, d))
    exact = t_cl.phenograph(X, n_neighbors=15, resolution=1.0, seed=0)
    ann = t_cl.louvain(t_cl.knn_jaccard_graph(X, 15, ann_threshold=1_000),
                       resolution=1.0, seed=0)
    assert adjusted_rand_score(truth, exact) > 0.99
    assert adjusted_rand_score(truth, ann) > 0.99
    assert adjusted_rand_score(exact, ann) > 0.99


def test_minibatch_kmeans_covers_blobs():
    """The IVF quantizer's k-means, with more lists than blobs as the IVF
    branch has: a centroid near every blob, from a seed,
    deterministically."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(8, 6)) * 20
    X = centers[rng.integers(0, 8, 6000)] + rng.normal(size=(6000, 6))
    C = t_cl.minibatch_kmeans(X, 32, seed=0, batch_size=512)
    assert C.dtype == np.float32 and C.shape == (32, 6)
    np.testing.assert_array_equal(C, t_cl.minibatch_kmeans(
        X, 32, seed=0, batch_size=512))
    nearest = np.sqrt(((centers[:, None] - C[None]) ** 2).sum(-1)).min(1)
    assert (nearest < 3.0).all(), nearest


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def predictions():
    """A seeded predictions dict with cross-tile duplicates, unassigned
    rows (-1) and genes with few transcripts."""
    rng = np.random.default_rng(7)
    n_rows, n_cells, n_genes = 3000, 120, 30
    ri = np.concatenate([np.arange(n_rows), rng.integers(0, n_rows, 600)])
    enc = rng.integers(-1, n_cells, ri.size)
    sim = np.where(enc >= 0, rng.beta(4, 2, ri.size), 0.0).astype(
        np.float32)
    gene_by_row = rng.integers(0, n_genes, n_rows)
    preds = {"row_index": ri, "cell_encoding": enc, "similarity": sim,
             "gene": gene_by_row[ri]}
    cell_ids = np.array([f"cell_{i:04d}" for i in range(n_cells)])
    gene_names = np.array([f"G{g:02d}" for g in range(n_genes)])
    return preds, cell_ids, gene_names, gene_by_row


def test_compute_gene_thresholds_matches_jax(predictions):
    preds = predictions[0]
    a = preds["cell_encoding"] >= 0
    args = (preds["similarity"][a].astype(np.float64), preds["gene"][a])
    assert t_wr.compute_gene_thresholds(*args) \
        == j_wr.compute_gene_thresholds(*args)


def test_assign_transcripts_to_cells_matches_jax(predictions):
    preds, cell_ids, gene_names, _ = predictions
    got = t_wr.assign_transcripts_to_cells(preds, cell_ids, gene_names)
    want = j_wr.assign_transcripts_to_cells(preds, cell_ids, gene_names)
    pd.testing.assert_frame_equal(got, want)
    assert got["row_index"].is_unique and got["segger_cell_id"].isna().any()


def test_assign_dense_matches_jax(predictions):
    _, cell_ids, gene_names, gene_by_row = predictions
    rng = np.random.default_rng(8)
    n = gene_by_row.size
    best_enc = rng.integers(-2, len(cell_ids), n).astype(np.int32)
    best_sim = np.where(best_enc >= 0, rng.uniform(size=n), -np.inf).astype(
        np.float32)
    args = (best_sim, best_enc, gene_by_row, cell_ids, gene_names)
    pd.testing.assert_frame_equal(t_wr.assign_dense(*args),
                                  j_wr.assign_dense(*args))


def test_writer_parquet_matches_jax(predictions, tmp_path):
    """``write`` and ``write_dense``: equal frames, and equal parquet
    files read back."""
    preds, cell_ids, gene_names, gene_by_row = predictions
    for name, mod in (("port", t_wr), ("jax", j_wr)):
        w = mod.SegmentationWriter(tmp_path / name, save_anndata=False)
        w.write(preds, cell_ids, gene_names)
        w_d = mod.SegmentationWriter(tmp_path / f"{name}_dense",
                                     save_anndata=False)
        best_sim = np.full(gene_by_row.size, -np.inf, np.float32)
        best_enc = np.full(gene_by_row.size, -2, np.int32)
        keep = np.lexsort((-preds["similarity"], preds["row_index"]))
        for i in keep[::-1]:
            r = preds["row_index"][i]
            best_sim[r] = preds["similarity"][i]
            best_enc[r] = preds["cell_encoding"][i]
        w_d.write_dense(best_sim, best_enc, gene_by_row, cell_ids,
                        gene_names)
    for sub in ("", "_dense"):
        got = pd.read_parquet(tmp_path / f"port{sub}"
                              / "segger_segmentation.parquet")
        want = pd.read_parquet(tmp_path / f"jax{sub}"
                               / "segger_segmentation.parquet")
        pd.testing.assert_frame_equal(got, want)
        assert len(got) == gene_by_row.size


# ----------------------------------------------------------------------
# the h5ad container
# ----------------------------------------------------------------------
def _anndata(mod, rng):
    X = sp.random(30, 12, density=0.3, format="csr", random_state=3,
                  dtype=np.float32)
    obs = pd.DataFrame({"n": np.arange(30), "ok": np.arange(30) % 2 == 0,
                        "kind": pd.Categorical(["a", "b", "c"] * 10)},
                       index=[f"c{i}" for i in range(30)])
    var = pd.DataFrame({"g": [f"G{i}" for i in range(12)]},
                       index=[f"g{i}" for i in range(12)])
    return mod.AnnDataLite(
        X, obs, var, obsm={"X_spatial": rng.normal(size=(30, 2))},
        varm={"X_corr": rng.normal(size=(12, 4))},
        uns={"sim": rng.normal(size=(3, 3)), "note": "x"},
        layers={"counts": X.copy()})


def _assert_anndata_equal(a, b):
    assert (a.X != b.X).nnz == 0 if sp.issparse(a.X) else (a.X == b.X).all()
    pd.testing.assert_frame_equal(a.obs, b.obs)
    pd.testing.assert_frame_equal(a.var, b.var)
    for m in ("obsm", "varm", "uns", "layers"):
        x, y = getattr(a, m), getattr(b, m)
        assert x.keys() == y.keys(), m
        for k in x:
            u, v = x[k], y[k]
            if sp.issparse(u):
                assert (u != v).nnz == 0
            else:
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_h5ad_interchange_with_jax(rng, tmp_path, direction):
    """An h5ad written by one package reads back in the other's
    ``read_h5ad`` unchanged."""
    w, r = (t_ad, j_ad) if direction == "port-to-jax" else (j_ad, t_ad)
    ad = _anndata(w, rng)
    ad.write_h5ad(tmp_path / "a.h5ad")
    back = r.read_h5ad(tmp_path / "a.h5ad")
    _assert_anndata_equal(back, ad)


def test_anndata_subset_and_copy_match_jax(rng):
    a = _anndata(t_ad, rng)
    b = j_ad.AnnDataLite(a.X, a.obs, a.var, dict(a.obsm), dict(a.varm),
                         dict(a.uns), dict(a.layers))
    oi, vi = rng.permutation(30)[:17], np.arange(12) % 3 != 0
    _assert_anndata_equal(a.subset(oi, vi), b.subset(oi, vi))
    _assert_anndata_equal(a.copy(), b.copy())


def test_h5ad_names_h5py_when_it_is_missing(rng, tmp_path, monkeypatch):
    """Without h5py the container works and its h5ad functions raise the
    ImportError that names h5py."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    ad = _anndata(t_ad, rng).subset(np.arange(5))
    assert ad.n_obs == 5
    with pytest.raises(ImportError, match="h5py"):
        ad.write_h5ad(tmp_path / "a.h5ad")
    with pytest.raises(ImportError, match="h5py"):
        t_ad.read_h5ad(tmp_path / "a.h5ad")
