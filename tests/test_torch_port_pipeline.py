"""The port's segmentation pipeline (``segger_tpu_torch.pipeline``) against
the JAX package's on ``tests/test_e2e.py``'s synthetic slide: the
features, the whole-slide graph in every prediction mode and with
morphology embeddings, the tilings, and ``ISTPipeline.run`` on the CPU
through fit, predict and the writers."""
import dataclasses

import numpy as np
import pandas as pd
import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)
import pytest
import torch
from scipy import sparse as sp

from segger_tpu.compat.anndata_lite import AnnDataLite as JAnnData
from segger_tpu.compat.anndata_lite import read_h5ad as j_read_h5ad
from segger_tpu.data import partition as j_part
from segger_tpu.data.features import setup_features as j_setup_features
from segger_tpu.data.synthetic import make_synthetic as j_make_synthetic
from segger_tpu.pipeline import ISTPipeline as JPipeline
from segger_tpu.pipeline import PipelineConfig as JConfig

from segger_tpu_torch.compat.anndata_lite import AnnDataLite as TAnnData
from segger_tpu_torch.data import partition as t_part
from segger_tpu_torch.data.features import setup_features as t_setup_features
from segger_tpu_torch.data.synthetic import make_synthetic as t_make_synthetic
from segger_tpu_torch.data.writer import SegmentationWriter
from segger_tpu_torch.pipeline import ISTPipeline, PipelineConfig
from segger_tpu_torch.train.trainer import TrainConfig

# tests/test_e2e.py's slide, pipeline and training configurations
SLIDE = dict(n_cells=200, n_genes=40, mean_tx_per_cell=25, seed=0)
CONFIG = dict(
    cells_embedding_size=16, genes_min_counts=10, cells_min_counts=5,
    tiling_nodes_per_tile=2000, tiling_margin_training=10.0,
    tiling_margin_prediction=15.0, prediction_graph_mode="cell",
    prediction_graph_buffer_ratio=0.2,
)
TRAIN = dict(hidden_channels=32, out_channels=32, n_mid_layers=1, n_heads=2,
             max_epochs=8, edges_per_batch=100_000, seed=0)
VARIANTS = {
    "cell": {},
    "nucleus": dict(prediction_graph_mode="nucleus"),
    "uniform": dict(prediction_graph_mode="uniform"),
    "morphology": dict(cells_representation_mode="morphology"),
}


@pytest.fixture(scope="module")
def slides():
    return j_make_synthetic(**SLIDE), t_make_synthetic(**SLIDE)


def _load(slides, **over):
    j, t = slides
    jp = JPipeline(j.transcripts, j.boundaries, j.polygons,
                   JConfig(**{**CONFIG, **over})).load()
    tp = ISTPipeline(t.transcripts, t.boundaries, t.polygons,
                     PipelineConfig(**{**CONFIG, **over})).load()
    return jp, tp


@pytest.fixture(scope="module")
def cell_loads(slides):
    return _load(slides)


@pytest.fixture(scope="module", params=list(VARIANTS))
def loads(request, slides, cell_loads):
    if request.param == "cell":
        return cell_loads
    return _load(slides, **VARIANTS[request.param])


def test_features_match_jax(cell_loads):
    """obs and var in the same order, the integer tables equal, X_pca and
    X_corr within 1e-4 (f32 outputs of the same f32/f64 arithmetic), the
    phenograph clusters equal and the similarities within 1e-5."""
    ja, ta = cell_loads[0].adata, cell_loads[1].adata
    pd.testing.assert_index_equal(ta.obs.index, ja.obs.index)
    pd.testing.assert_index_equal(ta.var.index, ja.var.index)
    for col in ("n_counts", "filtered", "phenograph_cluster",
                "cell_encoding"):
        np.testing.assert_array_equal(ta.obs[col], ja.obs[col])
    for col in ("phenograph_cluster", "gene_encoding"):
        np.testing.assert_array_equal(ta.var[col], ja.var[col])
    for key in ("counts", "norm"):
        assert (ta.layers[key] != ja.layers[key]).nnz == 0
    np.testing.assert_array_equal(ta.obsm["X_spatial"], ja.obsm["X_spatial"])
    np.testing.assert_allclose(ta.obsm["X_pca"], ja.obsm["X_pca"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ta.varm["X_corr"], ja.varm["X_corr"],
                               rtol=0, atol=1e-4)
    for key in ("cell_cluster_similarities", "gene_cluster_similarities"):
        np.testing.assert_allclose(ta.uns[key], ja.uns[key], rtol=0,
                                   atol=1e-5)
    assert ta.obs["phenograph_cluster"].nunique() > 1


def test_host_graph_and_tiling_match_jax(loads):
    """Every integer array of the whole-slide graph equal, every float
    array within 1e-4, and the same tiling, fit tiles and predict tiles,
    in the cell, nucleus and uniform prediction modes and with morphology
    cell embeddings."""
    jp, tp = loads
    jg, tg = jp.graph, tp.graph
    assert tg.n_tx > 4000 and tg.n_bd == 200 and tg.cand_src.size > 0
    for f in dataclasses.fields(jg):
        a, b = getattr(tg, f.name), getattr(jg, f.name)
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(tp.tree.leaf_bounds, jp.tree.leaf_bounds)
    assert tp.tree.is_exactly_once(tg.tx_pos)
    for make in ("make_fit_tiles", "make_predict_tiles"):
        ts = getattr(t_part, make)(tg, tp.tree, margin=10.0)
        js = getattr(j_part, make)(jg, jp.tree, margin=10.0)
        assert len(ts) == len(js) > 0
        for a, b in zip(ts, js):
            for name in ("tx_rows", "bd_rows", "tx_interior", "bd_interior"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
            assert a.n_edges == b.n_edges


def test_square_tiling_of_the_slide(cell_loads):
    """Square tiles over the slide's float32 positions: the port's leaves
    cover every node exactly once, where the JAX package's square tiling
    rounds its root box's top edge onto the last node in float32 and
    raises (a known delta: the port takes the bounds in float64, and on
    float64 positions both give the same leaves)."""
    jp, tp = cell_loads
    tree = t_part.build_tiling(tp.graph, mode="square", side_length=120.0)
    pos = np.vstack([tp.graph.tx_pos, tp.graph.bd_pos])
    assert tree.n_leaves == 16 and tree.is_exactly_once(pos)
    assert (tree.label(pos) >= 0).all() and tree.leaf_counts.sum() == len(pos)
    with pytest.raises(ValueError):
        j_part.build_tiling(jp.graph, mode="square", side_length=120.0)
    ref = j_part.square_tiling(pos.astype(np.float64), 120.0)
    np.testing.assert_array_equal(tree.leaf_bounds, ref.leaf_bounds)


@pytest.mark.parametrize("strategy", ["error", "remove", "fill"])
def test_gene_corr_reference_matches_jax(slides, strategy):
    """The gene-correlation reference branches: a reference that lacks
    some of the slide's genes raises, drops them, or fills them with
    zero columns, in both packages alike.  With 'fill' the missing genes
    embed at one point, and the gene kNN's choice among those equal
    distances is the search structure's own (scikit-learn's KD-tree in
    the JAX package, SciPy's in the port), so there the gene clusters
    are not compared; the embeddings are."""
    j, _ = slides
    tx = j.transcripts[j.transcripts["cell_id"].notna()]
    genes = np.unique(tx["feature_name"].to_numpy().astype(str))[:-4]
    rng = np.random.default_rng(9)
    X = sp.csr_matrix(rng.poisson(2.0, (60, genes.size)).astype(np.float32))
    var = pd.DataFrame(index=pd.Index(genes))
    obs = pd.DataFrame(index=pd.Index([f"r{i}" for i in range(60)]))
    kw = dict(transcripts=tx, boundaries=j.boundaries, cell_column="cell_id",
              cells_embedding_size=8, cells_min_counts=5, genes_min_counts=10,
              gene_missing_strategy=strategy, seed=0)
    if strategy == "error":
        for fn, cls in ((t_setup_features, TAnnData),
                        (j_setup_features, JAnnData)):
            with pytest.raises(ValueError, match="not in the gene"):
                fn(gene_corr_reference=cls(X, obs, var), **kw)
        return
    with pytest.warns(UserWarning):
        ta = t_setup_features(gene_corr_reference=TAnnData(X, obs, var), **kw)
    with pytest.warns(UserWarning):
        ja = j_setup_features(gene_corr_reference=JAnnData(X, obs, var), **kw)
    pd.testing.assert_index_equal(ta.var.index, ja.var.index)
    np.testing.assert_allclose(ta.varm["X_corr"], ja.varm["X_corr"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ta.obsm["X_pca"], ja.obsm["X_pca"], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(ta.obs["phenograph_cluster"],
                                  ja.obs["phenograph_cluster"])
    filled = ~ta.var.index.isin(genes)
    if strategy == "remove":
        assert not filled.any()
        np.testing.assert_array_equal(ta.var["phenograph_cluster"],
                                      ja.var["phenograph_cluster"])
    else:
        assert filled.sum() > 1
        emb = ta.varm["X_corr"][filled]
        assert (emb == emb[0]).all()


@pytest.fixture(scope="module")
def run(slides, tmp_path_factory):
    """``ISTPipeline.run`` on the CPU with test_e2e.py's configurations,
    the h5ad export on."""
    _, t = slides
    out = tmp_path_factory.mktemp("port_run")
    p = ISTPipeline(t.transcripts, t.boundaries, t.polygons,
                    PipelineConfig(**CONFIG))
    seg = p.run(out, TrainConfig(**TRAIN), device="cpu")
    return p, seg, out


def test_run_writes_the_segmentation(run, slides):
    """The table on the CPU: one row per predicted transcript, accuracy
    against the true cells above test_e2e.py's 0.6, a cell for exactly
    the transcripts with a candidate edge, the parquet on disk equal to
    the table, and an h5ad that the JAX package reads."""
    p, seg, out = run
    _, t = slides
    g = p.graph
    assert seg["row_index"].is_unique and len(seg) > 4000
    np.testing.assert_array_equal(np.sort(seg["row_index"]),
                                  np.sort(g.tx_index))
    truth = pd.Series(t.truth_cell, index=t.transcripts["row_index"])
    s = seg.set_index("row_index")
    common = s.index.intersection(truth.index[truth != ""])
    acc = (s.loc[common, "segger_cell_id"] == truth.loc[common]).mean()
    assert acc > 0.6, f"assignment accuracy too low: {acc:.3f}"
    with_cand = np.unique(g.tx_index[g.cand_src])
    np.testing.assert_array_equal(
        np.sort(seg["row_index"][seg["segger_cell_id"].notna()]), with_cand)
    disk = pd.read_parquet(out / "segger_segmentation.parquet")
    pd.testing.assert_frame_equal(disk, seg.drop(columns=["feature_name"]))
    ad = j_read_h5ad(out / "segger_anndata.h5ad")
    assert ad.n_obs > 50 and "X_spatial" in ad.obsm
    assert set(p.walls) == {"features", "graph", "tiling", "fit", "predict",
                            "write"}


def test_streaming_write_equals_write(run, tmp_path):
    """``predict_streaming`` + ``write_dense`` on the run's trainer give
    the table of ``predict`` + ``write`` (test_e2e.py's checks)."""
    p, _, _ = run
    g, tr = p.graph, p.trainer
    ptiles = t_part.make_predict_tiles(g, p.tree, margin=15.0)
    gene_names = p.adata.var.index.to_numpy().astype(str)
    seg_a = SegmentationWriter(tmp_path / "a", save_anndata=False).write(
        tr.predict(ptiles), cell_ids=g.bd_cell_id, gene_names=gene_names)
    best_sim, best_enc = tr.predict_streaming(ptiles)
    gene_by_row = np.zeros(best_sim.size, np.int32)
    gene_by_row[g.tx_index] = g.tx_gene
    seg_b = SegmentationWriter(tmp_path / "b", save_anndata=False).write_dense(
        best_sim, best_enc, gene_by_row, cell_ids=g.bd_cell_id,
        gene_names=gene_names)
    a = seg_a.sort_values("row_index").reset_index(drop=True)
    b = seg_b.sort_values("row_index").reset_index(drop=True)
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(a["row_index"], b["row_index"])
    ca = a["segger_cell_id"].astype(object).to_numpy()
    cb = b["segger_cell_id"].astype(object).to_numpy()
    na = pd.isna(ca)
    assert (na == pd.isna(cb)).all() and (ca[~na] == cb[~na]).all()
    np.testing.assert_allclose(a["segger_similarity"], b["segger_similarity"],
                               rtol=1e-6)
    np.testing.assert_allclose(a["similarity_threshold"],
                               b["similarity_threshold"], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(a["converged"], b["converged"])
    np.testing.assert_array_equal(a["segger_gene"].astype(object),
                                  b["segger_gene"].astype(object))


def test_run_without_device_needs_cuda(slides, tmp_path):
    """``run()`` asks for CUDA and raises without it, before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, t = slides
    p = ISTPipeline(t.transcripts, t.boundaries, t.polygons,
                    PipelineConfig(**CONFIG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.run(tmp_path)
    assert p.graph is None and not list(tmp_path.iterdir())


def test_pipeline_takes_a_dataframe(slides):
    """A standardized DataFrame or a columnar table (held to the DataFrame
    path in ``test_torch_port_columnar.py``); anything else is refused up
    front, naming both."""
    from segger_tpu_torch.data.columnar import ColumnarTranscripts

    _, t = slides
    with pytest.raises(TypeError, match="DataFrame or a ColumnarTranscripts"):
        ISTPipeline(t.transcripts.to_dict("list"), t.boundaries, t.polygons)
    cols = ColumnarTranscripts.from_dataframe(t.transcripts)
    assert ISTPipeline(cols, t.boundaries, t.polygons).transcripts is cols
