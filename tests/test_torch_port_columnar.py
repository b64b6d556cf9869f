"""The port's out-of-core path against the JAX package's: the columnar
transcript table (``data/columnar.py``) and its spool, the streamed count
matrix, the columnar graph builder, the graph saved as ``.npz`` and as a
memmappable plane (which crosses between the packages both ways and
tiles like the in-RAM graph without caching edges on its specs), the
columnar synthetic slide and its MERSCOPE writer, and a fit on a
memmapped plane, which equals the fit on the in-RAM graph.  The five
cases of ``tests/test_columnar.py`` are held here against the JAX
package's functions at that file's sizes."""
import dataclasses
import warnings

import numpy as np
import pandas as pd
import jax
import pytest

from segger_tpu.data import assemble as j_asm
from segger_tpu.data import columnar as j_col
from segger_tpu.data import partition as j_part
from segger_tpu.data import synthetic as j_syn
from segger_tpu.pipeline import ISTPipeline as JPipeline
from segger_tpu.pipeline import PipelineConfig as JPipelineConfig

from segger_tpu_torch.data import assemble as t_asm
from segger_tpu_torch.data import columnar as t_col
from segger_tpu_torch.data import partition as t_part
from segger_tpu_torch.data import synthetic as t_syn
from segger_tpu_torch.data.features import anndata_from_transcripts
from segger_tpu_torch.io.fields import StandardTranscriptFields
from segger_tpu_torch.pipeline import ISTPipeline, PipelineConfig
from segger_tpu_torch.train.graphs import tile_arrays
from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

COLS = ("x", "y", "gene_code", "cell_code", "compartment", "row_index",
        "gene_names", "cell_ids")
INT_FIELDS = ("tx_gene", "tx_cluster", "tx_index", "tx_cell_encoding",
              "bd_cluster", "bd_index", "bd_cell_id", "tt_src", "tt_dst",
              "sg_src", "sg_dst", "cand_src", "cand_dst")
FLOAT_FIELDS = ("tx_pos", "bd_x", "bd_pos", "gene_embedding",
                "tx_similarity", "bd_similarity")
CFG = dict(cells_embedding_size=8, genes_min_counts=5, cells_min_counts=3,
           prediction_graph_mode="cell", prediction_graph_max_k=3)
PLANE_CFG = dict(cells_embedding_size=16, genes_min_counts=5,
                 cells_min_counts=3, tiling_nodes_per_tile=600)


@pytest.fixture(scope="module")
def synth():
    # tests/test_columnar.py's slide
    return t_syn.make_synthetic(n_cells=90, n_genes=25, mean_tx_per_cell=18,
                                seed=11)


def _chunks(df, n=7):
    edges = np.linspace(0, len(df), n + 1).astype(int)
    for a, b in zip(edges[:-1], edges[1:]):
        yield df.iloc[a:b]


def _same_columns(a, b):
    for name in COLS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)


def _same_graph(a, b):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(a, name)),
                                   np.asarray(getattr(b, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def plane_pipeline(synth):
    """The port's DataFrame pipeline at tests/test_columnar.py's plane
    sizes, loaded."""
    return ISTPipeline(synth.transcripts, synth.boundaries, synth.polygons,
                       PipelineConfig(**PLANE_CFG)).load()


def test_from_chunks_roundtrip_matches_jax(synth):
    f = StandardTranscriptFields()
    df = synth.transcripts
    cols = t_col.ColumnarTranscripts.from_chunks(_chunks(df), f)
    _same_columns(cols, j_col.ColumnarTranscripts.from_chunks(_chunks(df)))
    assert cols.n == len(df)
    np.testing.assert_array_equal(cols.gene_names[cols.gene_code],
                                  df[f.feature].to_numpy().astype(str))
    raw = df[f.cell_id]
    unassigned = raw.isna().to_numpy() | (raw.to_numpy().astype(str) == "")
    np.testing.assert_array_equal(cols.cell_code < 0, unassigned)
    got = np.where(cols.cell_code >= 0,
                   cols.cell_ids[np.maximum(cols.cell_code, 0)], "")
    np.testing.assert_array_equal(got[~unassigned],
                                  raw.to_numpy().astype(str)[~unassigned])
    # one chunk: the vocabulary codes follow each chunk's sorted values
    _same_columns(t_col.ColumnarTranscripts.from_dataframe(df),
                  j_col.ColumnarTranscripts.from_dataframe(df))


def test_spool_roundtrip_crosses_packages(synth, tmp_path):
    """A spool is a memmapped copy of the in-RAM table, and a spool
    written by either package opens in the other."""
    df = synth.transcripts
    ram = t_col.ColumnarTranscripts.from_chunks(_chunks(df))
    spooled = t_col.ColumnarTranscripts.from_chunks(
        _chunks(df), spool=tmp_path / "port")
    assert isinstance(spooled.x, np.memmap) and not spooled.x.flags.writeable
    _same_columns(spooled, ram)
    _same_columns(t_col.ColumnarTranscripts.open_spool(tmp_path / "port"),
                  ram)
    j_col.ColumnarTranscripts.from_chunks(_chunks(df),
                                          spool=tmp_path / "jax")
    _same_columns(t_col.ColumnarTranscripts.open_spool(tmp_path / "jax"),
                  ram)
    _same_columns(j_col.ColumnarTranscripts.open_spool(tmp_path / "port"),
                  ram)
    assert [s.start for s in ram.iter_slices(1000)] == list(
        range(0, ram.n, 1000))


def test_anndata_from_columnar_matches_jax(synth):
    f = StandardTranscriptFields()
    df = synth.transcripts
    mask = np.random.default_rng(0).uniform(size=len(df)) < 0.8
    got = t_col.anndata_from_columnar(
        t_col.ColumnarTranscripts.from_chunks(_chunks(df)), mask=mask,
        chunk=1000)
    want = j_col.anndata_from_columnar(
        j_col.ColumnarTranscripts.from_chunks(_chunks(df)), mask=mask,
        chunk=1000)
    # and the DataFrame path as the pipeline calls it
    sub = df[mask & df[f.cell_id].notna().to_numpy()
             & (df[f.cell_id].to_numpy().astype(str) != "")]
    frame = anndata_from_transcripts(sub, f.feature, f.cell_id,
                                     coordinate_columns=[f.x, f.y])
    for other in (want, frame):
        np.testing.assert_array_equal(got.obs.index.to_numpy().astype(str),
                                      other.obs.index.to_numpy().astype(str))
        np.testing.assert_array_equal(got.var.index.to_numpy().astype(str),
                                      other.var.index.to_numpy().astype(str))
        np.testing.assert_array_equal(got.X.toarray(), other.X.toarray())
    np.testing.assert_array_equal(got.obsm["X_spatial"],
                                  want.obsm["X_spatial"])
    np.testing.assert_allclose(got.obsm["X_spatial"],
                               frame.obsm["X_spatial"], rtol=1e-6)


def test_pipeline_columnar_matches_dataframe_and_jax(synth):
    df = synth.transcripts
    p_df = ISTPipeline(df, synth.boundaries, synth.polygons,
                       PipelineConfig(**CFG)).load()
    p_col = ISTPipeline(t_col.ColumnarTranscripts.from_chunks(_chunks(df)),
                        synth.boundaries, synth.polygons,
                        PipelineConfig(**CFG)).load()
    j_colp = JPipeline(j_col.ColumnarTranscripts.from_chunks(_chunks(df)),
                       synth.boundaries, synth.polygons,
                       JPipelineConfig(**CFG)).load()
    _same_graph(p_col.graph, p_df.graph)
    _same_graph(p_col.graph, j_colp.graph)
    assert set(p_col.walls) == {"features", "graph", "tiling"}


def test_graph_plane_roundtrip_and_transient_tiles(plane_pipeline,
                                                   tmp_path):
    """save_host_graph_plane -> load_host_graph_plane(mmap=True) is
    lossless, pre-seeds the tile edge-group index, and extracts tiles
    equal to the in-RAM graph's with no edges cached on its specs."""
    g = plane_pipeline.graph
    t_asm.save_host_graph_plane(g, tmp_path / "plane")
    gm = t_asm.load_host_graph_plane(tmp_path / "plane", mmap=True)
    assert gm.__dict__.get("_transient_tile_edges") is True
    assert set(gm.__dict__["_edge_groups_cache"]) == {"tt", "sg", "cand"}
    assert isinstance(gm.tt_src, np.memmap)
    for f in dataclasses.fields(t_asm.HostGraph):
        np.testing.assert_array_equal(np.asarray(getattr(gm, f.name)),
                                      np.asarray(getattr(g, f.name)),
                                      err_msg=f.name)
    tree = t_part.build_tiling(g, nodes_per_tile=600)
    tree_m = t_part.build_tiling(gm, nodes_per_tile=600)
    specs = t_part.make_fit_tiles(g, tree, margin=5.0)
    specs_m = t_part.make_fit_tiles(gm, tree_m, margin=5.0)
    assert len(specs) == len(specs_m) >= 2
    bucket = t_part.merge_buckets([t_part.tile_bucket(g, s) for s in specs])
    assert bucket == t_part.merge_buckets(
        [t_part.tile_bucket(gm, s) for s in specs_m])
    for s, sm in zip(specs, specs_m):
        assert getattr(sm, "_edges", None) is None
        for a, b in zip(tile_arrays(t_part.extract_tile(g, s, bucket)),
                        tile_arrays(t_part.extract_tile(gm, sm, bucket))):
            np.testing.assert_array_equal(a, b)
        assert getattr(sm, "_edges", None) is None
    # the in-RAM graph's specs do cache their edges
    assert getattr(specs[0], "_edges", None) is not None


def test_graph_npz_roundtrip_crosses_packages(plane_pipeline, tmp_path):
    g = plane_pipeline.graph
    t_asm.save_host_graph(g, tmp_path / "g.npz")
    for loaded in (t_asm.load_host_graph(tmp_path / "g.npz"),
                   j_asm.load_host_graph(tmp_path / "g.npz")):
        for f in dataclasses.fields(t_asm.HostGraph):
            np.testing.assert_array_equal(getattr(loaded, f.name),
                                          getattr(g, f.name), err_msg=f.name)


def _jax_tile_leaves(tile):
    return [np.asarray(a) for a in jax.tree.leaves(tile)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_plane_crosses_packages(synth, tmp_path, writer):
    """A plane written by one package loads memmapped in the other, equal
    field by field, and tiles there as the writer's in-RAM graph tiles in
    the writer's package."""
    j_graph = JPipeline(synth.transcripts, synth.boundaries, synth.polygons,
                        JPipelineConfig(**PLANE_CFG)).load().graph
    t_graph = ISTPipeline(synth.transcripts, synth.boundaries,
                          synth.polygons,
                          PipelineConfig(**PLANE_CFG)).load().graph
    _same_graph(t_graph, j_graph)
    d = tmp_path / "plane"
    if writer == "jax":
        j_asm.save_host_graph_plane(j_graph, d)
        loaded, ram, part = t_asm.load_host_graph_plane(d), t_graph, t_part
        leaves = tile_arrays
    else:
        t_asm.save_host_graph_plane(t_graph, d)
        loaded, ram, part = j_asm.load_host_graph_plane(d), j_graph, j_part
        leaves = _jax_tile_leaves
    for f in dataclasses.fields(t_asm.HostGraph):
        np.testing.assert_array_equal(np.asarray(getattr(loaded, f.name)),
                                      np.asarray(getattr(ram, f.name)),
                                      err_msg=f.name)
    specs = part.make_predict_tiles(
        loaded, part.build_tiling(loaded, nodes_per_tile=600), margin=8.0)
    specs_r = part.make_predict_tiles(
        ram, part.build_tiling(ram, nodes_per_tile=600), margin=8.0)
    assert len(specs) == len(specs_r) >= 2
    bucket = part.merge_buckets([part.tile_bucket(ram, s) for s in specs_r])
    for s, sr in zip(specs, specs_r):
        for a, b in zip(leaves(part.extract_tile(loaded, s, bucket)),
                        leaves(part.extract_tile(ram, sr, bucket))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spool", [False, True], ids=["ram", "spool"])
def test_make_synthetic_columnar_matches_jax(tmp_path, spool):
    kw = dict(n_cells=70, n_genes=30, mean_tx_per_cell=15, seed=5,
              cells_per_chunk=25)
    got = t_syn.make_synthetic_columnar(
        **kw, spool=tmp_path / "port" if spool else None)
    want = j_syn.make_synthetic_columnar(
        **kw, spool=tmp_path / "jax" if spool else None)
    _same_columns(got.transcripts, want.transcripts)
    np.testing.assert_array_equal(np.asarray(got.truth_code),
                                  np.asarray(want.truth_code))
    pd.testing.assert_frame_equal(got.boundaries, want.boundaries)
    assert got.polygons.keys() == want.polygons.keys()
    for k in want.polygons:
        np.testing.assert_array_equal(got.polygons[k], want.polygons[k])
    if spool:
        for f in sorted((tmp_path / "jax").iterdir()):
            assert (tmp_path / "port" / f.name).read_bytes() \
                == f.read_bytes(), f.name


def test_write_merscope_like_columnar_matches_jax(tmp_path):
    kw = dict(n_cells=40, n_genes=20, mean_tx_per_cell=12, seed=2)
    t_syn.write_merscope_like_columnar(
        tmp_path / "port", t_syn.make_synthetic_columnar(**kw),
        chunk_rows=150)
    j_syn.write_merscope_like_columnar(
        tmp_path / "jax", j_syn.make_synthetic_columnar(**kw),
        chunk_rows=150)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        if name.endswith(".csv"):
            assert (tmp_path / "port" / name).read_bytes() == (
                tmp_path / "jax" / name).read_bytes()
        else:
            pd.testing.assert_frame_equal(
                pd.read_parquet(tmp_path / "port" / name),
                pd.read_parquet(tmp_path / "jax" / name))


def test_fit_on_memmapped_plane_equals_in_ram(plane_pipeline, tmp_path):
    """One epoch on a plane loaded with mmap=True gives the in-RAM graph's
    losses, and the trainer copies the plane's read-only arrays before
    handing them to torch (no non-writable-array warning)."""
    g = plane_pipeline.graph
    t_asm.save_host_graph_plane(g, tmp_path / "plane")
    gm = t_asm.load_host_graph_plane(tmp_path / "plane", mmap=True)
    cfg = TrainConfig(hidden_channels=16, out_channels=16, n_mid_layers=0,
                      max_epochs=1)
    hist = []
    for graph in (g, gm):
        tree = t_part.build_tiling(graph, nodes_per_tile=600)
        tr = SeggerTrainer(graph, cfg, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            hist.append(tr.fit(t_part.make_fit_tiles(graph, tree,
                                                     margin=5.0)))
            best = tr.predict_streaming(t_part.make_predict_tiles(
                graph, tree, margin=5.0))
        hist.append(best)
    assert hist[0] == hist[2]
    for a, b in zip(hist[1], hist[3]):
        np.testing.assert_array_equal(a, b)
    assert (hist[3][1] >= -1).mean() > 0.9
