"""The port's command line (``segger_tpu_torch.cli``) against the JAX
package's: the same parsers plus ``--device``, ``segment --device cpu
--debug`` at ``tests/test_cli.py``'s sizes against ``ISTPipeline.run``
on the same frames, its checkpoint in the JAX package's
``load_checkpoint``, ``export`` against the JAX package's ``export`` on
the same segmentation directory, the boundary pool on fork and spawn,
the debug commands, the whole-slide paths (``--distributed-predict
--distributed-train [--grid]``) and ``--devices`` above the cards
visible."""
import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import jax
import jax.numpy as jnp
import pytest
import torch

from segger_tpu.cli.main import build_parser as j_build_parser
from segger_tpu.cli.main import main as j_main
from segger_tpu.cli.registry import _parse_numpydoc_params as j_numpydoc
from segger_tpu.data import partition as j_part
from segger_tpu.export.boundary import generate_boundaries as j_boundaries
from segger_tpu.io import get_preprocessor as j_get_preprocessor
from segger_tpu.pipeline import ISTPipeline as JPipeline
from segger_tpu.pipeline import PipelineConfig as JPipelineConfig
from segger_tpu.train import checkpoint as j_ckpt
from segger_tpu.train.trainer import SeggerTrainer as JTrainer
from segger_tpu.train.trainer import TrainConfig as JTrainConfig

import segger_tpu_torch.cli.segment as t_segment
from segger_tpu_torch.cli.main import build_parser, main
from segger_tpu_torch.cli.registry import _parse_numpydoc_params
from segger_tpu_torch.compat.anndata_lite import read_h5ad
from segger_tpu_torch.data.synthetic import (
    make_synthetic, write_merscope_like, write_synthetic_dataset,
)
from segger_tpu_torch.export.boundary import generate_boundaries
from segger_tpu_torch.io import get_preprocessor
from segger_tpu_torch.models.convert import params_to_flax
from segger_tpu_torch.pipeline import ISTPipeline, PipelineConfig
from segger_tpu_torch.train.trainer import TrainConfig

ROOT = Path(__file__).resolve().parents[1]
# tests/test_cli.py's sizes
PIPE = dict(cells_embedding_size=16, cells_min_counts=5, genes_min_counts=10,
            tiling_nodes_per_tile=2000, tiling_margin_training=10.0,
            tiling_margin_prediction=12.0, prediction_graph_buffer_ratio=0.2)
TRAIN = dict(hidden_channels=16, out_channels=16, n_mid_layers=0,
             max_epochs=2)


def flags(kw):
    return [a for k, v in kw.items()
            for a in ("--" + k.replace("_", "-"), str(v))]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_cli_data")
    write_synthetic_dataset(d, seed=0, n_cells=120, n_genes=30,
                            mean_tx_per_cell=20)
    return d


@pytest.fixture(scope="module")
def segmented(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_cli_seg")
    assert main(["segment", "-i", str(dataset), "-o", str(out),
                 "--device", "cpu", "--debug", *flags(PIPE),
                 *flags(TRAIN)]) == 0
    return out, t_segment.run_segment.last_run


def _subparsers(parser):
    sub = [a for a in parser._actions
           if isinstance(a, argparse._SubParsersAction)][0]
    return sub.choices


def _options(parser):
    """dest -> (flags, default, type name, choices, nargs, required)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out[a.dest] = {k: _options(p) for k, p in a.choices.items()}
            continue
        out[a.dest] = (tuple(a.option_strings), a.default,
                       getattr(a.type, "__name__", a.type), a.choices,
                       a.nargs, a.required)
    return out


def test_parsers_match_jax_plus_device():
    """Every command has the JAX package's options with the same names,
    types, defaults and choices; ``segment`` and ``debug predict-only``
    add ``--device {cuda,cpu}`` (default cuda)."""
    port, ref = _subparsers(build_parser()), _subparsers(j_build_parser())
    assert list(port) == list(ref) == ["preprocess", "segment", "export",
                                       "debug"]
    device = (("--device",), "cuda", None, ["cuda", "cpu"], None, False)
    for name in port:
        got, want = _options(port[name]), _options(ref[name])
        if name == "segment":
            assert got.pop("device") == device
        if name == "debug":
            pre = got["debug_command"]["predict-only"]
            assert pre.pop("device") == device
        assert got == want, name
    seg = _options(port["segment"])
    assert seg["tiling_nodes_per_tile"][1] == 50000
    assert seg["compute_dtype"][1] == "bfloat16"
    assert seg["segmentation_graph_mode"][3] == ["nucleus", "cell"]
    assert len(seg) > 60


def test_every_config_field_reaches_its_config():
    pf = {f.name for f in dataclasses.fields(PipelineConfig)}
    tf = {f.name for f in dataclasses.fields(TrainConfig)}
    assert pf <= set(t_segment._PIPELINE_NAMES)
    assert tf <= set(t_segment._TRAIN_NAMES)
    reg = t_segment._registry()
    assert set(reg.parameters) == pf | tf


def test_numpydoc_params_like_jax():
    doc = ("Summary.\n\n    Parameters\n    ----------\n"
           "    tiling_mode : str\n        adaptive: split by node count\n"
           "    seed\n        RNG seed.\n\n    other : int\n"
           "        more text\n        on two lines\n")
    out = _parse_numpydoc_params(doc)
    assert out == j_numpydoc(doc)
    assert out["seed"] == "RNG seed."
    assert out["other"] == "more text on two lines"
    assert "split by node count" in out["tiling_mode"]


def test_segment_outputs(segmented):
    out, _ = segmented
    for name in ("segger_segmentation.parquet", "segger_anndata.h5ad",
                 "metrics.csv", "params.json", "debug/checkpoint.npz",
                 "debug/adata_debug.h5ad", "debug/predictions.pkl"):
        assert (out / name).exists(), name
    seg = pd.read_parquet(out / "segger_segmentation.parquet")
    assert {"row_index", "segger_cell_id", "segger_similarity",
            "similarity_threshold"} <= set(seg.columns)
    assert len(seg) > 1000
    assert len(pd.read_csv(out / "metrics.csv")) == TRAIN["max_epochs"]


def test_segment_equals_pipeline_run(dataset, segmented, tmp_path):
    """The command's table equals ``ISTPipeline.run(device="cpu")`` on the
    preprocessor's frames with the same configurations: the same rows and
    cell ids, similarities within 1e-6."""
    out, last = segmented
    assert set(last["walls"]) == {"read", "features + graph", "fit",
                                  "predict", "write"}
    pp = get_preprocessor(dataset)
    bd, polys = pp.boundaries
    p = ISTPipeline(pp.transcripts, bd, polys, PipelineConfig(**PIPE))
    want = p.run(tmp_path, TrainConfig(**TRAIN), save_anndata=False,
                 device="cpu")
    got = pd.read_parquet(out / "segger_segmentation.parquet")
    want = want.drop(columns=["feature_name"])
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got["row_index"], want["row_index"])
    a = got["segger_cell_id"].astype(object).to_numpy()
    b = want["segger_cell_id"].astype(object).to_numpy()
    assert (pd.isna(a) == pd.isna(b)).all()
    assert (a[pd.notna(a)] == b[pd.notna(b)]).all()
    np.testing.assert_allclose(got["segger_similarity"],
                               want["segger_similarity"], rtol=0, atol=1e-6)
    assert p.trainer.history == last["trainer"].history


def test_debug_checkpoint_loads_in_jax(dataset, segmented):
    """``debug/checkpoint.npz`` restores in the JAX package's
    ``load_checkpoint`` against the JAX trainer's own templates: the
    port's parameters to 0.0, its Adam step count."""
    out, last = segmented
    tr = last["trainer"]
    jp = j_get_preprocessor(dataset)
    bd, polys = jp.boundaries
    jpipe = JPipeline(jp.transcripts, bd, polys,
                      JPipelineConfig(**PIPE)).load()
    jtr = JTrainer(jpipe.graph, JTrainConfig(**TRAIN))
    specs = j_part.make_fit_tiles(jpipe.graph, jpipe.tree, margin=10.0)
    plan = jtr._batch_plans(specs, shuffle=False)[0]
    jtile = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)[0]),
                         jtr._build_batch(plan, cache=False))
    tmpl = jtr.init(jtile)
    params, opt_state, meta = j_ckpt.load_checkpoint(
        out / "debug" / "checkpoint.npz", tmpl, jtr.opt_state)
    assert meta["config"]["hidden_channels"] == TRAIN["hidden_channels"]
    want = jax.tree_util.tree_leaves(params_to_flax(tr.model))
    got = jax.tree_util.tree_leaves(params)
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert int(jax.tree_util.tree_leaves(opt_state)[0]) == len(tr.step_log)


def _export(run, dataset, seg_dir, out, *extra):
    assert run(["export", "-i", str(dataset), "-s", str(seg_dir), "-o",
                str(out), "anndata", "transcripts", "boundaries",
                *extra]) == 0
    return out


def _vertices(path):
    return pd.read_parquet(path).sort_values(
        ["cell_id"], kind="stable").reset_index(drop=True)


@pytest.mark.parametrize("extra", [
    ("--threshold-mode", "none", "--min-transcripts", "5"),
    ("--boundary-method", "convex_hull", "--smoothing", "2",
     "--min-transcripts", "3"),
], ids=["delaunay", "convex-hull-smoothed"])
def test_export_equals_jax(dataset, segmented, tmp_path, extra):
    seg_dir = segmented[0]
    t = _export(main, dataset, seg_dir, tmp_path / "t", *extra)
    j = _export(j_main, dataset, seg_dir, tmp_path / "j", *extra)
    pd.testing.assert_frame_equal(
        pd.read_parquet(t / "segger_transcripts.parquet"),
        pd.read_parquet(j / "segger_transcripts.parquet"))
    tb = _vertices(t / "segger_boundaries.parquet")
    jb = _vertices(j / "segger_boundaries.parquet")
    assert tb["cell_id"].nunique() > 20
    pd.testing.assert_frame_equal(tb[["cell_id", "n_transcripts"]],
                                  jb[["cell_id", "n_transcripts"]])
    np.testing.assert_allclose(tb[["vertex_x", "vertex_y"]],
                               jb[["vertex_x", "vertex_y"]], rtol=0,
                               atol=1e-9)
    ta = read_h5ad(t / "segger_anndata.h5ad")
    ja = read_h5ad(j / "segger_anndata.h5ad")
    pd.testing.assert_frame_equal(ta.obs, ja.obs)
    pd.testing.assert_frame_equal(ta.var, ja.var)
    assert (ta.X != ja.X).nnz == 0
    np.testing.assert_array_equal(ta.obsm["X_spatial"], ja.obsm["X_spatial"])
    assert ta.uns["spatialdata_attrs"] == ja.uns["spatialdata_attrs"]


_POOLS = """
import pickle, sys
import pandas as pd
import torch
from segger_tpu_torch.export.boundary import generate_boundaries
df = pd.read_parquet(sys.argv[1])
kw = dict(cell_id="segger_cell_id")
runs = {"serial": generate_boundaries(df, workers=0, **kw),
        "fork": generate_boundaries(df, workers=2, **kw)}
torch.cuda.is_initialized = lambda: True     # as after CUDA init
runs["spawn"] = generate_boundaries(df, workers=2, **kw)
assert generate_boundaries.pools == {"fork": 1, "spawn": 1}
with open(sys.argv[2], "wb") as f:
    pickle.dump(runs, f)
"""


def test_boundary_pool_fork_and_spawn(dataset, segmented, tmp_path):
    """One worker, a forked pool and a spawned pool (the start method the
    pool takes once CUDA is initialized) outline every cell as the JAX
    package's one worker does, within 1e-9.  The pools run in a process
    of their own, without JAX's threads to fork."""
    import pickle

    from segger_tpu_torch.cli.export import load_assigned

    df = load_assigned(dataset, segmented[0], threshold_mode="none",
                       min_transcripts=3)
    df.to_parquet(tmp_path / "assigned.parquet")
    res = subprocess.run(
        [sys.executable, "-c", _POOLS, str(tmp_path / "assigned.parquet"),
         str(tmp_path / "runs.pkl")],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(tmp_path / "runs.pkl", "rb") as f:
        runs = pickle.load(f)
    want = j_boundaries(df, cell_id="segger_cell_id", workers=0)
    assert len(want) > 20
    for name, got in runs.items():
        pd.testing.assert_index_equal(got.index, want.index)
        np.testing.assert_array_equal(got["n_transcripts"],
                                      want["n_transcripts"])
        for g, w in zip(got["polygon"], want["polygon"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9,
                                       err_msg=name)


def test_debug_segment_only(segmented, tmp_path):
    out = segmented[0]
    assert main(["debug", "segment-only", "-d", str(out / "debug"), "-o",
                 str(tmp_path / "reseg")]) == 0
    got = pd.read_parquet(tmp_path / "reseg" / "segger_segmentation.parquet")
    want = pd.read_parquet(out / "segger_segmentation.parquet")
    pd.testing.assert_frame_equal(got, want)


def test_debug_predict_only(dataset, segmented, tmp_path):
    """The checkpoint restored into a fresh trainer predicts the
    segmentation again: the same rows, cell ids and similarities."""
    out = segmented[0]
    assert main(["debug", "predict-only", "-i", str(dataset), "-c",
                 str(out / "debug" / "checkpoint.npz"), "-o",
                 str(tmp_path / "repred"), "--device", "cpu"]) == 0
    got = pd.read_parquet(tmp_path / "repred" / "segger_segmentation.parquet")
    want = pd.read_parquet(out / "segger_segmentation.parquet")
    pd.testing.assert_frame_equal(got, want)


UNPORTED = {
    "--devices": (["2"], "2 shards need 2 devices"),
}


@pytest.mark.parametrize("option", list(UNPORTED))
def test_unported_option_raises_before_reading(option, tmp_path,
                                               monkeypatch):
    """An option the machine cannot honour raises before the input is
    read (the input does not exist) and before anything is written:
    ``--devices`` above the cards visible (one card here).  Tile data
    parallelism itself is ported (``tests/test_torch_port_tile_dp.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    values, message = UNPORTED[option]
    with pytest.raises(ValueError, match=message):
        main(["segment", "-i", str(tmp_path / "missing"), "-o",
              str(tmp_path / "out"), option, *values])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("extra", [[], ["--devices", "3"],
                                   ["--grid", "2x2"]],
                         ids=["strip", "strips", "grid"])
def test_segment_distributed(dataset, tmp_path, extra):
    """``segment --distributed-predict --distributed-train`` trains and
    predicts on the whole slide (one strip on the CPU, three strips, or a
    2x2 grid of CPU shards): one optimizer step per epoch, and a table
    with one row per transcript."""
    out = tmp_path / "out"
    assert main(["segment", "-i", str(dataset), "-o", str(out), "--device",
                 "cpu", "--no-anndata", "--distributed-predict",
                 "--distributed-train", *flags(PIPE),
                 *flags({**TRAIN, "max_epochs": 1}), *extra]) == 0
    last = t_segment.run_segment.last_run
    g, tr = last["graph"], last["trainer"]
    assert set(last["walls"]) == {"read", "features + graph", "fit",
                                  "predict", "write"}
    assert len(tr.history) == 1 and np.isfinite(tr.history[0]["train:loss"])
    seg = pd.read_parquet(out / "segger_segmentation.parquet")
    assert seg["row_index"].is_unique
    np.testing.assert_array_equal(np.sort(seg["row_index"]),
                                  np.sort(g.tx_index))
    assert seg["segger_cell_id"].notna().mean() > 0.5
    assert len(pd.read_csv(out / "metrics.csv")) == 1


def test_segment_without_device_needs_cuda(tmp_path):
    """Without ``--device cpu`` the command asks for CUDA: with no card it
    exits non-zero with ``resolve_device``'s message, before it reads or
    writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run(
        [sys.executable, "-m", "segger_tpu_torch.cli.main", "segment", "-i",
         str(tmp_path / "missing"), "-o", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not list(tmp_path.iterdir())


def test_prepare_only_needs_no_device(dataset, tmp_path):
    """``--prepare-only`` builds features and graph and stops before any
    device is asked for."""
    out = tmp_path / "prep"
    assert main(["segment", "-i", str(dataset), "-o", str(out),
                 "--prepare-only", *flags(PIPE)]) == 0
    last = t_segment.run_segment.last_run
    assert last["trainer"] is None and last["pipeline"].graph.n_bd == 120
    assert not (out / "segger_segmentation.parquet").exists()


def _same_table(got, want):
    """Two segmentation tables with the same rows, cells, genes and
    convergence, similarities within float32 rounding (``write`` and
    ``write_dense`` build the same table by two routes)."""
    a = got.sort_values("row_index").reset_index(drop=True)
    b = want.sort_values("row_index").reset_index(drop=True)
    np.testing.assert_array_equal(a["row_index"], b["row_index"])
    for col in ("segger_cell_id", "segger_gene"):
        x = a[col].astype(object).to_numpy()
        y = b[col].astype(object).to_numpy()
        np.testing.assert_array_equal(pd.isna(x), pd.isna(y))
        np.testing.assert_array_equal(x[~pd.isna(x)], y[~pd.isna(y)])
    np.testing.assert_array_equal(a["converged"], b["converged"])
    for col in ("segger_similarity", "similarity_threshold"):
        np.testing.assert_allclose(a[col], b[col], rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def low_memory_cached(dataset, tmp_path_factory):
    """``segment --low-memory --graph-cache`` on the dataset: the first run
    reads, builds and writes the cache."""
    work = tmp_path_factory.mktemp("port_cli_lowmem")
    assert main(["segment", "-i", str(dataset), "-o", str(work / "out"),
                 "--device", "cpu", "--low-memory", "--graph-cache",
                 str(work / "cache"), *flags(PIPE), *flags(TRAIN)]) == 0
    return work, t_segment.run_segment.last_run


def test_low_memory_segment_equals_dataframe_segment(low_memory_cached,
                                                      segmented):
    """The columnar table streamed into a spool, the same graph as the
    DataFrame run's, predict_streaming + write_dense: the same table."""
    work, last = low_memory_cached
    assert set(last["walls"]) == {"read", "features + graph", "save-graph",
                                  "fit", "predict", "write"}
    assert (work / "out" / "transcripts_spool" / "x.bin").exists()
    assert (work / "cache" / "plane" / "_eg_tt_order.npy").exists()
    # the columnar graph: integers equal, floats within rounding (the
    # centroids are summed in another order)
    want_graph = segmented[1]["pipeline"].graph
    for f in dataclasses.fields(want_graph):
        a, b = getattr(last["graph"], f.name), getattr(want_graph, f.name)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert not (work / "out" / "segger_anndata.h5ad").exists()
    _same_table(
        pd.read_parquet(work / "out" / "segger_segmentation.parquet"),
        pd.read_parquet(segmented[0] / "segger_segmentation.parquet"))


def test_graph_cache_run_loads_the_plane(low_memory_cached, tmp_path):
    """The second run finds the cache: it reads no input (there is none),
    builds nothing, trains on the memmapped plane and writes the same
    parquet."""
    work, _ = low_memory_cached
    assert main(["segment", "-i", str(tmp_path / "missing"), "-o",
                 str(tmp_path / "out"), "--device", "cpu", "--low-memory",
                 "--graph-cache", str(work / "cache"), *flags(PIPE),
                 *flags(TRAIN)]) == 0
    last = t_segment.run_segment.last_run
    assert set(last["walls"]) == {"load-graph", "fit", "predict", "write"}
    assert last["pipeline"] is None
    assert last["graph"].__dict__.get("_transient_tile_edges") is True
    pd.testing.assert_frame_equal(
        pd.read_parquet(tmp_path / "out" / "segger_segmentation.parquet"),
        pd.read_parquet(work / "out" / "segger_segmentation.parquet"))


_NO_CUDA = """
import json, sys
import torch

def refuse(*a, **k):
    raise AssertionError("CUDA touched")

torch.cuda.is_available = torch.cuda.device_count = refuse
torch.cuda._lazy_init = torch.cuda.init = refuse
from segger_tpu_torch.cli.main import main
rc = main({argv!r})
print(json.dumps({{"rc": rc, "cuda": torch.cuda.is_initialized()}}))
"""


def test_prepare_only_graph_cache_touches_no_cuda(dataset, tmp_path):
    """``--low-memory --graph-cache --prepare-only`` builds and caches the
    graph in a process where any CUDA query raises."""
    argv = ["segment", "-i", str(dataset), "-o", str(tmp_path / "out"),
            "--low-memory", "--graph-cache", str(tmp_path / "cache"),
            "--prepare-only", *flags(PIPE)]
    res = subprocess.run([sys.executable, "-c", _NO_CUDA.format(argv=argv)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == '{"rc": 0, "cuda": false}'
    assert (tmp_path / "cache" / "plane" / "tx_gene.npy").exists()
    assert (tmp_path / "cache" / "gene_names.npy").exists()
    assert not (tmp_path / "out" / "segger_segmentation.parquet").exists()


def test_jax_prepared_cache_runs_in_port(dataset, low_memory_cached,
                                         tmp_path):
    """The phased workflow across the packages: the JAX package's
    ``segment --prepare-only --graph-cache`` writes the plane, the port's
    ``segment --graph-cache`` trains on it; the plane is the port's own
    and the table the port's cached run's."""
    work, _ = low_memory_cached
    cache = tmp_path / "cache"
    assert j_main(["segment", "-i", str(dataset), "-o", str(tmp_path / "j"),
                   "--low-memory", "--graph-cache", str(cache),
                   "--prepare-only", *flags(PIPE)]) == 0
    for f in sorted((work / "cache" / "plane").iterdir()):
        np.testing.assert_array_equal(
            np.load(cache / "plane" / f.name),
            np.load(f), err_msg=f.name)
    np.testing.assert_array_equal(np.load(cache / "gene_names.npy"),
                                  np.load(work / "cache" / "gene_names.npy"))
    assert main(["segment", "-i", str(tmp_path / "missing"), "-o",
                 str(tmp_path / "out"), "--device", "cpu", "--low-memory",
                 "--graph-cache", str(cache), *flags(PIPE),
                 *flags(TRAIN)]) == 0
    pd.testing.assert_frame_equal(
        pd.read_parquet(tmp_path / "out" / "segger_segmentation.parquet"),
        pd.read_parquet(work / "out" / "segger_segmentation.parquet"))


def test_preprocess_command_like_jax(tmp_path):
    """``preprocess`` standardizes a raw MERSCOPE directory into what the
    JAX package's command writes from it."""
    s = make_synthetic(n_cells=60, n_genes=20, mean_tx_per_cell=15, seed=1)
    raw = write_merscope_like(tmp_path / "raw", s)
    assert main(["preprocess", "-i", str(raw), "-o",
                 str(tmp_path / "t")]) == 0
    assert j_main(["preprocess", "-i", str(raw), "-o",
                   str(tmp_path / "j")]) == 0
    for name in ("transcripts.parquet", "boundaries.parquet"):
        pd.testing.assert_frame_equal(
            pd.read_parquet(tmp_path / "t" / name),
            pd.read_parquet(tmp_path / "j" / name))
    pp = get_preprocessor(tmp_path / "t")
    assert type(pp).__name__ == "StandardPreprocessor"
    assert len(pp.transcripts) == len(s.transcripts)


def _clouds():
    rng = np.random.default_rng(4)
    blob = rng.normal(size=(60, 2)) * [3.0, 1.5]
    ring = np.c_[np.cos(np.linspace(0, 6, 40)), np.sin(np.linspace(0, 6, 40))]
    return {
        "blob": (blob, {}),
        "blob-convex-hull": (blob, {"method": "convex_hull"}),
        "blob-smoothed": (blob, {"smoothing": 2}),
        "blob-tight": (blob, {"connectivity": 0.5}),
        "crescent": (ring * rng.uniform(0.8, 1.2, (40, 1)), {}),
        "duplicates": (np.vstack([blob[:10], blob[:10]]), {}),
        "collinear": (np.c_[np.arange(8.0), 2 * np.arange(8.0)], {}),
        "two-points": (blob[:2], {}),
        "collinear-hull": (np.c_[np.arange(8.0), np.arange(8.0)],
                           {"method": "convex_hull"}),
    }


@pytest.mark.parametrize("name", list(_clouds()))
def test_cell_boundary_like_jax(name):
    """One cell's outline, Delaunay-pruned or convex, smoothed or not, and
    the degenerate clouds that give none, as the JAX package's."""
    from segger_tpu.export.boundary import cell_boundary as j_cell
    from segger_tpu_torch.export.boundary import cell_boundary

    pts, kw = _clouds()[name]
    got, want = cell_boundary(pts, **kw), j_cell(pts, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    if name.startswith(("collinear", "two")):
        assert got is None


def test_log_records_carry_memory():
    """Every record of the port's logger carries host RSS, and free
    device memory only once CUDA is initialized."""
    from segger_tpu_torch import utils

    log = utils.setup_logging("INFO")
    assert log.name == "segger_tpu_torch" and not log.propagate
    mem = utils.free_mem_str()
    assert mem.endswith("RSS") or "RSS," in mem
    assert ("GPU free" in mem) == torch.cuda.is_initialized()
    rec = log.makeRecord(log.name, 20, __file__, 1, "x", (), None)
    assert utils.MemFilter().filter(rec) and "RSS" in rec.mem
    assert utils.peak_rss_gb() > 0
