"""The port's prediction slice as a whole against the JAX package, on the
small synthetic pipeline: tiling, halo tiles, extracted tiles, and
``SeggerTrainer.predict`` end to end with the same parameters."""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from segger_tpu.data import partition as jpart
from segger_tpu.data.synthetic import make_synthetic
from segger_tpu.pipeline import ISTPipeline, PipelineConfig
from segger_tpu.train.trainer import SeggerTrainer as JTrainer
from segger_tpu.train.trainer import TrainConfig as JConfig

from segger_tpu_torch.data import partition as tpart
from segger_tpu_torch.ops.gather_agg import csr_gather
from segger_tpu_torch.train.trainer import SeggerTrainer, TrainConfig

from tests.test_torch_port_ops import (
    assert_csr_equal, port_host_graph, port_tile,
)

MODEL = dict(hidden_channels=16, out_channels=16, n_mid_layers=1,
             n_heads=2, compute_dtype="float32")


@pytest.fixture(scope="module")
def pipeline():
    s = make_synthetic(n_cells=100, n_genes=24, mean_tx_per_cell=15,
                       seed=5)
    cfg = PipelineConfig(
        cells_embedding_size=8, genes_min_counts=8, cells_min_counts=4,
        tiling_nodes_per_tile=1500, tiling_margin_training=8.0,
        prediction_graph_mode="cell", prediction_graph_buffer_ratio=0.2,
    )
    p = ISTPipeline(s.transcripts, s.boundaries, s.polygons, cfg).load()
    return p.graph, port_host_graph(p.graph)


@pytest.fixture(scope="module")
def tilings(pipeline):
    jg, tg = pipeline
    jtree = jpart.build_tiling(jg, nodes_per_tile=600)
    ttree = tpart.build_tiling(tg, nodes_per_tile=600)
    jspecs = jpart.make_predict_tiles(jg, jtree, margin=8.0)
    tspecs = tpart.make_predict_tiles(tg, ttree, margin=8.0)
    return jtree, ttree, jspecs, tspecs


def test_tiling_and_predict_tiles_match_jax(tilings):
    jtree, ttree, jspecs, tspecs = tilings
    assert ttree.n_leaves == jtree.n_leaves > 1
    np.testing.assert_array_equal(ttree.leaf_bounds, jtree.leaf_bounds)
    np.testing.assert_array_equal(ttree.leaf_counts, jtree.leaf_counts)
    assert len(tspecs) == len(jspecs)
    for a, b in zip(tspecs, jspecs):
        for name in ("tx_rows", "bd_rows", "tx_interior", "bd_interior"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name))
        assert a.n_edges == b.n_edges


def test_extracted_tiles_match_jax(pipeline, tilings):
    jg, tg = pipeline
    *_, jspecs, tspecs = tilings
    jtr = JTrainer(jg, JConfig(**MODEL))
    ttr = SeggerTrainer(tg, TrainConfig(**MODEL), device="cpu")
    jplans = jtr._batch_plans(jspecs, shuffle=False, use_xlo=True)
    tplans = ttr._batch_plans(tspecs, use_xlo=True)
    assert [b for _, b in tplans] == [
        tpart.BucketShape(**dataclasses.asdict(b)) for _, b in jplans]
    bucket = tplans[0][1]
    assert bucket.n_xlo > 0 and bucket.n_lo > bucket.n_xlo
    for (ts, _), (js, jb) in zip(tplans, jplans):
        for a, b in zip(ts, js):
            got = tpart.extract_tile(tg, a, bucket)
            want = port_tile(jpart.extract_tile(jg, b, jb))
            for f in dataclasses.fields(got):
                x, y = getattr(got, f.name), getattr(want, f.name)
                if x is None or y is None or isinstance(x, (bool, int)):
                    assert x == y, f.name
                elif isinstance(x, tpart.PaddedCSR):
                    assert_csr_equal(x, y)
                else:
                    assert x.dtype == y.dtype, f.name
                    np.testing.assert_array_equal(x, y, err_msg=f.name)


def _top2_margin(trainer, specs):
    """Gap between the best and second-best candidate cosine of every
    interior transcript (inf with fewer than two candidates)."""
    out = {}
    with torch.no_grad():
        for plan in trainer._batch_plans(specs, use_xlo=True):
            batch = trainer._build_batch(plan).to("cpu")
            for b in range(batch.tx_gene.shape[0]):
                t = batch.map_arrays(lambda a: a[b])
                emb = trainer.model(t)
                cos = torch.einsum("nf,nkf->nk", emb["tx"],
                                   csr_gather(emb["bd"], t.cand))
                cos = torch.where(t.cand.mask, cos, -np.inf)
                top = cos.topk(2, dim=1).values
                gap = (top[:, 0] - top[:, 1]).nan_to_num(np.inf).numpy()
                m = (t.tx_interior & t.tx_valid).numpy()
                out.update(zip(t.tx_index.numpy()[m].tolist(), gap[m]))
    return out


@pytest.fixture(scope="module")
def predictions(pipeline, tilings):
    jg, tg = pipeline
    *_, jspecs, tspecs = tilings
    jtr = JTrainer(jg, JConfig(**MODEL))
    probe = jtr.make_batches(jspecs[:1], shuffle=False)[0]
    params = jtr.init(jax.tree.map(lambda x: x[0], probe))
    want = jtr.predict(jspecs)
    ttr = SeggerTrainer(tg, TrainConfig(**MODEL), device="cpu")
    ttr.load_params(params)
    return ttr, tspecs, want, ttr.predict(tspecs)


def test_predict_matches_jax_float32(predictions):
    ttr, tspecs, want, got = predictions
    assert got["row_index"].size == want["row_index"].size > 1000
    np.testing.assert_array_equal(np.sort(got["row_index"]),
                                  np.sort(want["row_index"]))
    gi, wi = np.argsort(got["row_index"]), np.argsort(want["row_index"])
    enc_g, enc_w = got["cell_encoding"][gi], want["cell_encoding"][wi]
    np.testing.assert_allclose(got["similarity"][gi],
                               want["similarity"][wi], atol=1e-4)
    np.testing.assert_array_equal(got["gene"][gi], want["gene"][wi])
    margin = _top2_margin(ttr, tspecs)
    clear = np.array([margin[r] > 1e-5 for r in got["row_index"][gi]])
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(enc_g[clear], enc_w[clear])
    assert (enc_g >= 0).mean() > 0.5


def test_predict_streaming_agrees_with_predict(predictions):
    ttr, tspecs, _, got = predictions
    best_sim, best_enc = ttr.predict_streaming(tspecs)
    r = got["row_index"].astype(np.int64)
    np.testing.assert_array_equal(best_enc[r], got["cell_encoding"])
    np.testing.assert_array_equal(best_sim[r], got["similarity"])
    never = np.ones(best_enc.size, bool)
    never[r] = False
    assert (best_enc[never] == -2).all()


def test_trainer_without_device_raises_without_cuda(pipeline):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SeggerTrainer(pipeline[1], TrainConfig(**MODEL))


def test_predict_before_init_raises(pipeline, tilings):
    ttr = SeggerTrainer(pipeline[1], TrainConfig(**MODEL), device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        ttr.predict(tilings[3])
