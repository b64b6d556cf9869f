"""The out-of-core path (``chip_smoke.py``'s phase 9, small, on the CPU)
with jax, the JAX package, scikit-learn and h5py blocked: the small
pipeline's slide as spooled columnar chunks -> the graph equals the
pipeline's, the memmapped plane -> fit, predict_streaming, write_dense;
the MERSCOPE directory through segment --low-memory --graph-cache
(prepare in a child process, then the cached run); the native core
(built by g++ at first use) against the KDTree and SpGEMM plain
versions."""
import textwrap

from test_torch_port_imports import PIPELINE, run_standalone


def test_outofcore_runs_with_jax_blocked():
    run_standalone(PIPELINE + textwrap.dedent("""
        with tempfile.TemporaryDirectory() as work:
            o = chip_smoke.drive_outofcore(work, **PIPE_KW, graph=r["graph"],
                                           table=r["table"])
        assert o["agreement"] == 1.0 and o["accuracy"] > 0.6
        assert set(o["cli"]["walls"]) == {{"load-graph", "fit", "predict",
                                          "write"}}
        assert {{"graph.tx_knn", "graph.prediction"}} <= set(o["substages"])
        assert set(o["branches"]["walls"]) == {{"native", "kdtree"}}
        from segger_tpu_torch import native
        assert native.library_path().exists()
    """))
