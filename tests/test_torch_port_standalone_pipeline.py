"""The segmentation pipeline (``chip_smoke.py``'s phase 7, small, on the
CPU) with jax, the JAX package, scikit-learn and h5py blocked:
make_synthetic -> ISTPipeline.load() -> run(device="cpu",
save_anndata=False) -> the checks of the table, its quality report and
contamination QC."""
import textwrap

from test_torch_port_imports import PIPELINE, run_standalone


def test_pipeline_runs_with_jax_blocked():
    run_standalone(PIPELINE + textwrap.dedent("""
        assert r["accuracy"] > 0.6 and r["n_tiles"][1] > 1
        assert r["quality"]["report"]["ari"] > 0.5
        assert r["quality"]["median_percent_contamination"] >= 0
        assert set(r["walls"]) == {{"make-data", "features", "graph",
                                   "tiling", "fit", "predict", "write"}}
    """))
