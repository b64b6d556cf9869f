"""The command line (``chip_smoke.py``'s phase 8, small, on the CPU) with
jax, the JAX package, scikit-learn and h5py blocked: the small pipeline's
slide as a raw Xenium directory -> segment --device cpu --no-anndata ->
export transcripts boundaries; the graph from the vendor files equals the
pipeline's from the in-memory tables."""
import textwrap

from test_torch_port_imports import PIPELINE, run_standalone


def test_cli_runs_with_jax_blocked():
    run_standalone(PIPELINE + textwrap.dedent("""
        with tempfile.TemporaryDirectory() as work:
            c = chip_smoke.drive_cli(work, **PIPE_KW, graph=r["graph"])
        assert c["accuracy"] > 0.6 and c["n_rings"] > 0
        assert set(c["walls"]) == {{"write-vendor", "read",
                                   "features + graph", "fit", "predict",
                                   "write", "export-boundaries"}}
        assert "cv2" not in sys.modules     # a Xenium run never imports it
    """))
