"""The whole-slide path (``chip_smoke.py``'s phase 10, small, on the CPU)
with jax, the JAX package, scikit-learn and h5py blocked:
predict_whole_slide at 1 strip, 4 strips and a 2x2 grid in bf16 and f32,
the surrogate gradient, fit_whole_slide, and segment
--distributed-predict --distributed-train, from the small pipeline's
graph, weights, truth and table."""
import textwrap

from test_torch_port_imports import PIPELINE, run_standalone


def test_whole_slide_runs_with_jax_blocked():
    run_standalone(PIPELINE + textwrap.dedent("""
        with tempfile.TemporaryDirectory() as work:
            w = chip_smoke.drive_whole_slide(
                work, r["graph"], r["state"], r["truth"], r["table"],
                **PIPE_KW)
        assert set(w["checks"]) == {{"1 strip", "4 strips", "2x2 grid"}}
        assert w["grad_err"] <= chip_smoke.WS_GRAD_ATOL
        assert w["cli"]["accuracy"] > 0.6 and len(w["cli"]["history"]) == 1
    """))
