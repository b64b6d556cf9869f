"""The frozen slide generator: one seed, one slide."""
import numpy as np
import pandas as pd

from generator import constant_density_extent, make_slide

SMALL = dict(n_cells=40, n_genes=12, mean_tx_per_cell=10)


def test_same_seed_same_slide_other_seed_other_slide():
    a = make_slide(**SMALL, seed=2**33 + 5)
    b = make_slide(**SMALL, seed=2**33 + 5)
    c = make_slide(**SMALL, seed=2**33 + 6)
    pd.testing.assert_frame_equal(a.transcripts, b.transcripts)
    pd.testing.assert_frame_equal(a.boundaries, b.boundaries)
    assert all(np.array_equal(a.polygons[k], b.polygons[k])
               for k in a.polygons)
    assert not a.transcripts[["x", "y"]].equals(c.transcripts[["x", "y"]])


def test_schema_and_density():
    s = make_slide(**SMALL, extent=constant_density_extent(40), seed=3)
    tx = s.transcripts
    assert list(tx.columns) == ["row_index", "x", "y", "feature_name",
                                "cell_id", "cell_compartment"]
    assert (tx["row_index"].to_numpy() == np.arange(len(tx))).all()
    assert set(tx["cell_compartment"].unique()) <= {0, 1, 2}
    assert len(s.polygons) == 2 * 40
    assert constant_density_extent(200) == 400.0


def test_equals_the_program_generator_it_was_copied_from():
    from conftest import REPO
    import sys
    sys.path.insert(0, str(REPO))
    from segger_tpu_torch.data.synthetic import make_synthetic

    a = make_slide(**SMALL, seed=7)
    b = make_synthetic(**SMALL, seed=7)
    pd.testing.assert_frame_equal(a.transcripts, b.transcripts)
    pd.testing.assert_frame_equal(a.boundaries, b.boundaries)
