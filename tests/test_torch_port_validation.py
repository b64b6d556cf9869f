"""The port's ``validation/`` (contamination QC) against the JAX
package's on ``tests/test_validation.py``'s toy AnnData (two spatially
separated cell types with stray counts) and reference: the neighbour
frequencies, the posterior layers, ``percent_contamination``, the
donor -> host flow matrix, the grouped reference and the expression
summary, within 1e-12."""
import numpy as np
import pandas as pd
import pytest

from segger_tpu.compat.anndata_lite import AnnDataLite as JAnnData
from segger_tpu import validation as jv

from segger_tpu_torch.compat.anndata_lite import AnnDataLite
from segger_tpu_torch import validation as tv

from tests.test_validation import reference, toy_adata  # noqa: F401

LAYERS = ("q_self", "q_neighbor", "q_background", "contamination")


def _twin(ad):
    """The same AnnData as the port's ``AnnDataLite``."""
    return AnnDataLite(ad.X.copy(), obs=ad.obs.copy(), var=ad.var.copy(),
                       obsm={k: np.array(v) for k, v in ad.obsm.items()},
                       layers={k: v.copy() for k, v in ad.layers.items()})


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(k=5, max_distance=20.0),
                                dict(k=7, normalize=False),
                                dict(k=200, max_distance=None)],
                         ids=["capped", "counts", "k above n"])
def test_neighbor_frequencies_match_jax(toy_adata, kw):  # noqa: F811
    ad = _twin(toy_adata)
    want = jv.get_neighbor_frequencies(toy_adata, col="cell_type", **kw)
    got = tv.get_neighbor_frequencies(ad, col="cell_type", **kw)
    pd.testing.assert_index_equal(got.index, want.index)
    assert list(got.columns) == list(want.columns)
    _close(got.to_numpy(), want.to_numpy())
    assert ad.obsm["neighbor_frequencies"] is got


@pytest.mark.parametrize("missing", [False, True],
                         ids=["full reference", "type and gene missing"])
def test_contamination_and_flow_match_jax(toy_adata, reference,  # noqa: F811
                                          missing):
    """The posterior layers, ``percent_contamination`` and the flow
    matrix; with a reference that lacks one gene and the hosts of a third
    cell type (JAX's guarded ``P_self = eps`` rows)."""
    ref = reference
    if missing:
        ref = ref[ref["gene_name"] != "G5"].reset_index(drop=True)
        toy_adata.obs["cell_type"] = (["A"] * 25 + ["C"] * 5
                                      + ["B"] * 30)
    ad = _twin(toy_adata)
    kw = dict(counts_layer="counts", spatial_key="X_spatial",
              cell_type_key="cell_type")
    jv.calculate_contamination(toy_adata, ref, **kw)
    tv.calculate_contamination(ad, ref, **kw)
    for name in LAYERS:
        a, b = ad.layers[name].tocsr(), toy_adata.layers[name].tocsr()
        assert a.shape == b.shape
        _close(a.toarray(), b.toarray())
    _close(ad.obs["percent_contamination"].to_numpy(),
           toy_adata.obs["percent_contamination"].to_numpy())
    fkw = dict(cell_type_key="cell_type", counts_layer="counts")
    want = jv.contamination_flow(toy_adata, ref, **fkw)
    got = tv.contamination_flow(ad, ref, **fkw)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    assert got.index.name == "source" and got.columns.name == "host"
    _close(got.to_numpy(), want.to_numpy())


def test_flow_needs_the_contamination_layer(
        toy_adata, reference):  # noqa: F811
    with pytest.raises(ValueError, match="contamination layer"):
        tv.contamination_flow(_twin(toy_adata), reference,
                              cell_type_key="cell_type",
                              counts_layer="counts")


@pytest.mark.parametrize("grouping", [{"A": "AB", "B": "AB"}, {"A": "A2"}])
def test_group_reference_matches_jax(reference, grouping):  # noqa: F811
    want = jv.group_reference(reference, grouping)
    got = tv.group_reference(reference, grouping)
    pd.testing.assert_frame_equal(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("keep_zeros", [False, True])
@pytest.mark.parametrize("min_counts", [1, 2, 6])
def test_expression_summary_matches_jax(toy_adata, keep_zeros,  # noqa: F811
                                        min_counts):
    kw = dict(min_counts=min_counts, keep_zeros=keep_zeros)
    want = jv.expression_summary_from_anndata(toy_adata, "cell_type",
                                              "counts", **kw)
    got = tv.expression_summary_from_anndata(_twin(toy_adata), "cell_type",
                                             "counts", **kw)
    pd.testing.assert_frame_equal(got, want, rtol=0, atol=1e-12)


def test_summary_as_reference_round_trip(toy_adata):  # noqa: F811
    """A reference built by ``expression_summary_from_anndata`` from the
    data itself drives ``calculate_contamination`` the same way in both
    packages."""
    ad = _twin(toy_adata)
    ref = tv.expression_summary_from_anndata(ad, "cell_type", "counts")
    kw = dict(counts_layer="counts", spatial_key="X_spatial",
              cell_type_key="cell_type")
    tv.calculate_contamination(ad, ref, **kw)
    jv.calculate_contamination(toy_adata, ref, **kw)
    _close(ad.obs["percent_contamination"].to_numpy(),
           toy_adata.obs["percent_contamination"].to_numpy())
    assert JAnnData is not AnnDataLite
