"""SpatialData/SOPA-convention AnnData export.

Re-implements the reference's table builder
(reference: src/segger/export/anndata_writer.py:12-45): obs indexed by
cell_id with n_transcripts (+ optional polygon areas), spatial centroids
in obsm, and the spatialdata_attrs region/instance-key link in uns.
The port's copy of ``segger_tpu.export.anndata_writer``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from ..compat.anndata_lite import AnnDataLite
from ..data.features import anndata_from_transcripts
from ..geometry.morphology import polygon_area


def build_anndata(
    transcripts: pd.DataFrame,
    cell_id_column: str = "segger_cell_id",
    feature_column: str = "feature_name",
    x: str = "x",
    y: str = "y",
    boundaries: Optional[pd.DataFrame] = None,
    region_key: str = "region",
    region: str = "cell_boundaries",
    instance_key: str = "cell_id",
) -> AnnDataLite:
    ad = anndata_from_transcripts(
        transcripts,
        feature_column=feature_column,
        cell_id_column=cell_id_column,
        coordinate_columns=[x, y],
    )
    ad.obs["n_transcripts"] = np.asarray(ad.X.sum(axis=1)).ravel()
    ad.obs[region_key] = region
    ad.obs[instance_key] = ad.obs.index.to_numpy().astype(str)
    if boundaries is not None and "polygon" in boundaries.columns:
        areas = pd.Series(
            [polygon_area(p) for p in boundaries["polygon"]],
            index=boundaries.index.astype(str),
        )
        ad.obs["area"] = (
            pd.Series(ad.obs.index.astype(str), index=ad.obs.index)
            .map(areas)
            .to_numpy()
        )
    ad.uns["spatialdata_attrs"] = {
        "region": region,
        "region_key": region_key,
        "instance_key": instance_key,
    }
    return ad
