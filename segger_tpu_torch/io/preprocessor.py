"""Platform preprocessors: raw vendor outputs -> standardized dataset.

Re-implements the reference's preprocessor registry + platform readers
(reference: src/segger/io/preprocessor.py:37-578) on pandas/pyarrow, with
polygons as NumPy vertex arrays instead of GEOS geometries:

  - decorator registry keyed by platform name, auto-inference requiring
    exactly one matching ``_validate_directory``
  - Xenium v>=2 and v1 (null-cell sentinel 'UNASSIGNED' vs '-1'), QV>=20
    + control-probe filters, compartment standardization, flat-vertex
    boundary parquet
  - CosMX: CSV transcripts + label-mask TIFF boundaries
  - MERSCOPE: implemented (the reference leaves it a stub but its
    BASELINE names a MERSCOPE whole-slide run): CSV transcripts + WKB
    boundary parquet
  - 'standard': a directory already in the standardized schema (the
    output of :meth:`ISTPreprocessor.save`)

Standard transcript schema: row_index, x, y, feature_name, cell_id,
cell_compartment (0=extracellular, 1=cytoplasmic, 2=nucleus).
Standard boundaries: one vertex per row (cell_id, boundary_type,
contains_nucleus, vertex_x, vertex_y).

The port's copy of ``segger_tpu.io.preprocessor``: the same filters, row
indexing and compartment coding, so the two packages read one directory
into equal frames.  The intersection, CosMX and WKB modules are imported
lazily, so a Xenium run never imports ``cv2``.
"""
from __future__ import annotations

import json
import logging
import re
from abc import ABC, abstractmethod
from functools import cached_property
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from .fields import (
    CosMxBoundaryFields,
    CosMxTranscriptFields,
    MerscopeBoundaryFields,
    MerscopeTranscriptFields,
    StandardBoundaryFields,
    StandardTranscriptFields,
    XeniumBoundaryFields,
    XeniumTranscriptFields,
    XeniumTranscriptFieldsV1,
)
from .utils import contours_to_polygons, fix_invalid_geometry

logger = logging.getLogger(__name__)

PREPROCESSORS: Dict[str, type] = {}


def register_preprocessor(name: str):
    """Register a preprocessor class under a platform name
    (reference: preprocessor.py:40-57)."""

    def decorator(cls):
        PREPROCESSORS[name] = cls
        return cls

    return decorator


class ISTPreprocessor(ABC):
    """Platform-specific standardization.

    ``transcripts`` -> standard-schema DataFrame;
    ``boundaries`` -> (DataFrame, polygons dict keyed (cell_id, type)).
    """

    def __init__(self, data_dir):
        data_dir = Path(data_dir)
        type(self)._validate_directory(data_dir)
        self.data_dir = data_dir

    @staticmethod
    @abstractmethod
    def _validate_directory(data_dir: Path):
        ...

    @property
    @abstractmethod
    def transcripts(self) -> pd.DataFrame:
        ...

    @property
    @abstractmethod
    def boundaries(self) -> Tuple[pd.DataFrame, Dict]:
        ...

    def iter_transcripts(self, batch_rows: int = 4_000_000):
        """Standardized transcript batches.

        Platform readers with streaming-capable raw formats override
        this (Xenium/CosMX/MERSCOPE); the fallback slices the eager
        table, so every platform supports ``save(streaming=True)``."""
        tx = self.transcripts
        for start in range(0, max(len(tx), 1), batch_rows):
            chunk = tx.iloc[start:start + batch_rows]
            if len(chunk):
                yield chunk

    # ------------------------------------------------------------------
    def save(
        self,
        out_dir,
        overwrite: bool = False,
        streaming: bool = False,
        batch_rows: int = 4_000_000,
    ):
        """Write the standardized dataset (readable by the 'standard'
        preprocessor; analogous to reference save(), preprocessor.py:
        124-192, minus the optional geoarrow artifacts).

        ``streaming=True`` standardizes and writes transcripts batch by
        batch (readers exposing ``iter_transcripts``) so whole-slide
        inputs never materialize in RAM."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        std_t = StandardTranscriptFields()
        std_b = StandardBoundaryFields()
        tx_path = out_dir / std_t.filename
        bd_path = out_dir / std_b.filename
        if tx_path.exists() and not overwrite:
            raise IOError(f"{tx_path} exists (pass overwrite=True)")
        if streaming and hasattr(self, "iter_transcripts"):
            import pyarrow as pa
            import pyarrow.parquet as pq

            # explicit schema: inference would lock the writer to the
            # FIRST chunk's types, and an all-None object cell_id chunk
            # infers null — a later string chunk (or the converse)
            # would fail mid-write and truncate the output
            schema = pa.schema(
                [
                    (std_t.row_index, pa.int64()),
                    (std_t.x, pa.float64()),
                    (std_t.y, pa.float64()),
                    (std_t.feature, pa.string()),
                    (std_t.cell_id, pa.string()),
                    (std_t.compartment, pa.int8()),
                ]
            )
            writer = pq.ParquetWriter(tx_path, schema)
            try:
                for chunk in self.iter_transcripts(batch_rows):
                    table = pa.Table.from_pandas(
                        chunk[list(schema.names)], schema=schema,
                        preserve_index=False,
                    )
                    writer.write_table(table)
            finally:
                writer.close()
        else:
            self.transcripts.to_parquet(tx_path, index=False)
        bd, polys = self.boundaries
        rows = []
        meta = bd.set_index([std_b.id, std_b.boundary_type])
        for (cid, btype), poly in polys.items():
            contains = bool(
                meta.loc[(cid, btype), std_b.contains_nucleus]
            )
            for v in np.asarray(poly):
                rows.append((cid, btype, contains, v[0], v[1]))
        pd.DataFrame(
            rows,
            columns=[std_b.id, std_b.boundary_type,
                     std_b.contains_nucleus, "vertex_x", "vertex_y"],
        ).to_parquet(bd_path, index=False)
        return out_dir


def _intersect_nuclei(cell_ids, cell_polys, nuc_ids, nuc_polys):
    """Clip each nucleus ring to its cell ring (the reference's
    disabled-by-comment intent, preprocessor.py:487-501).

    Nuclei with no overlapping cell ring are DROPPED (the '10x bug'
    removal the disabled block performed); degenerate contacts fall
    back to the vendor ring (counted in the log)."""
    from ..geometry.boolean import (
        DegenerateIntersection, largest_ring, polygon_intersection,
    )

    cells = dict(zip(cell_ids, cell_polys))
    out_ids, out_polys = [], []
    n_clip = n_drop = n_fallback = 0
    for nid, npoly in zip(nuc_ids, nuc_polys):
        cpoly = cells.get(nid)
        if cpoly is None:
            out_ids.append(nid)
            out_polys.append(npoly)
            continue
        try:
            ring = largest_ring(polygon_intersection(npoly, cpoly))
        except DegenerateIntersection:
            n_fallback += 1
            out_ids.append(nid)
            out_polys.append(npoly)
            continue
        if ring is None or len(ring) < 3:
            n_drop += 1
            continue
        if len(ring) != len(npoly):
            n_clip += 1
        out_ids.append(nid)
        out_polys.append(ring.astype(np.float64))
    logger.info(
        "nucleus_strategy=intersect: %d clipped, %d dropped "
        "(non-overlapping), %d degenerate fallbacks of %d nuclei",
        n_clip, n_drop, n_fallback, len(nuc_ids),
    )
    return out_ids, out_polys


def _build_boundary_frame(
    cell_ids, cell_polys, nuc_ids, nuc_polys
) -> Tuple[pd.DataFrame, Dict]:
    """Combine cell + nucleus polygons into the standard boundary table
    with contains_nucleus flags (reference: preprocessor.py:503-518)."""
    std = StandardBoundaryFields()
    cell_polys, keep_c = fix_invalid_geometry(cell_polys)
    nuc_polys, keep_n = fix_invalid_geometry(nuc_polys)
    cells = [
        (i, p) for i, p, k in zip(cell_ids, cell_polys, keep_c) if k
    ]
    nucs = [(i, p) for i, p, k in zip(nuc_ids, nuc_polys, keep_n) if k]
    nuc_id_set = {i for i, _ in nucs}
    rows, polys = [], {}
    for cid, poly in cells:
        rows.append((cid, std.cell_value, cid in nuc_id_set))
        polys[(cid, std.cell_value)] = poly
    for cid, poly in nucs:
        rows.append((cid, std.nucleus_value, True))
        polys[(cid, std.nucleus_value)] = poly
    bd = pd.DataFrame(
        rows, columns=[std.id, std.boundary_type, std.contains_nucleus]
    )
    return bd, polys


# ----------------------------------------------------------------------
@register_preprocessor("standard")
class StandardPreprocessor(ISTPreprocessor):
    """A dataset already in the standardized on-disk schema."""

    @staticmethod
    def _validate_directory(data_dir: Path):
        std_t, std_b = StandardTranscriptFields(), StandardBoundaryFields()
        for fn in (std_t.filename, std_b.filename):
            if not (data_dir / fn).exists():
                raise IOError(f"Missing {fn} in {data_dir}")
        # must actually be standard schema (else Xenium dirs would match)
        import pyarrow.parquet as pq

        cols = set(pq.read_schema(data_dir / std_t.filename).names)
        needed = {std_t.row_index, std_t.x, std_t.y, std_t.feature,
                  std_t.compartment}
        if not needed <= cols:
            raise IOError(
                f"transcripts.parquet lacks standard columns: "
                f"{needed - cols}"
            )

    @cached_property
    def transcripts(self) -> pd.DataFrame:
        std = StandardTranscriptFields()
        df = pd.read_parquet(self.data_dir / std.filename)
        return df

    @cached_property
    def boundaries(self) -> Tuple[pd.DataFrame, Dict]:
        std = StandardBoundaryFields()
        flat = pd.read_parquet(self.data_dir / std.filename)
        rows, polys = [], {}
        grouped = flat.groupby([std.id, std.boundary_type], sort=False)
        for (cid, btype), g in grouped:
            rows.append(
                (cid, btype, bool(g[std.contains_nucleus].iloc[0]))
            )
            polys[(cid, btype)] = g[["vertex_x", "vertex_y"]].to_numpy(
                np.float64
            )
        bd = pd.DataFrame(
            rows,
            columns=[std.id, std.boundary_type, std.contains_nucleus],
        )
        return bd, polys


# ----------------------------------------------------------------------
@register_preprocessor("10x_xenium")
class XeniumPreprocessor(ISTPreprocessor):
    """10x Xenium, analysis software >= 2.0
    (reference: preprocessor.py:346-519).

    ``nucleus_strategy`` closes the cell∩nucleus question
    (reference: preprocessor.py:487-501): the reference COMPUTES the
    intersection but the block replacing nucleus geometry is commented
    out, so its live behavior keeps the vendor nucleus rings —
    ``'vendor'`` (default) matches that.  ``'intersect'`` applies what
    the disabled block intended: each nucleus ring is clipped to its
    cell ring (largest intersection component; nuclei disjoint from
    their cell — the 10x non-overlap bug — are dropped).  Nucleus
    geometry feeds only the nucleus-mode prediction graph and
    morphology features; supervision edges come from the vendor
    compartment/cell-id columns and are IDENTICAL under both strategies
    (pinned by tests/test_nucleus_strategy.py).
    """

    tx_fields = XeniumTranscriptFields()
    bd_fields = XeniumBoundaryFields()

    def __init__(self, data_dir, nucleus_strategy: str = "vendor"):
        super().__init__(data_dir)
        if nucleus_strategy not in ("vendor", "intersect"):
            raise ValueError(
                f"Unrecognized nucleus_strategy: '{nucleus_strategy}'."
            )
        self.nucleus_strategy = nucleus_strategy

    @staticmethod
    def _sw_version_ok(version) -> bool:
        return version[0] > 1

    @staticmethod
    def _get_analysis_sw_version(data_dir: Path):
        with open(data_dir / "experiment.xenium") as f:
            meta = json.load(f)
        version = meta["analysis_sw_version"].split("-")[-1].split(".")
        return [int(re.sub(r"\D", "", v) or 0) for v in version]

    @classmethod
    def _validate_directory(cls, data_dir: Path):
        if not (data_dir / "experiment.xenium").exists():
            raise IOError(f"No experiment.xenium in {data_dir}")
        version = cls._get_analysis_sw_version(data_dir)
        if not cls._sw_version_ok(version):
            raise IOError(
                f"Xenium software version mismatch for {cls.__name__}: "
                f"{version}"
            )
        for pat in (
            cls.tx_fields.filename,
            cls.bd_fields.cell_filename,
            cls.bd_fields.nucleus_filename,
        ):
            if len(list(data_dir.glob(pat))) != 1:
                raise IOError(
                    f"Xenium directory must contain exactly one {pat}"
                )

    def _standardize_batch(
        self, df: pd.DataFrame, row_offset: int
    ) -> pd.DataFrame:
        """Standardize one raw-transcript batch (QV + control filters,
        compartment mapping; preprocessor.py:421-437).  ``row_offset``
        is the absolute row index of the batch's first row, so
        row_index stays stable under streaming."""
        raw, std = self.tx_fields, StandardTranscriptFields()
        df = df.copy()
        df.insert(
            0, std.row_index,
            np.arange(row_offset, row_offset + len(df), dtype=np.int64),
        )
        # binary columns -> str (post-2.0 Xenium parquet stores
        # feature_name/cell_id as BINARY); normalize to object dtype so
        # the eager and streaming paths emit identical frames
        # (str.decode returns StringDtype on some pandas versions)
        for col in (raw.feature, raw.cell_id):
            if df[col].dtype == object and len(df) and isinstance(
                df[col].iloc[0], bytes
            ):
                df[col] = df[col].str.decode("utf-8").astype(object)
            else:
                df[col] = df[col].astype(str).astype(object)
        df = df[df[raw.quality] >= 20]
        pattern = "|".join(
            s.replace("*", ".*") for s in raw.filter_substrings
        )
        df = df[~df[raw.feature].str.contains(pattern, regex=True)]
        is_nuc = df[raw.compartment] == raw.nucleus_value
        has_cell = df[raw.cell_id] != raw.null_cell_id
        compartment = np.where(
            is_nuc,
            std.nucleus_value,
            np.where(has_cell, std.cytoplasmic_value,
                     std.extracellular_value),
        ).astype(np.int8)
        cell_id = df[raw.cell_id].where(has_cell, None)
        out = pd.DataFrame(
            {
                std.row_index: df[std.row_index].to_numpy(),
                std.x: df[raw.x].to_numpy(np.float64),
                std.y: df[raw.y].to_numpy(np.float64),
                std.feature: df[raw.feature].to_numpy(),
                std.cell_id: cell_id.to_numpy(),
                std.compartment: compartment,
            }
        ).reset_index(drop=True)
        # pin string columns to object dtype: pandas infers StringDtype
        # for non-empty str frames but object for empty ones, so
        # streamed batches would otherwise concat to a different dtype
        # than the eager path (tests/test_vendor_fixtures.py)
        out[std.feature] = out[std.feature].astype(object)
        out[std.cell_id] = out[std.cell_id].astype(object)
        return out

    def iter_transcripts(self, batch_rows: int = 4_000_000):
        """Stream standardized transcript batches without materializing
        the whole table — the path for whole-slide inputs (the
        reference's polars lazy scan analogue, preprocessor.py:408-413;
        its KDTree note cites 600M-transcript slides)."""
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(self.data_dir / self.tx_fields.filename)
        offset = 0
        for batch in pf.iter_batches(batch_size=batch_rows):
            df = batch.to_pandas()
            yield self._standardize_batch(df, offset)
            offset += len(df)

    @cached_property
    def transcripts(self) -> pd.DataFrame:
        raw = self.tx_fields
        df = pd.read_parquet(self.data_dir / raw.filename)
        return self._standardize_batch(df, 0)

    def _read_boundary_file(self, path: Path):
        raw = self.bd_fields
        bd = pd.read_parquet(path)
        ids = bd[raw.id]
        if ids.dtype == object and len(ids) and isinstance(
            ids.iloc[0], bytes
        ):
            ids = ids.str.decode("utf-8")
        return contours_to_polygons(
            bd[raw.x].to_numpy(), bd[raw.y].to_numpy(),
            ids.astype(str).to_numpy(),
        )

    @cached_property
    def boundaries(self) -> Tuple[pd.DataFrame, Dict]:
        raw = self.bd_fields
        cell_ids, cell_polys = self._read_boundary_file(
            self.data_dir / raw.cell_filename
        )
        nuc_ids, nuc_polys = self._read_boundary_file(
            self.data_dir / raw.nucleus_filename
        )
        # 'vendor' keeps the nucleus rings as shipped — the reference's
        # LIVE behavior (its intersection-replacement block is commented
        # out, preprocessor.py:493-501); 'intersect' applies that
        # block's intent (see class docstring)
        if self.nucleus_strategy == "intersect":
            nuc_ids, nuc_polys = _intersect_nuclei(
                cell_ids, cell_polys, nuc_ids, nuc_polys
            )
        return _build_boundary_frame(
            cell_ids, cell_polys, nuc_ids, nuc_polys
        )


@register_preprocessor("10x_xenium_v1")
class XeniumPreprocessorV1(XeniumPreprocessor):
    """Xenium software 1.x: numeric null-cell sentinel
    (reference: preprocessor.py:521-529)."""

    tx_fields = XeniumTranscriptFieldsV1()
    bd_fields = XeniumBoundaryFields()

    @staticmethod
    def _sw_version_ok(version) -> bool:
        return version[0] == 1


# ----------------------------------------------------------------------
@register_preprocessor("nanostring_cosmx")
class CosMXPreprocessor(ISTPreprocessor):
    """NanoString CosMX (reference: preprocessor.py:228-343)."""

    @staticmethod
    def _validate_directory(data_dir: Path):
        bd, tx = CosMxBoundaryFields(), CosMxTranscriptFields()
        for pat in (
            tx.filename,
            bd.compartment_labels_dirname,
            bd.cell_labels_dirname,
            bd.fov_positions_filename,
        ):
            n = len(list(data_dir.glob(pat))) + len(
                list(data_dir.glob(f"**/{pat}"))
            )
            if n < 1:
                raise IOError(
                    f"CosMX directory must contain {pat} (found {n})"
                )

    def _standardize_batch(
        self, df: pd.DataFrame, row_offset: int
    ) -> pd.DataFrame:
        """Standardize one raw CosMX CSV batch; ``row_offset`` keeps
        row_index equal to the absolute CSV row position under
        streaming."""
        raw, std = CosMxTranscriptFields(), StandardTranscriptFields()
        df = df.copy()
        df.insert(
            0, std.row_index,
            np.arange(row_offset, row_offset + len(df), dtype=np.int64),
        )
        pattern = "|".join(
            s.replace("*", ".*") for s in raw.filter_substrings
        )
        df = df[~df[raw.feature].astype(str).str.contains(pattern,
                                                          regex=True)]
        remap = {
            raw.nucleus_value: std.nucleus_value,
            raw.membrane_value: std.cytoplasmic_value,
            raw.cytoplasmic_value: std.cytoplasmic_value,
            raw.extracellular_value: std.extracellular_value,
        }
        compartment = (
            df[raw.compartment]
            .map(remap)
            .fillna(std.extracellular_value)
            .astype(np.int8)
        )
        # composite cell id c_{fov}_{cell}, null outside cells
        fov_col = "fov" if "fov" in df.columns else "FOV"
        # per-chunk pandas dtype inference can make the cell column
        # float ("57.0"); coerce through int so composite ids are
        # stable across chunks and join the f"c_{fov}_{lid}" boundary
        # ids (which are always integer-formatted)
        cell_num = pd.to_numeric(df[raw.cell_id], errors="coerce")
        numeric = (
            (df[raw.cell_id].notna() == cell_num.notna()).all()
            and (cell_num.dropna() % 1 == 0).all()
        )
        cell_raw = (
            cell_num.fillna(0).astype(np.int64).astype(str)
            if numeric
            else df[raw.cell_id].astype(str)
        )
        cid = (
            "c_" + df[fov_col].astype(int).astype(str) + "_" + cell_raw
        )
        cell_id = cid.where(
            compartment.to_numpy() != std.extracellular_value, None
        )
        return pd.DataFrame(
            {
                std.row_index: df[std.row_index].to_numpy(),
                std.x: df[raw.x].to_numpy(np.float64),
                std.y: df[raw.y].to_numpy(np.float64),
                std.feature: df[raw.feature].astype(str).to_numpy(),
                std.cell_id: cell_id.to_numpy(),
                std.compartment: compartment.to_numpy(),
            }
        ).reset_index(drop=True)

    def iter_transcripts(self, batch_rows: int = 4_000_000):
        """Stream standardized transcript batches from the CSV without
        materializing the whole table (chunked analogue of the Xenium
        lazy scan; reference loads CosMX CSVs eagerly,
        preprocessor.py:252-299)."""
        raw = CosMxTranscriptFields()
        path = next(self.data_dir.glob(raw.filename))
        offset = 0
        for chunk in pd.read_csv(path, chunksize=batch_rows):
            yield self._standardize_batch(chunk, offset)
            offset += len(chunk)

    @cached_property
    def transcripts(self) -> pd.DataFrame:
        raw = CosMxTranscriptFields()
        path = next(self.data_dir.glob(raw.filename))
        return self._standardize_batch(pd.read_csv(path), 0)

    @cached_property
    def boundaries(self) -> Tuple[pd.DataFrame, Dict]:
        from .cosmx import get_cosmx_polygons

        cell_ids, cell_polys = get_cosmx_polygons(self.data_dir, "cell")
        nuc_ids, nuc_polys = get_cosmx_polygons(self.data_dir, "nucleus")
        return _build_boundary_frame(
            cell_ids, cell_polys, nuc_ids, nuc_polys
        )


# ----------------------------------------------------------------------
@register_preprocessor("vizgen_merscope")
class MerscopePreprocessor(ISTPreprocessor):
    """Vizgen MERSCOPE.

    The reference registers this platform but leaves it unimplemented
    (preprocessor.py:532-539); implemented here per the field schemas
    (fields.py:56-68): CSV transcripts + WKB boundary parquet.
    Compartments are derived from nucleus-polygon containment (MERSCOPE
    transcripts carry no compartment column)."""

    @staticmethod
    def _validate_directory(data_dir: Path):
        tx, bd = MerscopeTranscriptFields(), MerscopeBoundaryFields()
        if not (data_dir / tx.filename).exists():
            raise IOError(f"No {tx.filename} in {data_dir}")
        if not (data_dir / bd.cell_filename).exists():
            raise IOError(f"No {bd.cell_filename} in {data_dir}")

    def _nucleus_items(self):
        """(cell_id, polygon) pairs for nucleus boundaries, cached for
        per-batch compartment assignment."""
        if not hasattr(self, "_nuc_items_cache"):
            _, polys = self.boundaries
            std_b = StandardBoundaryFields()
            self._nuc_items_cache = [
                (cid, p)
                for (cid, btype), p in polys.items()
                if btype == std_b.nucleus_value
            ]
        return self._nuc_items_cache

    def _standardize_batch(
        self, df: pd.DataFrame, row_offset: int
    ) -> pd.DataFrame:
        raw, std = MerscopeTranscriptFields(), StandardTranscriptFields()
        df = df.copy()
        df.insert(
            0, std.row_index,
            np.arange(row_offset, row_offset + len(df), dtype=np.int64),
        )
        # drop Blank-* control probes (vizgen convention)
        df = df[~df[raw.feature].astype(str).str.startswith("Blank")]
        # chunked CSV parsing may infer the cell column as float64
        # (e.g. one empty value in the chunk): normalize through a
        # nullable integer so -1 never renders as "-1.0" and ids match
        # the boundary EntityID strings across chunks
        cell_raw = df[raw.cell_id]
        as_num = pd.to_numeric(cell_raw, errors="coerce")
        numeric = (
            (cell_raw.notna() == as_num.notna()).all()
            and (as_num.dropna() % 1 == 0).all()
        )
        if numeric:
            cell_norm = as_num.astype("Int64").astype(str)
        else:
            cell_norm = cell_raw.astype(str)
        has_cell = cell_raw.notna() & (cell_norm != "-1")
        cell_id = cell_norm.where(has_cell, None)
        pos = df[[raw.x, raw.y]].to_numpy(np.float64)

        compartment = np.where(
            has_cell.to_numpy(),
            std.cytoplasmic_value,
            std.extracellular_value,
        ).astype(np.int8)
        # nuclear compartment via containment in nucleus polygons
        # (MERSCOPE transcripts carry no compartment column)
        nuc_items = self._nucleus_items()
        if nuc_items:
            from ..geometry.query import points_in_polygons

            p_idx, g_idx = points_in_polygons(
                pos, [p for _, p in nuc_items]
            )
            nuc_ids = np.array([c for c, _ in nuc_items])
            cell_arr = cell_id.to_numpy()
            own = cell_arr[p_idx] == nuc_ids[g_idx]
            compartment[p_idx[own]] = std.nucleus_value

        return pd.DataFrame(
            {
                std.row_index: df[std.row_index].to_numpy(),
                std.x: pos[:, 0],
                std.y: pos[:, 1],
                std.feature: df[raw.feature].astype(str).to_numpy(),
                std.cell_id: cell_id.to_numpy(),
                std.compartment: compartment,
            }
        ).reset_index(drop=True)

    def iter_transcripts(self, batch_rows: int = 4_000_000):
        """Stream standardized transcript batches from the CSV (chunked;
        whole-slide MERSCOPE tables never materialize in RAM)."""
        raw = MerscopeTranscriptFields()
        offset = 0
        for chunk in pd.read_csv(
            self.data_dir / raw.filename, chunksize=batch_rows
        ):
            yield self._standardize_batch(chunk, offset)
            offset += len(chunk)

    @cached_property
    def transcripts(self) -> pd.DataFrame:
        raw = MerscopeTranscriptFields()
        df = pd.read_csv(self.data_dir / raw.filename)
        return self._standardize_batch(df, 0)

    def _read_wkb_parquet(self, path: Path):
        from .wkb import wkb_to_polygon

        raw = MerscopeBoundaryFields()
        df = pd.read_parquet(path)
        geom_col = next(
            (c for c in ("Geometry", "geometry") if c in df.columns), None
        )
        if geom_col is None:
            raise IOError(f"No geometry column in {path}")
        ids, polys = [], []
        for cid, blob in zip(df[raw.id], df[geom_col]):
            poly = wkb_to_polygon(blob)
            if poly is not None and len(poly) >= 3:
                ids.append(str(cid))
                polys.append(poly)
        return ids, polys

    @cached_property
    def boundaries(self) -> Tuple[pd.DataFrame, Dict]:
        raw = MerscopeBoundaryFields()
        cell_ids, cell_polys = self._read_wkb_parquet(
            self.data_dir / raw.cell_filename
        )
        nuc_path = self.data_dir / raw.nucleus_filename
        if nuc_path.exists():
            nuc_ids, nuc_polys = self._read_wkb_parquet(nuc_path)
        else:
            nuc_ids, nuc_polys = [], []
        return _build_boundary_frame(
            cell_ids, cell_polys, nuc_ids, nuc_polys
        )


# ----------------------------------------------------------------------
def _infer_platform(data_dir: Path) -> str:
    """Try every registered validator; require exactly one match
    (reference: preprocessor.py:542-562)."""
    matches, errors = [], []
    for platform, cls in PREPROCESSORS.items():
        try:
            cls._validate_directory(data_dir)
            matches.append(platform)
        except Exception as e:
            errors.append(e)
    if len(matches) == 0:
        raise ValueError(
            f"Could not infer platform from data directory: "
            f"{', '.join(map(str, errors))}"
        )
    if len(matches) > 1:
        raise ValueError(
            f"Ambiguous data directory: multiple platforms match: "
            f"{', '.join(matches)}"
        )
    return matches[0]


def get_preprocessor(
    data_dir, platform: Optional[str] = None, **kwargs
) -> ISTPreprocessor:
    """Resolve the platform preprocessor (auto-inferred unless named,
    reference: preprocessor.py:542-578).  Extra ``kwargs`` pass through
    to the preprocessor constructor (e.g. the Xenium readers'
    ``nucleus_strategy``)."""
    data_dir = Path(data_dir)
    if platform is None:
        platform = _infer_platform(data_dir)
    platform = platform.lower()
    if platform not in PREPROCESSORS:
        raise ValueError(
            f"Unknown platform: '{platform}'. "
            f"Available: {list(PREPROCESSORS)}"
        )
    return PREPROCESSORS[platform](data_dir, **kwargs)
