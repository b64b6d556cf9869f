"""Synthetic IST data generator (ground-truth-bearing).

Generates a Xenium-like standardized dataset: cells of several "types"
with distinct gene-expression programs, circular-ish nucleus/cell
boundaries, transcripts scattered around cell centers, plus background
noise transcripts, in the standard schema
(reference schema: src/segger/io/fields.py:104-124).  The same stream as
``segger_tpu.data.synthetic.make_synthetic``: one seed gives one slide in
both packages (the port's also returns each cell's expression program,
``cell_type``).  ``write_xenium_like``, ``write_merscope_like`` and
``write_synthetic_dataset`` write a slide as a raw Xenium v2 or MERSCOPE
directory or as a standardized one, byte for byte as the JAX package's
writers do.  ``make_synthetic_columnar`` streams the same generative
model into a columnar table (disk-spooled with ``spool``) for
whole-slide sizes, and ``write_merscope_like_columnar`` writes it as a
raw MERSCOPE directory chunk by chunk; both give the JAX package's
arrays and files at one seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd

from ..io.fields import StandardTranscriptFields, StandardBoundaryFields


@dataclass
class SyntheticData:
    transcripts: pd.DataFrame      # standard transcript schema + truth_cell
    boundaries: pd.DataFrame       # cell_id, boundary_type, contains_nucleus
    polygons: dict                 # (cell_id, boundary_type) -> (V,2) array
    truth_cell: np.ndarray         # ground-truth cell id per transcript
                                   # ('' for background)
    cell_type: Optional[np.ndarray] = None  # expression program of each
                                            # cell, in cell-id order


def _circle(center, radius, n=24, rng=None, wobble=0.15):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = radius * (
        1 + (rng.uniform(-wobble, wobble, n) if rng is not None else 0)
    )
    return np.stack(
        [center[0] + r * np.cos(th), center[1] + r * np.sin(th)], axis=1
    )


def make_synthetic(
    n_cells: int = 200,
    n_genes: int = 60,
    n_cell_types: int = 5,
    mean_tx_per_cell: int = 25,
    background_rate: float = 0.05,
    extent: float = 400.0,
    cell_radius: float = 8.0,
    nucleus_ratio: float = 0.55,
    seed: int = 0,
) -> SyntheticData:
    """Ground-truth synthetic IST slide.

    NOTE: ``extent`` does not scale with ``n_cells`` — for
    constant-density slides (realistic overlap, the regime every scale
    example uses) pass ``extent=400*sqrt(n_cells/200)``.  Leaving the
    default at large ``n_cells`` packs fixed-radius cells ever denser
    and the buffered-containment candidate graph degenerates to
    ~all-pairs."""
    rng = np.random.default_rng(seed)
    tx_f = StandardTranscriptFields()
    bd_f = StandardBoundaryFields()

    # cell type expression programs: sparse gene loadings
    programs = rng.gamma(0.3, 1.0, size=(n_cell_types, n_genes))
    programs /= programs.sum(axis=1, keepdims=True)

    # poisson-disc-ish cell centers: jittered grid to avoid heavy overlap
    grid = int(np.ceil(np.sqrt(n_cells)))
    pitch = extent / grid
    centers = []
    for i in range(grid):
        for j in range(grid):
            if len(centers) >= n_cells:
                break
            c = np.array([(i + 0.5) * pitch, (j + 0.5) * pitch])
            centers.append(c + rng.normal(0, pitch * 0.15, 2))
    centers = np.array(centers[:n_cells])
    types = rng.integers(0, n_cell_types, n_cells)
    radii = cell_radius * rng.uniform(0.7, 1.3, n_cells)

    gene_names = np.array([f"GENE_{g:03d}" for g in range(n_genes)])
    cell_ids = np.array([f"cell_{c:05d}" for c in range(n_cells)])

    # fully vectorized transcript generation (a per-transcript Python
    # loop is prohibitive at the 10M-transcript whole-slide scale)
    counts = rng.poisson(mean_tx_per_cell, n_cells)
    cell_of = np.repeat(np.arange(n_cells), counts)
    n_total = cell_of.size
    sigma = (radii * 0.55)[cell_of]
    pos = centers[cell_of] + rng.normal(0, 1, (n_total, 2)) * sigma[:, None]
    genes = np.empty(n_total, np.int64)
    for t in range(n_cell_types):  # per-type gene-program sampling
        sel = types[cell_of] == t
        genes[sel] = rng.choice(n_genes, int(sel.sum()), p=programs[t])
    d = np.sqrt(((pos - centers[cell_of]) ** 2).sum(axis=1))
    r_cell = radii[cell_of]
    compartment = np.where(
        d <= r_cell * nucleus_ratio,
        tx_f.nucleus_value,
        np.where(d <= r_cell, tx_f.cytoplasmic_value,
                 tx_f.extracellular_value),
    )
    # vendor assignment: inside the cell -> this cell, else unassigned
    vendor = np.where(d <= r_cell, cell_ids[cell_of], "")
    truth_arr = cell_ids[cell_of]

    # background noise transcripts
    n_bg = int(n_total * background_rate)
    bg_pos = rng.uniform(0, extent, (n_bg, 2))
    bg_genes = rng.integers(0, n_genes, n_bg)

    tx = pd.DataFrame(
        {
            tx_f.x: np.concatenate([pos[:, 0], bg_pos[:, 0]]),
            tx_f.y: np.concatenate([pos[:, 1], bg_pos[:, 1]]),
            tx_f.feature: gene_names[np.concatenate([genes, bg_genes])],
            tx_f.cell_id: np.concatenate(
                [vendor, np.full(n_bg, "", dtype=vendor.dtype)]
            ),
            tx_f.compartment: np.concatenate(
                [compartment,
                 np.full(n_bg, tx_f.extracellular_value,
                         dtype=compartment.dtype)]
            ),
        }
    )
    truth = np.concatenate(
        [truth_arr, np.full(n_bg, "", dtype=truth_arr.dtype)]
    ).tolist()
    # shuffle to avoid cell-sorted order
    perm = rng.permutation(len(tx))
    tx = tx.iloc[perm].reset_index(drop=True)
    truth = np.asarray(truth)[perm]
    tx.insert(0, tx_f.row_index, np.arange(len(tx), dtype=np.int64))
    tx[tx_f.cell_id] = tx[tx_f.cell_id].replace("", None)

    # boundaries: cell + nucleus polygons
    brows, polys = [], {}
    for c in range(n_cells):
        poly_c = _circle(centers[c], radii[c], rng=rng)
        poly_n = _circle(centers[c], radii[c] * nucleus_ratio, rng=rng)
        brows.append((cell_ids[c], bd_f.cell_value, True))
        brows.append((cell_ids[c], bd_f.nucleus_value, True))
        polys[(cell_ids[c], bd_f.cell_value)] = poly_c
        polys[(cell_ids[c], bd_f.nucleus_value)] = poly_n
    bd = pd.DataFrame(
        brows, columns=[bd_f.id, bd_f.boundary_type, bd_f.contains_nucleus]
    )
    return SyntheticData(
        transcripts=tx, boundaries=bd, polygons=polys, truth_cell=truth,
        cell_type=types,
    )


def write_xenium_like(directory, data: "SyntheticData") -> Path:
    """Write SyntheticData as a raw 10x Xenium v2-style directory
    (experiment.xenium + raw-schema parquet files) for IO tests/demos."""
    import json

    from ..io.fields import XeniumTranscriptFields, XeniumBoundaryFields

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    raw_t, raw_b = XeniumTranscriptFields(), XeniumBoundaryFields()
    tx_f, bd_f = StandardTranscriptFields(), StandardBoundaryFields()

    with open(directory / "experiment.xenium", "w") as f:
        json.dump({"analysis_sw_version": "xenium-3.0.0"}, f)

    tx = data.transcripts
    pd.DataFrame(
        {
            raw_t.x: tx[tx_f.x],
            raw_t.y: tx[tx_f.y],
            raw_t.feature: tx[tx_f.feature],
            raw_t.cell_id: tx[tx_f.cell_id].fillna(raw_t.null_cell_id),
            raw_t.compartment: (
                tx[tx_f.compartment] == tx_f.nucleus_value
            ).astype(int),
            raw_t.quality: 40.0,
        }
    ).to_parquet(directory / raw_t.filename, index=False)

    for fname, btype in (
        (raw_b.cell_filename, bd_f.cell_value),
        (raw_b.nucleus_filename, bd_f.nucleus_value),
    ):
        rows = []
        for (cid, bt), poly in data.polygons.items():
            if bt != btype:
                continue
            for v in poly:
                rows.append((cid, v[0], v[1]))
        pd.DataFrame(
            rows, columns=[raw_b.id, raw_b.x, raw_b.y]
        ).to_parquet(directory / fname, index=False)
    return directory


def _polygon_to_wkb(poly: np.ndarray) -> bytes:
    """Encode an exterior ring as little-endian WKB Polygon."""
    import struct

    poly = np.asarray(poly, dtype=np.float64)
    ring = np.vstack([poly, poly[:1]])  # close the ring
    out = b"\x01" + struct.pack("<I", 3) + struct.pack("<I", 1)
    out += struct.pack("<I", len(ring))
    out += ring.astype("<f8").tobytes()
    return out


def write_merscope_like(directory, data: "SyntheticData") -> Path:
    """Write SyntheticData as a raw Vizgen MERSCOPE-style directory
    (detected_transcripts.csv + WKB boundary parquet)."""
    from ..io.fields import (
        MerscopeTranscriptFields,
        MerscopeBoundaryFields,
    )

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    raw_t, raw_b = MerscopeTranscriptFields(), MerscopeBoundaryFields()
    tx_f, bd_f = StandardTranscriptFields(), StandardBoundaryFields()

    tx = data.transcripts
    pd.DataFrame(
        {
            raw_t.x: tx[tx_f.x],
            raw_t.y: tx[tx_f.y],
            raw_t.feature: tx[tx_f.feature],
            raw_t.cell_id: tx[tx_f.cell_id].fillna("-1"),
        }
    ).to_csv(directory / raw_t.filename, index=False)

    for fname, btype in (
        (raw_b.cell_filename, bd_f.cell_value),
        (raw_b.nucleus_filename, bd_f.nucleus_value),
    ):
        ids, blobs = [], []
        for (cid, bt), poly in data.polygons.items():
            if bt != btype:
                continue
            ids.append(cid)
            blobs.append(_polygon_to_wkb(poly))
        pd.DataFrame({raw_b.id: ids, "Geometry": blobs}).to_parquet(
            directory / fname, index=False
        )
    return directory


def write_merscope_like_columnar(
    directory, data: "SyntheticColumnar", chunk_rows: int = 4_000_000
) -> Path:
    """Raw Vizgen MERSCOPE-style directory from a columnar synthetic
    slide, streamed in chunks (no whole-slide DataFrame): the
    whole-slide analogue of :func:`write_merscope_like`."""
    from ..io.fields import (
        MerscopeTranscriptFields,
        MerscopeBoundaryFields,
    )

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    raw_t, raw_b = MerscopeTranscriptFields(), MerscopeBoundaryFields()
    bd_f = StandardBoundaryFields()

    cols = data.transcripts
    gene_names = np.asarray(cols.gene_names).astype(str)
    cell_ids = np.asarray(cols.cell_ids).astype(str)
    path = directory / raw_t.filename
    n = cols.n
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        cc = np.asarray(cols.cell_code[s:e])
        chunk = pd.DataFrame(
            {
                raw_t.x: np.asarray(cols.x[s:e]),
                raw_t.y: np.asarray(cols.y[s:e]),
                raw_t.feature: gene_names[np.asarray(cols.gene_code[s:e])],
                raw_t.cell_id: np.where(
                    cc >= 0, cell_ids[np.maximum(cc, 0)], "-1"
                ),
            }
        )
        chunk.to_csv(path, index=False, mode="w" if s == 0 else "a",
                     header=(s == 0))

    for fname, btype in (
        (raw_b.cell_filename, bd_f.cell_value),
        (raw_b.nucleus_filename, bd_f.nucleus_value),
    ):
        ids, blobs = [], []
        for (cid, bt), poly in data.polygons.items():
            if bt != btype:
                continue
            ids.append(cid)
            blobs.append(_polygon_to_wkb(poly))
        pd.DataFrame({raw_b.id: ids, "Geometry": blobs}).to_parquet(
            directory / fname, index=False
        )
    return directory


def write_synthetic_dataset(
    directory, seed: int = 0, **kwargs
) -> "SyntheticData":
    """Write a standardized dataset directory (transcripts.parquet +
    boundaries.parquet with flattened polygon vertices) for IO/CLI tests."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    data = make_synthetic(seed=seed, **kwargs)
    tx_f = StandardTranscriptFields()
    bd_f = StandardBoundaryFields()

    data.transcripts.assign(truth_cell=data.truth_cell).to_parquet(
        directory / tx_f.filename
    )
    # boundaries: one row per vertex (ragged polygons flattened)
    rows = []
    for (cid, btype), poly in data.polygons.items():
        contains = True
        for v in poly:
            rows.append((cid, btype, contains, v[0], v[1]))
    pd.DataFrame(
        rows,
        columns=[bd_f.id, bd_f.boundary_type, bd_f.contains_nucleus,
                 "vertex_x", "vertex_y"],
    ).to_parquet(directory / bd_f.filename)
    return data


@dataclass
class SyntheticColumnar:
    """Out-of-core variant of :class:`SyntheticData`: transcripts as a
    :class:`segger_tpu_torch.data.columnar.ColumnarTranscripts` (optionally
    disk-spooled), truth as an int32 cell-code array (-1 background)."""

    transcripts: object            # ColumnarTranscripts
    boundaries: pd.DataFrame       # standard boundary table (small)
    polygons: dict                 # (cell_id, type) -> (V, 2) float32
    truth_code: np.ndarray         # (N,) int32 cell index, -1 background


def make_synthetic_columnar(
    n_cells: int = 200,
    n_genes: int = 60,
    n_cell_types: int = 5,
    mean_tx_per_cell: int = 25,
    background_rate: float = 0.05,
    extent: float = 400.0,
    cell_radius: float = 8.0,
    nucleus_ratio: float = 0.55,
    seed: int = 0,
    cells_per_chunk: int = 200_000,
    spool=None,
) -> SyntheticColumnar:
    """Streaming ground-truth synthetic slide at whole-slide scale.

    Same generative model as :func:`make_synthetic` (jittered-grid
    cells, per-type gene programs, gaussian transcript clouds, uniform
    background) but emits transcripts chunk-by-cell-chunk straight into
    typed columns: no whole-slide DataFrame, no object arrays.  With
    ``spool`` set, transcript columns land in disk memmaps and peak RSS
    is O(chunk) + O(n_cells).  The same seed gives the JAX package's
    ``make_synthetic_columnar`` arrays.
    """
    from .columnar import ColumnarTranscripts, _SPOOL_DTYPES, _SPOOL_COLS

    rng = np.random.default_rng(seed)
    tx_f = StandardTranscriptFields()
    bd_f = StandardBoundaryFields()

    programs = rng.gamma(0.3, 1.0, size=(n_cell_types, n_genes))
    programs /= programs.sum(axis=1, keepdims=True)

    grid = int(np.ceil(np.sqrt(n_cells)))
    pitch = extent / grid
    ii, jj = np.divmod(np.arange(n_cells), grid)
    centers = (np.stack([ii, jj], 1) + 0.5) * pitch \
        + rng.normal(0, pitch * 0.15, (n_cells, 2))
    types = rng.integers(0, n_cell_types, n_cells)
    radii = cell_radius * rng.uniform(0.7, 1.3, n_cells)

    gene_names = np.array([f"GENE_{g:03d}" for g in range(n_genes)])
    width = len(str(max(n_cells - 1, 1)))
    cell_ids = np.array(
        [f"cell_{c:0{width}d}" for c in range(n_cells)]
    )

    parts = {c: [] for c in _SPOOL_COLS}
    parts["truth"] = []
    writers = {}
    spool_dir = Path(spool) if spool is not None else None
    if spool_dir is not None:
        spool_dir.mkdir(parents=True, exist_ok=True)
        writers = {
            c: open(spool_dir / f"{c}.bin", "wb") for c in _SPOOL_COLS
        }
        writers["truth"] = open(spool_dir / "truth.bin", "wb")

    def emit(name, arr):
        dt = _SPOOL_DTYPES.get(name, np.int32)
        if spool_dir is None:
            parts[name].append(np.ascontiguousarray(arr, dt))
        else:
            writers[name].write(np.ascontiguousarray(arr, dt).tobytes())

    written = 0
    for c0 in range(0, n_cells, cells_per_chunk):
        c1 = min(c0 + cells_per_chunk, n_cells)
        counts = rng.poisson(mean_tx_per_cell, c1 - c0)
        cell_of = np.repeat(np.arange(c0, c1), counts)
        n_total = cell_of.size
        sigma = (radii[cell_of] * 0.55)
        pos = centers[cell_of] + rng.normal(0, 1, (n_total, 2)) \
            * sigma[:, None]
        genes = np.empty(n_total, np.int32)
        tloc = types[cell_of]
        for t in range(n_cell_types):
            sel = tloc == t
            genes[sel] = rng.choice(n_genes, int(sel.sum()),
                                    p=programs[t])
        d = np.sqrt(((pos - centers[cell_of]) ** 2).sum(axis=1))
        r_cell = radii[cell_of]
        compartment = np.where(
            d <= r_cell * nucleus_ratio,
            tx_f.nucleus_value,
            np.where(d <= r_cell, tx_f.cytoplasmic_value,
                     tx_f.extracellular_value),
        ).astype(np.int8)
        vendor = np.where(d <= r_cell, cell_of, -1).astype(np.int32)

        # proportional share of the background, mixed into this chunk
        n_bg = int(round(n_total * background_rate))
        bg_pos = rng.uniform(0, extent, (n_bg, 2))
        n_chunk = n_total + n_bg
        perm = rng.permutation(n_chunk)

        x = np.concatenate([pos[:, 0], bg_pos[:, 0]])[perm]
        y = np.concatenate([pos[:, 1], bg_pos[:, 1]])[perm]
        g = np.concatenate(
            [genes, rng.integers(0, n_genes, n_bg).astype(np.int32)]
        )[perm]
        cc = np.concatenate(
            [vendor, np.full(n_bg, -1, np.int32)]
        )[perm]
        comp = np.concatenate(
            [compartment,
             np.full(n_bg, tx_f.extracellular_value, np.int8)]
        )[perm]
        truth = np.concatenate(
            [cell_of.astype(np.int32), np.full(n_bg, -1, np.int32)]
        )[perm]

        emit("x", x)
        emit("y", y)
        emit("gene_code", g)
        emit("cell_code", cc)
        emit("compartment", comp)
        emit("row_index",
             np.arange(written, written + n_chunk, dtype=np.int64))
        emit("truth", truth)
        written += n_chunk

    # boundaries + polygons (O(n_cells); float32 vertices)
    brows, polys = [], {}
    for c in range(n_cells):
        poly_c = _circle(centers[c], radii[c], rng=rng).astype(np.float32)
        poly_n = _circle(
            centers[c], radii[c] * nucleus_ratio, rng=rng
        ).astype(np.float32)
        brows.append((cell_ids[c], bd_f.cell_value, True))
        brows.append((cell_ids[c], bd_f.nucleus_value, True))
        polys[(cell_ids[c], bd_f.cell_value)] = poly_c
        polys[(cell_ids[c], bd_f.nucleus_value)] = poly_n
    bd = pd.DataFrame(
        brows, columns=[bd_f.id, bd_f.boundary_type, bd_f.contains_nucleus]
    )

    if spool_dir is not None:
        for w in writers.values():
            w.close()
        np.save(spool_dir / "gene_names.npy", gene_names)
        np.save(spool_dir / "cell_ids.npy", cell_ids)
        cols = ColumnarTranscripts.open_spool(spool_dir)
        truth = np.memmap(spool_dir / "truth.bin", dtype=np.int32,
                          mode="r")
    else:
        cols = ColumnarTranscripts(
            x=np.concatenate(parts["x"]),
            y=np.concatenate(parts["y"]),
            gene_code=np.concatenate(parts["gene_code"]),
            cell_code=np.concatenate(parts["cell_code"]),
            compartment=np.concatenate(parts["compartment"]),
            row_index=np.concatenate(parts["row_index"]),
            gene_names=gene_names,
            cell_ids=cell_ids,
        )
        truth = np.concatenate(parts["truth"])
    return SyntheticColumnar(
        transcripts=cols, boundaries=bd, polygons=polys, truth_code=truth
    )
