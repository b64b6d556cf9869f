"""Synthetic IST data generator (ground-truth-bearing).

Generates a Xenium-like standardized dataset: cells of several "types"
with distinct gene-expression programs, circular-ish nucleus/cell
boundaries, transcripts scattered around cell centers, plus background
noise transcripts, in the standard schema
(reference schema: src/segger/io/fields.py:104-124).  The same stream as
``segger_tpu.data.synthetic.make_synthetic``: one seed gives one slide in
both packages.  ``write_xenium_like``, ``write_merscope_like`` and
``write_synthetic_dataset`` write a slide as a raw Xenium v2 or MERSCOPE
directory or as a standardized one, byte for byte as the JAX package's
writers do; the columnar writers wait for the columnar transcript table.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
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
        transcripts=tx, boundaries=bd, polygons=polys, truth_cell=truth
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
