"""Synthetic IST data generator (ground-truth-bearing).

Generates a Xenium-like standardized dataset: cells of several "types"
with distinct gene-expression programs, circular-ish nucleus/cell
boundaries, transcripts scattered around cell centers, plus background
noise transcripts, in the standard schema
(reference schema: src/segger/io/fields.py:104-124).  The same stream as
``segger_tpu.data.synthetic.make_synthetic``: one seed gives one slide in
both packages.  The vendor-directory writers wait for the I/O readers.
"""
from __future__ import annotations

from dataclasses import dataclass
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
