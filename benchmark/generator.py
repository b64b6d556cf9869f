"""The benchmark's frozen synthetic slide generator.

A copy of ``segger_tpu_torch/data/synthetic.py::make_synthetic`` as it
stood when the benchmark was defined, kept here so that a change to the
program cannot change the benchmark's inputs.  One seed gives one slide:
cells of several expression programs on a jittered grid, transcripts
scattered around their centres, circular nucleus and cell boundaries,
and a share of background transcripts, in the standardized schema
(``row_index``, ``x``, ``y``, ``feature_name``, ``cell_id``,
``cell_compartment``; boundaries ``cell_id``, ``boundary_type``,
``contains_nucleus``; polygons keyed by ``(cell_id, boundary_type)``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import pandas as pd

# the standardized schema's values
EXTRACELLULAR, CYTOPLASMIC, NUCLEUS = 0, 1, 2
CELL, NUCLEUS_BOUNDARY = "cell", "nucleus"


@dataclass
class Slide:
    transcripts: pd.DataFrame
    boundaries: pd.DataFrame
    polygons: dict
    truth_cell: np.ndarray


def constant_density_extent(n_cells: int) -> float:
    """The slide's side in um at the generator's own density: 200 cells
    on 400 um x 400 um."""
    return 400.0 * math.sqrt(n_cells / 200.0)


def _circle(center, radius, n=24, rng=None, wobble=0.15):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = radius * (
        1 + (rng.uniform(-wobble, wobble, n) if rng is not None else 0)
    )
    return np.stack(
        [center[0] + r * np.cos(th), center[1] + r * np.sin(th)], axis=1
    )


def make_slide(
    n_cells: int,
    n_genes: int,
    mean_tx_per_cell: int,
    n_cell_types: int = 5,
    background_rate: float = 0.05,
    extent: float = 400.0,
    cell_radius: float = 8.0,
    nucleus_ratio: float = 0.55,
    seed: int = 0,
) -> Slide:
    """One synthetic slide from ``seed`` (any non-negative integer)."""
    rng = np.random.default_rng(seed)

    programs = rng.gamma(0.3, 1.0, size=(n_cell_types, n_genes))
    programs /= programs.sum(axis=1, keepdims=True)

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

    counts = rng.poisson(mean_tx_per_cell, n_cells)
    cell_of = np.repeat(np.arange(n_cells), counts)
    n_total = cell_of.size
    sigma = (radii * 0.55)[cell_of]
    pos = centers[cell_of] + rng.normal(0, 1, (n_total, 2)) * sigma[:, None]
    genes = np.empty(n_total, np.int64)
    for t in range(n_cell_types):
        sel = types[cell_of] == t
        genes[sel] = rng.choice(n_genes, int(sel.sum()), p=programs[t])
    d = np.sqrt(((pos - centers[cell_of]) ** 2).sum(axis=1))
    r_cell = radii[cell_of]
    compartment = np.where(
        d <= r_cell * nucleus_ratio, NUCLEUS,
        np.where(d <= r_cell, CYTOPLASMIC, EXTRACELLULAR))
    vendor = np.where(d <= r_cell, cell_ids[cell_of], "")
    truth_arr = cell_ids[cell_of]

    n_bg = int(n_total * background_rate)
    bg_pos = rng.uniform(0, extent, (n_bg, 2))
    bg_genes = rng.integers(0, n_genes, n_bg)

    tx = pd.DataFrame({
        "x": np.concatenate([pos[:, 0], bg_pos[:, 0]]),
        "y": np.concatenate([pos[:, 1], bg_pos[:, 1]]),
        "feature_name": gene_names[np.concatenate([genes, bg_genes])],
        "cell_id": np.concatenate(
            [vendor, np.full(n_bg, "", dtype=vendor.dtype)]),
        "cell_compartment": np.concatenate(
            [compartment,
             np.full(n_bg, EXTRACELLULAR, dtype=compartment.dtype)]),
    })
    truth = np.concatenate(
        [truth_arr, np.full(n_bg, "", dtype=truth_arr.dtype)]).tolist()
    perm = rng.permutation(len(tx))
    tx = tx.iloc[perm].reset_index(drop=True)
    truth = np.asarray(truth)[perm]
    tx.insert(0, "row_index", np.arange(len(tx), dtype=np.int64))
    tx["cell_id"] = tx["cell_id"].replace("", None)

    brows, polys = [], {}
    for c in range(n_cells):
        poly_c = _circle(centers[c], radii[c], rng=rng)
        poly_n = _circle(centers[c], radii[c] * nucleus_ratio, rng=rng)
        brows.append((cell_ids[c], CELL, True))
        brows.append((cell_ids[c], NUCLEUS_BOUNDARY, True))
        polys[(cell_ids[c], CELL)] = poly_c
        polys[(cell_ids[c], NUCLEUS_BOUNDARY)] = poly_n
    bd = pd.DataFrame(
        brows, columns=["cell_id", "boundary_type", "contains_nucleus"])
    return Slide(transcripts=tx, boundaries=bd, polygons=polys,
                 truth_cell=truth)
