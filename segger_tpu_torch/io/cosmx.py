"""CosMX boundary reconstruction from label-mask TIFFs.

Re-implements the reference's mask->polygon pipeline
(reference: src/segger/io/cosmx.py:21-171) with OpenCV only (no
tifffile/skimage): per-FOV CellLabels/CompartmentLabels images ->
per-label contours -> polygon simplification (tolerance = mean cell
size / 50) -> affine FOV->global transform with y-flip.  The port's copy
of ``segger_tpu.io.cosmx``; ``cv2`` is imported inside the functions that
read the label images, so no other reader needs it.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

from .fields import CosMxBoundaryFields

logger = logging.getLogger(__name__)


def _read_label_tiff(path: Path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"Could not read label image: {path}")
    if img.ndim == 3:
        img = img[..., 0]
    return img


def masks_to_contours(
    labels: np.ndarray, simplify_tol: float
) -> Dict[int, np.ndarray]:
    """Largest outer contour per label id, Douglas-Peucker simplified
    (reference: io/cosmx.py:57-115 uses regionprops + cv2.findContours;
    here contours are extracted per label bbox directly with cv2)."""
    import cv2

    from scipy import ndimage

    out = {}
    # bounding boxes for ALL labels in one O(H*W) sweep — a per-label
    # np.where scan is O(n_labels * H * W), hours per whole slide at
    # ~5k cells x 30 Mpx per FOV
    slices = ndimage.find_objects(labels)
    for lid0, sl in enumerate(slices):
        if sl is None:
            continue
        lid = lid0 + 1
        y0, y1 = sl[0].start, sl[0].stop
        x0, x1 = sl[1].start, sl[1].stop
        crop = (labels[y0:y1, x0:x1] == lid).astype(np.uint8)
        contours, _ = cv2.findContours(
            crop, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        if not contours:
            continue
        cnt = max(contours, key=cv2.contourArea)
        if simplify_tol > 0:
            cnt = cv2.approxPolyDP(cnt, simplify_tol, closed=True)
        poly = cnt.reshape(-1, 2).astype(np.float64)
        if len(poly) < 3:
            continue
        poly[:, 0] += x0
        poly[:, 1] += y0
        out[int(lid)] = poly
    return out


def check_cosmx_directory(data_dir: Path) -> None:
    """Preflight: all FOVs named in the positions file have label TIFFs
    (reference: io/cosmx.py:118-171)."""
    bd = CosMxBoundaryFields()
    pos_file = next(Path(data_dir).glob(bd.fov_positions_filename))
    fovs = pd.read_csv(pos_file)
    fov_col = _fov_column(fovs)
    for dirname in (bd.cell_labels_dirname, bd.compartment_labels_dirname):
        label_dir = _find_dir(data_dir, dirname)
        have = {_fov_of(p) for p in label_dir.glob("*.tif*")}
        need = set(int(v) for v in fovs[fov_col])
        missing = need - have
        if missing:
            raise IOError(
                f"Missing {dirname} TIFFs for FOVs: {sorted(missing)[:10]}"
            )


def _find_dir(data_dir: Path, name: str) -> Path:
    matches = list(Path(data_dir).glob(f"**/{name}"))
    if not matches:
        raise IOError(f"No directory named {name} under {data_dir}")
    return matches[0]


def _fov_of(path: Path) -> int:
    import re

    m = re.search(r"F(\d+)", path.stem)
    if not m:
        raise IOError(f"Cannot parse FOV number from {path.name}")
    return int(m.group(1))


def _fov_column(fovs: pd.DataFrame) -> str:
    for c in ("FOV", "fov"):
        if c in fovs.columns:
            return c
    raise IOError(f"No FOV column in positions file: {fovs.columns}")


def get_cosmx_polygons(
    data_dir: Path, boundary_type: str = "cell"
) -> Tuple[List[str], List[np.ndarray]]:
    """All-FOV polygons in global micron coordinates.

    Composite ids are ``c_{fov}_{label}`` matching CosMX transcript 'cell'
    ids.  The FOV->global transform applies the y-flip into the
    vendor's global-PIXEL space, matching the transcript
    x_global_px/y_global_px columns (reference: io/cosmx.py:21-115,
    io/utils.py:8-41).
    """
    bd = CosMxBoundaryFields()
    data_dir = Path(data_dir)
    pos_file = next(data_dir.glob(bd.fov_positions_filename))
    fovs = pd.read_csv(pos_file)
    fov_col = _fov_column(fovs)

    cell_dir = _find_dir(data_dir, bd.cell_labels_dirname)
    comp_dir = (
        _find_dir(data_dir, bd.compartment_labels_dirname)
        if boundary_type == "nucleus"
        else None
    )

    # global offsets per fov (mm or px columns depending on version)
    def _xy_columns(df):
        # offsets are converted to GLOBAL PIXELS — the same space the
        # vendor's x_global_px/y_global_px transcript columns use
        # (reference: io/cosmx.py:99-102 divides mm offsets by mpp and
        # keeps polygon vertices in pixels; transcripts are never
        # rescaled, preprocessor.py:252-299)
        for xc, yc, scale in (
            ("X_mm", "Y_mm", 1000.0 / bd.mpp),
            ("x_global_px", "y_global_px", 1.0),
            ("X_px", "Y_px", 1.0),
        ):
            if xc in df.columns and yc in df.columns:
                return xc, yc, scale
        raise IOError(f"No usable position columns in {df.columns}")

    xc, yc, scale = _xy_columns(fovs)

    ids: List[str] = []
    polys: List[np.ndarray] = []
    def _fov_tiff(d: Path, fov: int):
        tiffs = sorted(d.glob(f"*F{fov:03d}*.tif*")) or sorted(
            d.glob(f"*F{fov}*.tif*")
        )
        return tiffs[0] if tiffs else None

    for _, row in fovs.iterrows():
        fov = int(row[fov_col])
        cell_tiff = _fov_tiff(cell_dir, fov)
        if cell_tiff is None:
            continue
        labels = _read_label_tiff(cell_tiff)
        if boundary_type == "nucleus":
            # nucleus polygons = per-cell labels restricted to the
            # nuclear compartment of the CompartmentLabels image
            comp_tiff = _fov_tiff(comp_dir, fov)
            if comp_tiff is None:
                continue
            comp = _read_label_tiff(comp_tiff)
            labels = np.where(comp == bd.nucleus_value, labels, 0)
        n_cells = max(len(np.unique(labels)) - 1, 1)
        mean_size = np.sqrt(labels.size / n_cells)
        contours = masks_to_contours(labels, simplify_tol=mean_size / 50)
        ox, oy = float(row[xc]) * scale, float(row[yc]) * scale
        for lid, poly in contours.items():
            # global px = (x_local + ox, oy - y_local): the reference's
            # AffineTransform(scale=[1, -1], translation=[tx, ty])
            # (io/cosmx.py:102) — image y points down, global y up
            g = poly.copy()
            g[:, 0] += ox
            g[:, 1] = oy - g[:, 1]
            ids.append(f"c_{fov}_{lid}")
            polys.append(g)
    return ids, polys
