"""Minimal WKB (well-known binary) polygon decoder.

MERSCOPE boundary parquet files carry geometries as WKB blobs; the
reference would read them through geopandas/GEOS.  This package decodes the
polygon subset (Polygon, MultiPolygon, little/big endian, optional Z)
directly into NumPy vertex arrays — the only geometry representation the
framework uses.  The port's copy of ``segger_tpu.io.wkb``.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

_POLYGON = 3
_MULTIPOLYGON = 6


def _read_ring(buf: memoryview, off: int, little: bool, dims: int):
    (n,) = struct.unpack_from("<I" if little else ">I", buf, off)
    off += 4
    pts = np.frombuffer(
        buf, dtype="<f8" if little else ">f8", count=n * dims, offset=off
    ).reshape(n, dims)
    return pts[:, :2].astype(np.float64), off + 8 * n * dims


def _read_polygon(buf: memoryview, off: int, little: bool, dims: int):
    (n_rings,) = struct.unpack_from("<I" if little else ">I", buf, off)
    off += 4
    exterior = None
    for r in range(n_rings):
        ring, off = _read_ring(buf, off, little, dims)
        if r == 0:
            exterior = ring
        # interior rings (holes) are dropped: containment tests operate
        # on the exterior shell, matching the reference's practical use
    return exterior, off


def _type_dims(gtype: int):
    """(base_type, dims) from an ISO or EWKB geometry type word.

    ISO WKB: type + 1000*Z + 2000*M (ZM = +3000).  EWKB (PostGIS):
    flag bits 0x80000000 (Z) and 0x40000000 (M).  dims = 2 + Z + M.
    """
    has_z = bool(gtype & 0x80000000)
    has_m = bool(gtype & 0x40000000)
    code = gtype & 0x0FFFFFFF
    base = code % 1000
    iso_flag = (code // 1000) % 10
    if iso_flag == 1:
        has_z = True
    elif iso_flag == 2:
        has_m = True
    elif iso_flag == 3:
        has_z = has_m = True
    return base, 2 + int(has_z) + int(has_m)


def wkb_to_polygon(blob: bytes) -> Optional[np.ndarray]:
    """Decode one WKB geometry to its (largest) exterior ring (V, 2).

    Returns None for empty/unsupported geometries.
    """
    buf = memoryview(blob)
    off = 0
    little = buf[off] == 1
    off += 1
    (gtype,) = struct.unpack_from("<I" if little else ">I", buf, off)
    off += 4
    base, dims = _type_dims(gtype)

    if base == _POLYGON:
        poly, _ = _read_polygon(buf, off, little, dims)
        return poly
    if base == _MULTIPOLYGON:
        (n_polys,) = struct.unpack_from("<I" if little else ">I", buf, off)
        off += 4
        best, best_area = None, -1.0
        for _ in range(n_polys):
            # each sub-polygon has its own endianness + type header
            sub_little = buf[off] == 1
            off += 1
            (sub_type,) = struct.unpack_from(
                "<I" if sub_little else ">I", buf, off
            )
            off += 4
            _, sub_dims = _type_dims(sub_type)
            poly, off = _read_polygon(buf, off, sub_little, sub_dims)
            if poly is not None and len(poly) >= 3:
                x, y = poly[:, 0], poly[:, 1]
                area = 0.5 * abs(
                    np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
                )
                if area > best_area:
                    best, best_area = poly, area
        return best
    return None
