"""The port's vendor I/O (``segger_tpu_torch.io``, ``geometry/boolean.py``
and the synthetic vendor writers) against the JAX package's: the frozen
Xenium v1/v2 and CosMX fixtures, and Xenium, MERSCOPE and standardized
directories written by both packages from one ``make_synthetic`` slide,
read into equal frames and polygons (exactly), under both nucleus
strategies, eagerly and in batches; platform inference, ``save()``, the
WKB decoder and polygon intersection alike."""
import os
import shutil
import struct
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from segger_tpu.data import synthetic as j_syn
from segger_tpu.geometry import boolean as j_bool
from segger_tpu.io import preprocessor as j_pre
from segger_tpu.io.wkb import wkb_to_polygon as j_wkb

from segger_tpu_torch.data import synthetic as t_syn
from segger_tpu_torch.geometry import boolean as t_bool
from segger_tpu_torch.io import preprocessor as t_pre
from segger_tpu_torch.io.wkb import wkb_to_polygon as t_wkb

VENDOR = Path(__file__).resolve().parent / "fixtures" / "vendor"
SLIDE = dict(seed=0)
# nuclei larger than their cells, so that 'intersect' clips every one
POKING = dict(n_cells=40, n_genes=15, mean_tx_per_cell=10,
              nucleus_ratio=1.1, seed=3)


def assert_same_read(tp, jp):
    """Equal transcripts, boundary frames and polygons, exactly."""
    pd.testing.assert_frame_equal(tp.transcripts, jp.transcripts)
    tbd, tpolys = tp.boundaries
    jbd, jpolys = jp.boundaries
    pd.testing.assert_frame_equal(tbd, jbd)
    assert list(tpolys) == list(jpolys) and jpolys
    for key, poly in jpolys.items():
        assert tpolys[key].dtype == poly.dtype
        np.testing.assert_array_equal(tpolys[key], poly, err_msg=str(key))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Xenium, MERSCOPE and standardized directories of one slide, each
    written by both packages' writers: {kind: (port dir, JAX dir)}."""
    root = tmp_path_factory.mktemp("port_io")
    t_slide = t_syn.make_synthetic(**SLIDE)
    j_slide = j_syn.make_synthetic(**SLIDE)
    t_poke = t_syn.make_synthetic(**POKING)
    j_poke = j_syn.make_synthetic(**POKING)
    out = {}
    for kind, writer, slides in (
            ("xenium", "write_xenium_like", (t_slide, j_slide)),
            ("xenium_poking", "write_xenium_like", (t_poke, j_poke)),
            ("merscope", "write_merscope_like", (t_slide, j_slide))):
        out[kind] = (
            getattr(t_syn, writer)(root / f"t_{kind}", slides[0]),
            getattr(j_syn, writer)(root / f"j_{kind}", slides[1]))
    for name, mod in (("t", t_syn), ("j", j_syn)):
        mod.write_synthetic_dataset(root / f"{name}_standard", **SLIDE)
    out["standard"] = (root / "t_standard", root / "j_standard")
    return out


FIXTURES = [("xenium_v1", {}), ("xenium_v1", {"nucleus_strategy":
                                            "intersect"}),
            ("xenium_v2", {}), ("xenium_v2", {"nucleus_strategy":
                                            "intersect"}),
            ("cosmx", {})]


@pytest.mark.parametrize("name,kw", FIXTURES,
                         ids=[f"{n}-{k.get('nucleus_strategy', 'vendor')}"
                              for n, k in FIXTURES])
def test_vendor_fixture_reads_like_jax(name, kw):
    if name == "cosmx":
        pytest.importorskip("cv2")
    tp = t_pre.get_preprocessor(VENDOR / name, **kw)
    jp = j_pre.get_preprocessor(VENDOR / name, **kw)
    assert type(tp).__name__ == type(jp).__name__
    assert_same_read(tp, jp)


WRITTEN = [("xenium", {}), ("xenium", {"nucleus_strategy": "intersect"}),
           ("xenium_poking", {}),
           ("xenium_poking", {"nucleus_strategy": "intersect"}),
           ("merscope", {}), ("standard", {})]


@pytest.mark.parametrize("kind,kw", WRITTEN,
                         ids=[f"{n}-{k.get('nucleus_strategy', 'vendor')}"
                              for n, k in WRITTEN])
def test_written_directories_read_like_jax(written, kind, kw):
    """The files both packages write hold the same tables, and each
    package reads its own into equal frames and polygons."""
    t_dir, j_dir = written[kind]
    assert sorted(p.name for p in t_dir.iterdir()) == sorted(
        p.name for p in j_dir.iterdir())
    for p in j_dir.iterdir():
        if p.suffix == ".parquet":
            pd.testing.assert_frame_equal(pd.read_parquet(t_dir / p.name),
                                          pd.read_parquet(p))
        else:
            assert (t_dir / p.name).read_bytes() == p.read_bytes()
    tp = t_pre.get_preprocessor(t_dir, **kw)
    jp = j_pre.get_preprocessor(j_dir, **kw)
    assert_same_read(tp, jp)
    assert len(tp.transcripts) > 300


def test_intersect_clips_the_poking_nuclei(written):
    """On the slide whose nuclei are larger than their cells, the
    'intersect' strategy changes the nucleus rings (so both strategies
    are exercised) and leaves the transcripts alone."""
    d = written["xenium_poking"][0]
    vendor = t_pre.XeniumPreprocessor(d)
    clipped = t_pre.XeniumPreprocessor(d, nucleus_strategy="intersect")
    pd.testing.assert_frame_equal(vendor.transcripts, clipped.transcripts)
    nv = {k: p for k, p in vendor.boundaries[1].items() if k[1] == "nucleus"}
    ni = {k: p for k, p in clipped.boundaries[1].items() if k[1] == "nucleus"}
    changed = [k for k in ni if ni[k].shape != nv[k].shape
               or not np.array_equal(ni[k], nv[k])]
    assert len(changed) > len(ni) // 2


def _empty(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    return d


def _infer(mod, d):
    try:
        return mod._infer_platform(Path(d))
    except Exception as e:      # the error is compared, not swallowed
        return type(e), str(e)


@pytest.mark.parametrize("which", ["xenium_v1", "xenium_v2", "cosmx",
                                   "xenium", "merscope", "standard",
                                   "empty"])
def test_infer_platform_like_jax(written, tmp_path, which):
    if which in written:
        d = written[which][0]
    elif which == "empty":
        d = _empty(tmp_path)
    else:
        d = VENDOR / which
    got, want = _infer(t_pre, d), _infer(j_pre, d)
    assert got == want
    if which == "empty":
        assert got[0] is ValueError and "Could not infer" in got[1]
    else:
        assert isinstance(got, str)


def test_unknown_platform_like_jax(written):
    d = written["standard"][0]
    for mod in (t_pre, j_pre):
        with pytest.raises(ValueError, match="Unknown platform"):
            mod.get_preprocessor(d, platform="visium")
    assert list(t_pre.PREPROCESSORS) == list(j_pre.PREPROCESSORS)


BATCHED = ["xenium_v1", "xenium_v2", "cosmx", "xenium", "merscope",
           "standard"]


@pytest.mark.parametrize("which", BATCHED)
def test_iter_transcripts_concatenates_to_transcripts(written, which):
    if which == "cosmx":
        pytest.importorskip("cv2")
    d = written[which][0] if which in written else VENDOR / which
    pp = t_pre.get_preprocessor(d)
    chunks = list(pp.iter_transcripts(batch_rows=97))
    if len(pp.transcripts) > 97:
        assert len(chunks) > 1
    pd.testing.assert_frame_equal(
        pd.concat(chunks, ignore_index=True),
        pp.transcripts.reset_index(drop=True))


@pytest.mark.parametrize("which", ["xenium", "merscope"])
@pytest.mark.parametrize("streaming", [False, True])
def test_save_reads_back_in_jax(written, tmp_path, which, streaming):
    """The port's ``save()`` writes a standardized directory that the JAX
    package's StandardPreprocessor reads into the frames and polygons of
    the JAX package's own ``save()``."""
    t_dir, j_dir = written[which]
    t_out = t_pre.get_preprocessor(t_dir).save(
        tmp_path / "t", streaming=streaming, batch_rows=97)
    j_out = j_pre.get_preprocessor(j_dir).save(
        tmp_path / "j", streaming=streaming, batch_rows=97)
    got = j_pre.get_preprocessor(t_out)
    assert type(got).__name__ == "StandardPreprocessor"
    assert_same_read(got, j_pre.StandardPreprocessor(j_out))
    with pytest.raises(IOError, match="exists"):
        t_pre.get_preprocessor(t_dir).save(t_out)


def test_cosmx_directory_check_like_jax(tmp_path):
    pytest.importorskip("cv2")
    from segger_tpu.io.cosmx import check_cosmx_directory as j_check
    from segger_tpu_torch.io.cosmx import check_cosmx_directory as t_check

    t_check(VENDOR / "cosmx")
    j_check(VENDOR / "cosmx")
    d = tmp_path / "cosmx"
    shutil.copytree(VENDOR / "cosmx", d)
    os.remove(d / "CellLabels" / "CellLabels_F002.tif")
    for check in (t_check, j_check):
        with pytest.raises(IOError, match=r"FOVs: \[2\]"):
            check(d)


def _wkb_polygon(rings, little=True, gtype=3, dims=2):
    e = "<" if little else ">"
    out = (b"\x01" if little else b"\x00") + struct.pack(e + "I", gtype)
    out += struct.pack(e + "I", len(rings))
    for ring in rings:
        ring = np.asarray(ring, np.float64)
        if dims > 2:
            ring = np.hstack([ring, np.full((len(ring), dims - 2), 7.0)])
        out += struct.pack(e + "I", len(ring))
        out += ring.astype(e + "f8").tobytes()
    return out


def _wkb_blobs():
    square = np.array([[0, 0], [4, 0], [4, 3], [0, 3]], np.float64)
    rng = np.random.default_rng(0)
    ring = np.cumsum(rng.normal(size=(30, 2)), axis=0)
    hole = square * 0.25 + 1.0
    blobs = {
        "roundtrip": t_syn._polygon_to_wkb(square),
        "big-endian": _wkb_polygon([square], little=False),
        "hole": _wkb_polygon([ring, hole]),
        "iso-z": _wkb_polygon([ring], gtype=1003, dims=3),
        "iso-zm": _wkb_polygon([ring], gtype=3003, dims=4),
        "ewkb-z": _wkb_polygon([ring], gtype=0x80000003, dims=3),
    }
    big = square * 3
    blobs["multi"] = (b"\x01" + struct.pack("<II", 6, 3)
                      + _wkb_polygon([square]) + _wkb_polygon([big])
                      + _wkb_polygon([square + 1], little=False))
    blobs["point"] = b"\x01" + struct.pack("<Idd", 1, 1.0, 2.0)
    return blobs


@pytest.mark.parametrize("name", list(_wkb_blobs()))
def test_wkb_to_polygon_like_jax(name):
    blob = _wkb_blobs()[name]
    got, want = t_wkb(blob), j_wkb(blob)
    if want is None:
        assert got is None and name == "point"
        return
    np.testing.assert_array_equal(got, want)
    assert j_syn._polygon_to_wkb(want[:-1]) == t_syn._polygon_to_wkb(
        got[:-1])


def _boolean_pairs():
    """test_nucleus_strategy.py's cell/nucleus squares, then rings of
    make_synthetic's shape that cross, nest, miss and share an edge."""
    sq = lambda x0, y0, x1, y1: np.array(  # noqa: E731
        [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float)
    pairs = {
        "inside": (sq(3, 3, 7, 7), sq(1, 1, 9, 9)),
        "poking": (sq(15, 3, 23, 7), sq(11, 1, 19, 9)),
        "disjoint": (sq(22, 12, 28, 18), sq(21, 1, 29, 9)),
        "shared-edge": (sq(0, 0, 4, 4), sq(4, 0, 8, 4)),
        "clockwise": (sq(15, 3, 23, 7)[::-1], sq(11, 1, 19, 9)),
    }
    rng = np.random.default_rng(1)
    for i in range(6):
        c = rng.uniform(0, 10, 2)
        a = t_syn._circle(c, 5.0, rng=rng)
        b = t_syn._circle(c + rng.uniform(-6, 6, 2), 4.0, rng=rng)
        pairs[f"rings{i}"] = (a, b)
    return pairs


def _intersect(mod, a, b):
    try:
        return mod.polygon_intersection(a, b)
    except mod.DegenerateIntersection as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(_boolean_pairs()))
def test_polygon_intersection_like_jax(name):
    a, b = _boolean_pairs()[name]
    got, want = _intersect(t_bool, a, b), _intersect(j_bool, a, b)
    if isinstance(want, tuple):
        assert got == want
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    g, w = t_bool.largest_ring(got), j_bool.largest_ring(want)
    assert (g is None) == (w is None)
    if w is not None:
        np.testing.assert_array_equal(g, w)
