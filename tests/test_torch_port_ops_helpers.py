"""The port's sparse-op and host helpers against the JAX package's: the
COO converters, ``pad_rows`` and ``n_edges``, SpMM and SDDMM, the
differentiable gathers ``take_rows`` and ``csr_gather_t``, the COO
segment ops, ``row_gather_1d`` and ``harmonic_k`` (mirroring
``tests/test_ops.py`` and ``tests/test_partition.py``).

Inputs are made with numpy from a seed and handed to both frameworks;
the port runs on the CPU.  Tolerances: float32 within 1e-6 of the
reference's largest magnitude, bfloat16 within 1e-2 of it; integer
outputs, COO tables, padded tables, edge counts and bins equal.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import segger_tpu.ops as jops
from segger_tpu.data import graph as jgraph
from segger_tpu.data.partition import harmonic_k as j_harmonic_k
from segger_tpu.ops import gather_agg as jga

import segger_tpu_torch.ops as tops
from segger_tpu_torch.data import graph as tgraph
from segger_tpu_torch.data.partition import harmonic_k as t_harmonic_k
from segger_tpu_torch.ops import gather_agg as tga

ROOT = Path(__file__).resolve().parents[1]
_DT = {"float32": (jnp.float32, torch.float32, 1e-6),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def random_coo(rng, n_src, n_dst, e):
    """Distinct (dst, src) pairs, as tests/test_ops.py makes them."""
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst, e)
    pairs = np.unique(np.stack([dst, src], 1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def tables(seed, n_src=30, n_dst=22, e=150):
    """The JAX and the port table of one random COO graph (the port's
    as CPU tensors), with a few empty rows."""
    rng = np.random.default_rng(seed)
    dst, src = random_coo(rng, n_src, n_dst, e)
    keep = dst >= 3                      # rows 0..2 stay empty
    j = jops.coo_to_padded_csr(dst[keep], src[keep], n_dst=n_dst)
    t = tops.coo_to_padded_csr(dst[keep], src[keep], n_dst=n_dst)
    return rng, j, t.to("cpu")


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def value_and_vjp(fn, args, ct):
    """``fn(*args)`` and its VJP at the cotangent ``ct``, in one
    compiled JAX program."""
    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)
    return jax.jit(run)(args, ct)


def assert_close(got, want, rel):
    """Within ``rel`` of the reference's largest magnitude (at least 1)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * scale, f"err {err} of scale {scale}"


# ---------------------------------------------------------------------
# padded-CSR host helpers
# ---------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(50, 40, 300), (12, 9, 0), (5, 30, 20)],
                         ids=["dense", "empty", "sparse"])
def test_coo_roundtrip_matches_jax(shape):
    n_src, n_dst, e = shape
    rng = np.random.default_rng(7)
    dst, src = random_coo(rng, n_src, n_dst, e)
    jcsr = jops.coo_to_padded_csr(dst, src, n_dst=n_dst, k=4 if e == 0
                                  else None)
    tcsr = tops.coo_to_padded_csr(dst, src, n_dst=n_dst, k=4 if e == 0
                                  else None)
    want = jops.padded_csr_to_coo(jcsr)
    for csr in (tcsr, tcsr.to("cpu")):      # host arrays, then tensors
        got = tops.padded_csr_to_coo(csr)
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    assert set(zip(*map(np.ndarray.tolist, want))) == set(
        zip(dst.tolist(), src.tolist()))


@pytest.mark.parametrize("n_dst", [10, 22, 37])
def test_pad_rows_matches_jax(n_dst):
    _, j, t = tables(1)
    host = tops.PaddedCSR(t.idx.numpy(), t.mask.numpy())
    want = jops.pad_rows(j, n_dst)
    got = tops.pad_rows(host, n_dst)
    if n_dst <= 22:
        assert got is host and want is j
    np.testing.assert_array_equal(got.idx, np.asarray(want.idx))
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    assert not np.asarray(got.mask)[22:].any()


def test_n_edges_matches_jax():
    _, j, t = tables(2)
    host = tops.PaddedCSR(t.idx.numpy(), t.mask.numpy())
    assert isinstance(host.n_edges, np.integer)
    assert isinstance(t.n_edges, torch.Tensor) and t.n_edges.dim() == 0
    assert int(host.n_edges) == int(t.n_edges) == int(j.n_edges)
    # TileGraph.n_edges(): tt + tb, and + bt when present
    _, j2, t2 = tables(3, n_src=22, n_dst=9, e=40)
    for bt in (False, True):
        jt = jgraph.TileGraph(**{
            **{f.name: None for f in dataclasses.fields(jgraph.TileGraph)
               if f.default is dataclasses.MISSING},
            "tt": j, "tb": j2, "bt": j2 if bt else None})
        tt = tgraph.TileGraph(**{
            **{f.name: None for f in dataclasses.fields(tgraph.TileGraph)
               if f.default is dataclasses.MISSING},
            "tt": t, "tb": t2, "bt": t2 if bt else None})
        assert int(tt.n_edges()) == int(jt.n_edges()) == int(
            j.n_edges) + (2 if bt else 1) * int(j2.n_edges)


# ---------------------------------------------------------------------
# SpMM / SDDMM, forward and backward
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("weights", ["none", "per-edge", "per-head"])
def test_spmm_and_its_grads_match_jax(weights, dtype):
    jdt, tdt, rel = _DT[dtype]
    rng, j, t = tables(4)
    f, heads = 8, 3
    x = rng.normal(size=(30, f)).astype(np.float32)
    wshape = {"none": None, "per-edge": j.idx.shape,
              "per-head": (*j.idx.shape, heads)}[weights]
    w = None if wshape is None else rng.normal(size=wshape).astype(
        np.float32)
    jx = jnp.asarray(x, jdt)
    jw = None if w is None else jnp.asarray(w, jdt)
    ct = rng.normal(size=(22, heads, f) if weights == "per-head"
                    else (22, f)).astype(np.float32)
    want, want_grads = value_and_vjp(lambda a, b: jops.csr_spmm(a, j, b),
                                     (jx, jw), jnp.asarray(ct, jdt))

    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    tw = None if w is None else torch.tensor(w, dtype=tdt,
                                             requires_grad=True)
    got = tops.csr_spmm(tx, t, tw)
    assert got.dtype == tdt
    assert_close(got, want, rel)
    ins = [tx] if tw is None else [tx, tw]
    got_grads = torch.autograd.grad(got, ins, torch.tensor(ct, dtype=tdt))
    for g, wg in zip(got_grads, want_grads):
        assert_close(g, wg, rel)


def test_grad_flows_through_spmm_as_in_degree():
    """As tests/test_ops.py: the gradient of the sum of the neighbor sums
    is each source row's out-degree."""
    rng = np.random.default_rng(0)
    dst, src = random_coo(rng, 10, 7, 30)
    csr = tops.coo_to_padded_csr(dst, src, n_dst=7).to("cpu")
    x = torch.tensor(rng.normal(size=(10, 4)), dtype=torch.float32,
                     requires_grad=True)
    (g,) = torch.autograd.grad(tops.csr_spmm(x, csr).sum(), x)
    np.testing.assert_allclose(g[:, 0].numpy(),
                               np.bincount(src, minlength=10), rtol=1e-6)


@pytest.mark.parametrize("dtype", list(_DT))
def test_sddmm_matches_jax(dtype):
    jdt, tdt, rel = _DT[dtype]
    rng, j, t = tables(5)
    xs = rng.normal(size=(30, 6)).astype(np.float32)
    xd = rng.normal(size=(22, 6)).astype(np.float32)
    want = jops.csr_sddmm(jnp.asarray(xs, jdt), jnp.asarray(xd, jdt), j)
    got = tops.csr_sddmm(torch.tensor(xs, dtype=tdt),
                         torch.tensor(xd, dtype=tdt), t)
    assert_close(got, want, rel)
    assert (got[~t.mask] == 0).all()


# ---------------------------------------------------------------------
# the differentiable gathers
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("trailing", [(), (5,), (2, 3)],
                         ids=["1d", "2d", "3d"])
def test_take_rows_and_grad_match_jax(trailing, dtype):
    """Repeated indices sum their cotangents; rows nothing gathers get
    0."""
    jdt, tdt, rel = _DT[dtype]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(12, *trailing)).astype(np.float32)
    idx = np.concatenate([[3, 3, 3, 0, 11], rng.integers(0, 8, 9)])
    ct = rng.normal(size=(idx.size, *trailing)).astype(np.float32)
    want, (want_g,) = value_and_vjp(
        lambda a: jga.take_rows(a, jnp.asarray(idx)), (jnp.asarray(x, jdt),),
        jnp.asarray(ct, jdt))

    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    got = tga.take_rows(tx, torch.tensor(idx))
    (got_g,) = torch.autograd.grad(got, tx, torch.tensor(ct, dtype=tdt))
    assert_close(got, want, 0)
    assert_close(got_g, want_g, rel)
    assert (got_g[8:11] == 0).all()


@pytest.mark.parametrize("dtype", list(_DT))
def test_csr_gather_t_and_grad_match_jax(dtype):
    jdt, tdt, rel = _DT[dtype]
    rng, j, t = tables(8)
    jt = jops.transpose_csr(j, n_src=30)
    tt = tops.transpose_csr(tops.PaddedCSR(t.idx.numpy(), t.mask.numpy()),
                            n_src=30).to("cpu")
    x = rng.normal(size=(30, 8)).astype(np.float32)
    ct = rng.normal(size=(*j.idx.shape, 8)).astype(np.float32)
    want, (want_g,) = value_and_vjp(lambda a: jops.csr_gather_t(a, j, jt),
                                    (jnp.asarray(x, jdt),),
                                    jnp.asarray(ct, jdt))

    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    got = tops.csr_gather_t(tx, t, tt)
    (got_g,) = torch.autograd.grad(got, tx, torch.tensor(ct, dtype=tdt))
    assert got_g.dtype == tdt
    assert_close(got, want, 0)
    assert_close(got_g, want_g, rel)


@pytest.mark.parametrize("trailing", [(8,), (2, 4)], ids=["2d", "3d"])
def test_csr_gather_t_grad_matches_plain_gather(trailing):
    """As tests/test_ops.py: the transpose-table backward equals the
    scatter backward of the plain gather on the valid slots (with any
    trailing shape here)."""
    rng, _, t = tables(9)
    tt = tops.transpose_csr(tops.PaddedCSR(t.idx.numpy(), t.mask.numpy()),
                            n_src=30).to("cpu")
    x = torch.tensor(rng.normal(size=(30, *trailing)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(*t.idx.shape, *trailing)),
                     dtype=torch.float32)
    m = t.mask.reshape(*t.mask.shape, *[1] * len(trailing))

    def loss(gather):
        return torch.where(m, gather * w, 0).sum()

    (g_plain,) = torch.autograd.grad(loss(tops.csr_gather(x, t)), x)
    (g_t,) = torch.autograd.grad(loss(tops.csr_gather_t(x, t, tt)), x)
    torch.testing.assert_close(g_t, g_plain, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------
# COO segment ops
# ---------------------------------------------------------------------
def segment_inputs(dtype, trailing=()):
    """Ids with empty segments (1 and 5) and ids outside [0, 7)."""
    rng = np.random.default_rng(11)
    ids = np.array([0, 0, 2, 3, 3, 3, 4, 6, 6, -1, 7, 9, 2])
    if dtype == "int32":
        data = rng.integers(-50, 50, (ids.size, *trailing)).astype(np.int32)
    else:
        data = rng.normal(size=(ids.size, *trailing)).astype(np.float32)
    return ids, data


def _both(dtype, data):
    if dtype == "int32":
        return jnp.asarray(data), torch.tensor(data)
    jdt, tdt, _ = _DT[dtype]
    return jnp.asarray(data, jdt), torch.tensor(data, dtype=tdt)


@pytest.mark.parametrize("trailing", [(), (3,)], ids=["1d", "2d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("op", ["segment_sum", "segment_max"])
def test_segment_ops_match_jax(op, dtype, trailing):
    ids, data = segment_inputs(dtype, trailing)
    jd, td = _both(dtype, data)
    want = jax.jit(getattr(jops, op), static_argnums=2)(
        jd, jnp.asarray(ids), 7)
    got = getattr(tops, op)(td, torch.tensor(ids), 7)
    assert got.dtype == td.dtype and tuple(got.shape) == want.shape
    if dtype == "int32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        # sums of at most three terms; the max is one of its inputs
        assert_close(got.masked_fill(torch.isinf(got), 0),
                     jnp.where(jnp.isinf(want), 0, want), _DT[dtype][2])
        np.testing.assert_array_equal(torch.isinf(got).numpy(),
                                      np.asarray(jnp.isinf(want)))
    empty = [1, 5]
    if op == "segment_max":
        low = (-np.inf if dtype != "int32"
               else np.iinfo(np.int32).min)
        assert (to_np(got[empty]) == low).all()
    else:
        assert (to_np(got[empty]) == 0).all()


@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("case", ["coo", "out-of-range", "lone -inf"])
def test_segment_softmax_matches_jax(case, dtype):
    jdt, tdt, rel = _DT[dtype]
    ids, logits = segment_inputs("float32")
    if case == "coo":
        keep = (ids >= 0) & (ids < 7)
        ids, logits = ids[keep], logits[keep]
    elif case == "lone -inf":
        logits[7:9] = -np.inf       # segment 6 holds only -inf logits
        logits[3] = -np.inf         # one -inf among segment 3's
    want = jax.jit(jops.segment_softmax, static_argnums=2)(
        jnp.asarray(logits, jdt), jnp.asarray(ids), 7)
    got = tops.segment_softmax(torch.tensor(logits, dtype=tdt),
                               torch.tensor(ids), 7)
    assert torch.isfinite(got).all()
    assert_close(got, want, rel)
    if case == "lone -inf":
        assert (got[[3, 7, 8]] == 0).all()


def test_csr_softmax_matches_segment_softmax():
    """As tests/test_ops.py: the masked row softmax of a table equals the
    segment softmax of its COO form (the port against itself and against
    JAX's segment softmax)."""
    rng, j, t = tables(12, n_src=10, n_dst=8, e=40)
    logits = rng.normal(size=t.idx.shape).astype(np.float32)
    a_tbl = tops.csr_softmax(torch.tensor(logits), t)
    dst, _ = tops.padded_csr_to_coo(t)
    mask = t.mask.numpy()
    coo = tops.segment_softmax(torch.tensor(logits[mask]),
                               torch.tensor(dst), 8)
    want = jops.segment_softmax(jnp.asarray(logits[mask]), jnp.asarray(dst),
                                8)
    torch.testing.assert_close(a_tbl[t.mask], coo, rtol=1e-5, atol=1e-6)
    assert_close(coo, want, 1e-6)


# ---------------------------------------------------------------------
# row_gather_1d
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 1000])
def test_row_gather_1d_matches_jax(m, dtype):
    """Every position of the table and of JAX's pad region, repeats
    included: equal to JAX (0 in the pad).  Past the pad and below 0 the
    port gives 0."""
    rng = np.random.default_rng(3)
    table = (rng.integers(-5, 10_000, m).astype(np.int32)
             if dtype == "int32" else rng.normal(size=m).astype(np.float32))
    m_pad = -(-m // 128) * 128
    pos = np.concatenate([rng.integers(0, m, 257),
                          np.arange(m, m_pad), [m - 1, 0]]).astype(np.int32)
    want = np.asarray(jax.jit(jops.row_gather_1d)(jnp.asarray(table),
                                                  jnp.asarray(pos)))
    got = tops.row_gather_1d(torch.tensor(table), torch.tensor(pos))
    assert got.dtype == torch.tensor(table).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:257], table[pos[:257]])
    outside = torch.tensor([-1, -m - 5, m_pad, m_pad + 200])
    assert (tops.row_gather_1d(torch.tensor(table), outside) == 0).all()


# ---------------------------------------------------------------------
# harmonic_k
# ---------------------------------------------------------------------
def _same_bins(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_harmonic_k_reference_semantics():
    """tests/test_partition.py's contract, on the port."""
    vals = np.array([40.0, 45.0, 41.0, 42.0, 49.0])
    bins = t_harmonic_k(vals, 100.0)
    two = [sorted(b.tolist()) for b in bins if len(b) == 2]
    assert [0, 1] in two and [2, 3] in two
    assert any(b.tolist() == [4] for b in bins)
    sizes = sorted(len(b) for b in t_harmonic_k(np.full(25, 10.0), 100.0,
                                                k=6))
    assert sizes == [5, 10, 10]
    with pytest.raises(ValueError):
        t_harmonic_k(np.array([5.0, 200.0]), 100.0)
    bins = t_harmonic_k(np.array([5.0, 200.0, -1.0, 30.0]), 100.0,
                        skip_too_big=True)
    assert set(np.concatenate(bins).tolist()) == {0, 3}
    with pytest.raises(ValueError, match="k must be"):
        t_harmonic_k(np.array([5.0]), 100.0, k=1)


@pytest.mark.parametrize("k", [2, 3, 6])
def test_harmonic_k_matches_jax_on_random_streams(k):
    """200 random streams a k, some with sizes out of range (dropped with
    ``skip_too_big``, refused without it by both)."""
    rng = np.random.default_rng(100 + k)
    for s in range(200):
        n = int(rng.integers(0, 40))
        vals = rng.uniform(0.5, 100.0, n)
        if s % 4 == 0 and n:
            vals[rng.integers(0, n, 2)] = rng.choice([0.0, -3.0, 150.0], 2)
        bad = ((vals <= 0) | (vals > 100.0)).any()
        for skip in (False, True):
            if bad and not skip:
                for fn in (j_harmonic_k, t_harmonic_k):
                    with pytest.raises(ValueError):
                        fn(vals, 100.0, k=k, skip_too_big=skip)
                continue
            _same_bins(t_harmonic_k(vals, 100.0, k=k, skip_too_big=skip),
                       j_harmonic_k(vals, 100.0, k=k, skip_too_big=skip))


# ---------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------
def test_ops_exports_every_jax_ops_name():
    for name in jops.__all__:
        assert hasattr(tops, name) and name in tops.__all__, name


# JAX-only names: what each is, and why the port needs no counterpart
# (ROADMAP.md lists them too)
JAX_ONLY = {
    "enable_compilation_cache",   # XLA's cache; kernels cache in build/
    "fits_vmem", "supported", "pallas_available",   # Pallas shape gates
    "no_dropout_keep", "prng_dropout_seed",   # seeds: postgather.seed_words
    "gatv2_edge_stage_pallas", "score_max_pallas",  # edge_stage_fwd, score_max
    "torch_linear_bias_init",     # reset_parameters draws the same U(+-1/sqrt)
    "available",                  # native.py raises: there is no fallback
}


def _public_names(root: Path) -> set:
    """Public top-level functions and classes, and their public methods
    and properties, of every module under ``root``."""
    out = set()
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                    and not node.name.startswith("_"):
                out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")}
    return out


def test_no_jax_public_name_is_left_to_port():
    """An AST walk of both packages: every public name of the JAX package
    has a counterpart in the port, apart from the JAX-only list."""
    missing = (_public_names(ROOT / "segger_tpu")
               - _public_names(ROOT / "segger_tpu_torch"))
    assert missing == JAX_ONLY


def test_chip_smoke_helpers_drive_on_the_cpu():
    """``chip_smoke.py``'s phase 13, small, with the CPU on both sides:
    every helper call and its check run (a matmul's threads may sum in
    another order from run to run), and no wrapper counts a launch."""
    import chip_smoke

    r = chip_smoke.drive_helpers(device="cpu", n_tx=1500, n_bd=200, hc=16)
    assert set(r["helpers"]) == set(chip_smoke.helper_calls(1500))
    assert all(h["max_abs_err"] <= 1e-5 and h["cuda_ms"] is None
               for h in r["helpers"].values())
    assert r["k"] % 8 == 0 and r["edges"] > 1500
