"""The benchmark's yardstick: the card's peaks, the bytes and operations
each kernel launch needs, and the model FLOPs of a tile.

These are frozen here, beside the benchmark, so that a change to the
program cannot move them.  Bytes count each input read once and each
output written once, at the launch's own table: the source rows that the
valid slots reference (each once), the whole (N, K) idx and mask tables,
the destination rows and the outputs.  The forms are those of
``chip_smoke.py``'s per-kernel checks when the benchmark was defined.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores

FREQ_DIM = 256                 # the positional embedding's frequencies
EDGE_FWD_OPS = 8               # per valid slot and channel: add, leaky,
                               # logit fma, weighted sum
EDGE_BWD_OPS = 14              # t, dA, p, s, datt, dp, dxr, dg
BWD_PARTIAL_ROWS, BWD_PARTIAL_MAX = 8, 1024


def source_rows(idx: np.ndarray, mask: np.ndarray) -> int:
    """The distinct source rows that the valid slots reference."""
    return int(np.unique(idx[mask]).size)


def edge_fwd_bytes(idx, mask, hc: int, heads: int, size: int) -> int:
    """One forward edge-stage launch (K1, K2): the referenced source rows,
    idx and mask, the destination rows, att; out and the float32 alpha."""
    n, k = idx.shape
    return (source_rows(idx, mask) * hc * size + idx.size * 5
            + 2 * n * hc * size + hc * size + n * k * heads * 4)


def edge_bwd_bytes(idx, mask, hc: int, heads: int, size: int) -> int:
    """One backward launch (K3): the referenced source rows, idx and mask,
    the destination rows, the output cotangent, alpha; dg (N, K, HC), dxr
    and the datt partials (one per 8 rows, at most 1,024)."""
    n, k = idx.shape
    blocks = min(-(-n // BWD_PARTIAL_ROWS), BWD_PARTIAL_MAX)
    return (source_rows(idx, mask) * hc * size + idx.size * 5
            + 2 * n * hc * size + n * k * heads * 4 + n * k * hc * size
            + n * hc * size + blocks * hc * 4)


def score_bytes(idx, mask, f: int, size: int) -> int:
    """One scoring launch (K5): the referenced cell rows and the
    transcript rows, idx and mask, the float32 max and int32 slot."""
    n = idx.shape[0]
    return (source_rows(idx, mask) + n) * f * size + idx.size * 5 + n * 8


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time a launch can take: bytes at the HBM rate or float32
    operations at the CUDA cores' rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def tt_bounds(n: int, k: int, n_lo: int, k_lo: int, n_xlo: int,
              k_xlo: int) -> List[Tuple[int, int, int]]:
    """(start, stop, K) of the launches of an (n, k) tt table in degree
    buckets: the extra-low and low rows at their narrow widths, then the
    rest at full width; the whole table when it is not bucketed.  The
    reference follows the same launches."""
    if n_lo <= 0:
        return [(0, n, k)]
    bounds = [(0, n_xlo, k_xlo)] if n_xlo > 0 else []
    return bounds + [(n_xlo, n_lo, k_lo), (n_lo, n, k)]


def tt_segments(tt_idx, tt_mask, n_lo: int, k_lo: int, n_xlo: int,
                k_xlo: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The (idx, mask) tables of a degree-bucketed tt table's launches."""
    return [(tt_idx[a:b, :k], tt_mask[a:b, :k]) for a, b, k in
            tt_bounds(*tt_idx.shape, n_lo, k_lo, n_xlo, k_xlo)]


def layer_launches(tile: Dict[str, np.ndarray]) -> List[Tuple]:
    """The edge-stage launches of one hetero layer on a tile: its tt
    segments, then tb."""
    segs = tt_segments(tile["tt_idx"], tile["tt_mask"], tile["n_lo"],
                       tile["k_lo"], tile["n_xlo"], tile["k_xlo"])
    return segs + [(tile["tb_idx"], tile["tb_mask"])]


def tile_kernel_seconds(tile: Dict[str, np.ndarray], model: dict,
                        size: int) -> Dict[str, float]:
    """The least seconds of one forward's edge-stage launches and of one
    backward's, and of its scoring launch, on a tile: ``{"fwd", "bwd",
    "score"}``.  Every layer has the same tables and width."""
    heads = model["n_heads"]
    hc = heads * model["hidden_channels"]
    n_layers = model["n_mid_layers"] + 2
    fwd = bwd = 0.0
    for idx, mask in layer_launches(tile):
        valid = int(mask.sum())
        fwd += least_seconds(edge_fwd_bytes(idx, mask, hc, heads, size),
                             valid * hc * EDGE_FWD_OPS)
        bwd += least_seconds(edge_bwd_bytes(idx, mask, hc, heads, size),
                             valid * hc * EDGE_BWD_OPS)
    f = model["out_channels"]
    cand_valid = int(tile["cand_mask"].sum())
    score = least_seconds(
        score_bytes(tile["cand_idx"], tile["cand_mask"], f, size),
        cand_valid * f * 2)
    return {"fwd": fwd * n_layers, "bwd": bwd * n_layers, "score": score}


def forward_flops(n_tx: int, n_bd: int, e_tt: int, e_tb: int,
                  model: dict, n_bd_features: int) -> float:
    """Model FLOPs of one encoder forward over a tile's valid rows and
    valid edges: the positional MLP and the bd projection, each layer's
    four projections and its edge stage, the output projections."""
    ic = model["in_channels"]
    half = ic // 2
    heads = model["n_heads"]
    widths = ([model["hidden_channels"]] * (1 + model["n_mid_layers"])
              + [model["out_channels"]])
    flops = 2 * (n_tx + n_bd) * 2 * (FREQ_DIM * half + half * half)
    flops += 2 * n_bd * n_bd_features * ic
    d = ic + 2 * half
    for w in widths:
        hc = heads * w
        # tt: lin_l and lin_r over tx; tb: lin_l over tx, lin_r over bd
        flops += 2 * d * hc * (3 * n_tx + n_bd)
        flops += EDGE_FWD_OPS * hc * (e_tt + e_tb)
        d = hc
    flops += 2 * (n_tx + n_bd) * d * model["out_channels"]
    return float(flops)


def score_flops(e_cand: int, model: dict) -> float:
    """The candidate scoring's dot products over the valid candidates."""
    return 2.0 * model["out_channels"] * e_cand


def tiles_flops(tiles: Iterable[Dict[str, np.ndarray]], model: dict,
                n_bd_features: int, times: float,
                score: bool = False) -> float:
    """``times`` forwards (3 for a train step: forward and backward) of
    every tile, with the scoring when ``score``."""
    total = 0.0
    for t in tiles:
        total += times * forward_flops(
            int(t["tx_valid"].sum()), int(t["bd_valid"].sum()),
            int(t["tt_mask"].sum()), int(t["tb_mask"].sum()), model,
            n_bd_features)
        if score:
            total += score_flops(int(t["cand_mask"].sum()), model)
    return total
