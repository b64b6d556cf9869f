"""The frozen byte and FLOP counts against hand counts on small tables."""
import numpy as np
import pytest

import counts

# 3 destination rows, K = 2: the valid slots reference source rows 5, 7
# and 7 again; row 2 is empty
IDX = np.array([[5, 7], [7, 0], [0, 0]], np.int32)
MASK = np.array([[True, True], [True, False], [False, False]])


def test_source_rows_counts_each_referenced_row_once():
    assert counts.source_rows(IDX, MASK) == 2          # rows 5 and 7


def test_edge_forward_bytes_by_hand():
    hc, heads, size = 4, 2, 2
    # sources 2*4*2 = 16, idx+mask 6*5 = 30, xr and out 2*3*4*2 = 48,
    # att 4*2 = 8, alpha 3*2*2*4 = 48
    assert counts.edge_fwd_bytes(IDX, MASK, hc, heads, size) == 150


def test_edge_backward_bytes_by_hand():
    hc, heads, size = 4, 2, 2
    # sources 16, idx+mask 30, xr and go 48, alpha 48, dg 3*2*4*2 = 48,
    # dxr 3*4*2 = 24, one block of partials 4*4 = 16
    assert counts.edge_bwd_bytes(IDX, MASK, hc, heads, size) == 230


def test_score_bytes_by_hand():
    f, size = 4, 2
    # (2 cell rows + 3 tx rows)*4*2 = 40, idx+mask 30, max+slot 3*8 = 24
    assert counts.score_bytes(IDX, MASK, f, size) == 94


def test_least_seconds_takes_the_longer_bound():
    assert counts.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert counts.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_tt_segments_follow_the_degree_buckets():
    idx = np.arange(40, dtype=np.int32).reshape(10, 4)
    mask = np.ones((10, 4), bool)
    segs = counts.tt_segments(idx, mask, n_lo=6, k_lo=2, n_xlo=2, k_xlo=1)
    assert [s[0].shape for s in segs] == [(2, 1), (4, 2), (4, 4)]
    assert (segs[1][0] == idx[2:6, :2]).all()
    assert [s[0].shape for s in counts.tt_segments(idx, mask, 0, 0, 0, 0)] \
        == [(10, 4)]


MODEL = {"in_channels": 2, "hidden_channels": 1, "out_channels": 1,
         "n_mid_layers": 0, "n_heads": 1}


def test_forward_flops_by_hand():
    # 1 tx, 1 bd, 1 tt and 1 tb edge; in 2 (half 1), F_bd 3, two layers
    # of width 1.  positional: 2*(1+1)*2*(256*1+1*1) = 2056; bd linear
    # 2*1*3*2 = 12; layer 0 (d = 4): 2*4*1*(3+1) = 32 + 8*1*2 = 16;
    # layer 1 (d = 1): 8 + 16; head 2*2*1*1 = 4
    assert counts.forward_flops(1, 1, 1, 1, MODEL, 3) == 2056 + 12 + 48 + 24 + 4


def test_tiles_flops_counts_valid_rows_and_edges_only():
    tile = {"tx_valid": np.array([True, False]),
            "bd_valid": np.array([True, False]),
            "tt_mask": np.array([[True, False], [False, False]]),
            "tb_mask": np.array([[True], [False]]),
            "cand_mask": np.array([[True, True], [False, False]])}
    one = counts.forward_flops(1, 1, 1, 1, MODEL, 3)
    assert counts.tiles_flops([tile], MODEL, 3, 3) == 3 * one
    assert counts.tiles_flops([tile], MODEL, 3, 1, score=True) == one + 4
