from .padded_csr import (
    PaddedCSR, coo_to_padded_csr, padded_csr_to_coo, transpose_csr,
    pad_rows,
)
from .gather_agg import (
    csr_gather, row_gather_1d, csr_gather_t, csr_spmm, csr_sddmm,
    csr_softmax, csr_max, score_candidates, segment_sum, segment_max,
    segment_softmax,
)
from .postgather import edge_stage_fwd, edge_stage_fwd_reference
from .score import score_max, score_max_reference
from .gatv2_attn import gatv2_attention, gatv2_attention_reference
from .banded import (
    BLOCK, K_BAND, WINDOW, band_graph, banded_edge_stage,
    banded_edge_stage_reference,
)

__all__ = [
    "PaddedCSR",
    "row_gather_1d",
    "coo_to_padded_csr",
    "padded_csr_to_coo",
    "transpose_csr",
    "pad_rows",
    "csr_gather",
    "csr_gather_t",
    "csr_spmm",
    "csr_sddmm",
    "csr_softmax",
    "csr_max",
    "score_candidates",
    "segment_sum",
    "segment_max",
    "segment_softmax",
    "edge_stage_fwd",
    "edge_stage_fwd_reference",
    "score_max",
    "score_max_reference",
    "gatv2_attention",
    "gatv2_attention_reference",
    "band_graph",
    "banded_edge_stage",
    "banded_edge_stage_reference",
    "BLOCK",
    "WINDOW",
    "K_BAND",
]
