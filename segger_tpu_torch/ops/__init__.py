from .padded_csr import PaddedCSR, coo_to_padded_csr, transpose_csr
from .gather_agg import csr_gather, csr_softmax, csr_max, score_candidates
from .postgather import edge_stage_fwd, edge_stage_fwd_reference
from .score import score_max, score_max_reference

__all__ = [
    "PaddedCSR",
    "coo_to_padded_csr",
    "transpose_csr",
    "csr_gather",
    "csr_softmax",
    "csr_max",
    "score_candidates",
    "edge_stage_fwd",
    "edge_stage_fwd_reference",
    "score_max",
    "score_max_reference",
]
