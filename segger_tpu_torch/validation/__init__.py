"""Contamination QC (the port's copy of ``segger_tpu.validation``)."""
from .contamination import (
    calculate_contamination,
    contamination_flow,
    expression_summary_from_anndata,
    get_neighbor_frequencies,
    group_reference,
)

__all__ = [
    "get_neighbor_frequencies",
    "calculate_contamination",
    "contamination_flow",
    "group_reference",
    "expression_summary_from_anndata",
]
