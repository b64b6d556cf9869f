"""Segmentation quality metrics (the port's copy of ``segger_tpu.metrics``)."""
from .segment import (
    assignment_accuracy,
    assignment_ari,
    assignment_f1,
    cluster_purity,
    segmentation_report,
)

__all__ = [
    "assignment_f1",
    "assignment_ari",
    "assignment_accuracy",
    "cluster_purity",
    "segmentation_report",
]
