"""Field-name schemas of the standardized dataset and its training view.

These mirror the reference's column contracts
(reference: src/segger/io/fields.py:104-139) so that datasets standardized
by either package are interchangeable on disk.  The raw vendor schemas
(Xenium, MERSCOPE, CosMX) come with the I/O readers.
"""
from dataclasses import dataclass


@dataclass
class StandardTranscriptFields:
    filename: str = "transcripts.parquet"
    row_index: str = "row_index"
    x: str = "x"
    y: str = "y"
    feature: str = "feature_name"
    cell_id: str = "cell_id"
    compartment: str = "cell_compartment"
    extracellular_value: int = 0
    cytoplasmic_value: int = 1
    nucleus_value: int = 2


@dataclass
class StandardBoundaryFields:
    filename: str = "boundaries.parquet"
    id: str = "cell_id"
    boundary_type: str = "boundary_type"
    cell_value: str = "cell"
    nucleus_value: str = "nucleus"
    contains_nucleus: str = "contains_nucleus"


@dataclass
class TrainingTranscriptFields(StandardTranscriptFields):
    cell_encoding: str = "cell_encoding"
    gene_encoding: str = "gene_encoding"
    cell_cluster: str = "cell_cluster"
    gene_cluster: str = "gene_cluster"
