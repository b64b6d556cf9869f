from .fields import (
    StandardTranscriptFields,
    StandardBoundaryFields,
    TrainingTranscriptFields,
    TrainingBoundaryFields,
)
from .preprocessor import (
    ISTPreprocessor,
    get_preprocessor,
    register_preprocessor,
    PREPROCESSORS,
)

__all__ = [
    "StandardTranscriptFields",
    "StandardBoundaryFields",
    "TrainingTranscriptFields",
    "TrainingBoundaryFields",
    "ISTPreprocessor",
    "get_preprocessor",
    "register_preprocessor",
    "PREPROCESSORS",
]
