from .boundary import cell_boundary, generate_boundaries, chaikin
from .anndata_writer import build_anndata

__all__ = [
    "cell_boundary",
    "generate_boundaries",
    "chaikin",
    "build_anndata",
]
