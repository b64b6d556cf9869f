"""Whole-slide execution over a mesh of shards with a per-layer halo
exchange: 1-D strips (``halo.py``) and the 2-D grid with its two-stage
relay (``grid.py``), built on the host by ``_build_common.py``, the shards
driven by one process or by the ranks of a ``torch.distributed`` group
(``mesh.py``), the halo rows moved by ``transport.py``."""
from .mesh import (
    Mesh, initialize_multihost, make_grid_mesh, make_mesh, replicate,
    shutdown_multihost,
)

__all__ = ["Mesh", "initialize_multihost", "make_mesh", "make_grid_mesh",
           "replicate", "shutdown_multihost"]
