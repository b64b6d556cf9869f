"""Whole-slide execution over a mesh of shards with a per-layer halo
exchange: 1-D strips (``halo.py``) and the 2-D grid with its two-stage
relay (``grid.py``), built on the host by ``_build_common.py`` and run
by one process driving every shard (``mesh.py``)."""
from .mesh import Mesh, make_grid_mesh, make_mesh, replicate

__all__ = ["Mesh", "make_mesh", "make_grid_mesh", "replicate"]
