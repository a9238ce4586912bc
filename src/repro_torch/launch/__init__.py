"""Launch helpers: the counterpart of ``repro.launch`` (so far its mesh
construction, :mod:`.mesh`)."""

from .mesh import (
    AbstractMesh,
    make_debug_mesh,
    make_mesh,
    make_production_mesh,
    mesh_batch_axes,
    production_layout,
)

__all__ = ["AbstractMesh", "make_debug_mesh", "make_mesh", "make_production_mesh",
           "mesh_batch_axes", "production_layout"]
