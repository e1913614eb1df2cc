"""Meshes of ranks for the model half of the multi-rank port: :mod:`.mesh`
builds the ``("data", "model")`` model mesh that the expert-parallel MoE
layers (``models.moe_ep``) and data-parallel training run on, and the
one-axis meshes of a pipeline's stages."""
from .mesh import (ModelMesh, make_axis_mesh, make_host_mesh, make_mesh_shape,
                   make_production_mesh)

__all__ = ["ModelMesh", "make_host_mesh", "make_mesh_shape", "make_production_mesh",
           "make_axis_mesh"]
