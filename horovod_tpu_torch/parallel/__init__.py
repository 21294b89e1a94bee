"""Data parallelism of the port: the mesh, collectives and gradient sync."""
from .collectives import allreduce
from .grad_sync import GradSyncConfig, sync_gradients
from .mesh import Mesh, MeshSpec, build_mesh, data_axes

__all__ = ["allreduce", "GradSyncConfig", "sync_gradients", "Mesh",
           "MeshSpec", "build_mesh", "data_axes"]
