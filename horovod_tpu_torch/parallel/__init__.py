"""Data parallelism of the port: the mesh, collectives and gradient sync."""
from .collectives import (adasum_allreduce, allgather, allreduce, alltoall,
                          reduce_scatter)
from .grad_sync import (GradSyncConfig, init_error_feedback,
                        init_ring_optimizer, ring_chunk_size, sync_and_apply,
                        sync_gradients, sync_gradients_ef)
from .mesh import Mesh, MeshSpec, axis_groups, build_mesh, data_axes

__all__ = ["adasum_allreduce", "allgather", "allreduce", "alltoall",
           "reduce_scatter", "GradSyncConfig", "init_error_feedback",
           "init_ring_optimizer", "ring_chunk_size", "sync_and_apply",
           "sync_gradients", "sync_gradients_ef", "Mesh", "MeshSpec",
           "axis_groups", "build_mesh", "data_axes"]
