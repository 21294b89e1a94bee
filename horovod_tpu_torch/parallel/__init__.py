"""Parallelism of the port: the mesh, collectives, gradient sync,
parameter sharding rules, and sequence and pipeline parallelism."""
from .collectives import (adasum_allreduce, allgather, allreduce, alltoall,
                          broadcast, ppermute, reduce_scatter)
from .grad_sync import (GradSyncConfig, init_error_feedback,
                        init_ring_optimizer, ring_chunk_size, sync_and_apply,
                        sync_gradients, sync_gradients_ef)
from .mesh import (DEFAULT_AXES, Mesh, MeshSpec, axis_groups, axis_size,
                   build_mesh, data_axes, global_batch)
from .pipeline import pipeline_apply
from .sharding import (P, ShardingRules, constrain, gather_params,
                       named_sharding, replicated, shard_params)
from .ring_attention import local_attention, ring_attention
from .ulysses import ulysses_attention

__all__ = ["adasum_allreduce", "allgather", "allreduce", "alltoall",
           "broadcast", "ppermute", "reduce_scatter", "GradSyncConfig",
           "init_error_feedback", "init_ring_optimizer", "ring_chunk_size",
           "sync_and_apply", "sync_gradients", "sync_gradients_ef",
           "DEFAULT_AXES", "Mesh", "MeshSpec", "axis_groups", "axis_size",
           "build_mesh", "data_axes", "global_batch", "pipeline_apply",
           "P", "ShardingRules", "shard_params", "gather_params",
           "named_sharding", "constrain", "replicated",
           "local_attention", "ring_attention", "ulysses_attention"]
