"""Collective data planes of the eager core (the port's copy of
``horovod_tpu/backend/``): ``nccl`` (the device plane, for CUDA tensors),
``hierarchical`` (two-level host legs, under the knobs), ``shm``
(same-host shared memory), ``tcp`` (rings and trees over sockets) and
``basic`` (a world of one), registered in that priority order; the first
enabled one executes each Response."""
from .base import CollectiveBackend, OperationManager

__all__ = ["CollectiveBackend", "OperationManager"]
