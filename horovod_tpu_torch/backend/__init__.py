"""Collective data planes of the eager core (the port's copy of
``horovod_tpu/backend/``): ``nccl`` (the device plane, for CUDA tensors),
``shm`` (same-host shared memory), ``tcp`` (rings and trees over
sockets) and ``basic`` (a world of one), registered in that priority
order; the first enabled one executes each Response.  The hierarchical
plane is ROADMAP queue A item 9(a)'s rest."""
from .base import CollectiveBackend, OperationManager

__all__ = ["CollectiveBackend", "OperationManager"]
