"""Collective data planes of the eager core (the port's copy of
``horovod_tpu/backend/``): ``basic`` (a world of one), ``tcp`` (rings and
trees over sockets) and ``shm`` (same-host shared memory), registered in
priority order; the first enabled one executes each Response.  The
device plane (NCCL for CUDA tensors) is ROADMAP queue A item 9(b) and
the hierarchical plane item 9(a)'s rest."""
from .base import CollectiveBackend, OperationManager

__all__ = ["CollectiveBackend", "OperationManager"]
