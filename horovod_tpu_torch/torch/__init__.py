"""horovod_tpu_torch.torch: the torch binding, on the port's eager core.

The counterpart of ``horovod_tpu/torch/`` (upstream Horovod's
``horovod.torch``), with the same ``__all__``:

    import horovod_tpu_torch.torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

Tensors go to the core as they are: on the CPU they ride the TCP and shm
planes, on this rank's card the NCCL device plane, and a CUDA tensor is
never copied to the host.  ``DistributedOptimizer(op=Adasum)`` is the
Adasum delta optimizer, and ``Compression.int8``/``uint4`` quantize on the
planes.  ``horovod_tpu_torch.torch.elastic`` holds ``TorchState`` for
``hvd.elastic.run``.
"""
from ..core import (cross_rank, cross_size, init, is_homogeneous,
                    is_initialized, local_rank, local_size, rank, shutdown,
                    size, start_timeline, stop_timeline)
from ..eager import (Adasum, Average, HorovodInternalError,
                     HostsUpdatedInterrupt, Sum, barrier, broadcast_object,
                     join)
from .compression import Compression
from .functions import broadcast_optimizer_state, broadcast_parameters
from .mpi_ops import (allgather, allgather_async, allreduce, allreduce_,
                      allreduce_async, allreduce_async_, alltoall,
                      alltoall_async, broadcast, broadcast_,
                      broadcast_async, broadcast_async_, grouped_allreduce,
                      grouped_allreduce_, grouped_allreduce_async,
                      grouped_allreduce_async_, poll, reducescatter,
                      reducescatter_async, sparse_allreduce,
                      sparse_allreduce_async, synchronize)
from .optimizer import DistributedOptimizer
from .sync_batch_norm import SyncBatchNorm

__all__ = [
    "Adasum", "Average", "Sum", "Compression", "DistributedOptimizer",
    "SyncBatchNorm", "allgather", "allgather_async", "allreduce",
    "allreduce_", "allreduce_async", "allreduce_async_", "alltoall",
    "alltoall_async", "barrier", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "broadcast_object",
    "broadcast_optimizer_state", "broadcast_parameters", "cross_rank",
    "cross_size", "grouped_allreduce", "grouped_allreduce_",
    "grouped_allreduce_async", "grouped_allreduce_async_", "init",
    "is_homogeneous", "is_initialized", "join", "local_rank", "local_size",
    "poll", "rank", "reducescatter", "reducescatter_async", "shutdown",
    "size", "start_timeline", "stop_timeline",
    "synchronize", "HorovodInternalError", "HostsUpdatedInterrupt",
]
