"""Torch collective ops: the surface of ``horovod_tpu/torch/mpi_ops.py``
over the port's eager core.

Every sync, async and in-place variant of allreduce, grouped allreduce,
allgather, broadcast, alltoall and reducescatter, with ``poll``,
``synchronize`` and the gather-based ``sparse_allreduce``.  A tensor goes
to the core as it is, on the CPU or on this rank's card; a CUDA tensor is
never copied to the host.  In-place variants copy the result back into
the caller's tensor at ``synchronize``, in the caller's stream order (the
reference's callback does the same copy, mpi_ops_v2.cc:81-87).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import core
from .. import eager as _eager
from ..core import Handle
from ..eager import Average, size


def _check_device(tensor: torch.Tensor) -> torch.Tensor:
    """The reference's ``_check_cpu``: a tensor on the CPU or on this
    rank's card, detached and contiguous."""
    core.check_device(tensor.device)
    return tensor.detach().contiguous()


def _copy_out(target: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        if target.shape != out.shape:
            target.resize_(out.shape)
        target.copy_(out.to(target.dtype))
    return target


# -- allreduce ---------------------------------------------------------------
def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    compression=None) -> Handle:
    return _eager.allreduce_async(_check_device(tensor), average, name, op,
                                  prescale_factor, postscale_factor,
                                  compression)


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              compression=None) -> torch.Tensor:
    return synchronize(allreduce_async(tensor, average, name, op,
                                       prescale_factor, postscale_factor,
                                       compression))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0) -> Handle:
    handle = _eager.allreduce_async(_check_device(tensor), average, name,
                                    op, prescale_factor, postscale_factor)
    handle.inplace_targets = [tensor]
    return handle


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        prescale_factor, postscale_factor))


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], average=None,
                            name=None, op=None, prescale_factor=1.0,
                            postscale_factor=1.0,
                            compression=None) -> Handle:
    return _eager.grouped_allreduce_async(
        [_check_device(t) for t in tensors], average, name, op,
        prescale_factor, postscale_factor, compression)


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0):
    return synchronize(grouped_allreduce_async(
        tensors, average, name, op, prescale_factor, postscale_factor))


def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0,
                             postscale_factor=1.0) -> Handle:
    handle = _eager.grouped_allreduce_async(
        [_check_device(t) for t in tensors], average, name, op,
        prescale_factor, postscale_factor)
    handle.inplace_targets = list(tensors)
    return handle


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0):
    return synchronize(grouped_allreduce_async_(
        tensors, average, name, op, prescale_factor, postscale_factor))


# -- allgather / broadcast / alltoall / reducescatter ------------------------
def allgather_async(tensor, name=None) -> Handle:
    return _eager.allgather_async(_check_device(tensor), name)


def allgather(tensor, name=None) -> torch.Tensor:
    return synchronize(allgather_async(tensor, name))


def reducescatter_async(tensor, name=None, op=None,
                        prescale_factor=1.0, postscale_factor=1.0) -> Handle:
    """Reduce across ranks, return this rank's dim-0 slice (op=None
    averages, upstream reducescatter semantics)."""
    return _eager.reducescatter_async(_check_device(tensor), name, op,
                                      prescale_factor, postscale_factor)


def reducescatter(tensor, name=None, op=None, prescale_factor=1.0,
                  postscale_factor=1.0) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, name, op,
                                           prescale_factor,
                                           postscale_factor))


def broadcast_async(tensor, root_rank, name=None) -> Handle:
    return _eager.broadcast_async(_check_device(tensor), root_rank, name)


def broadcast(tensor, root_rank, name=None) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name))


def broadcast_async_(tensor, root_rank, name=None) -> Handle:
    handle = _eager.broadcast_async(_check_device(tensor), root_rank, name)
    handle.inplace_targets = [tensor]
    return handle


def broadcast_(tensor, root_rank, name=None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name))


def alltoall_async(tensor, splits=None, name=None) -> Handle:
    handle = _eager.alltoall_async(_check_device(tensor), splits, name)
    handle.wants_recv_splits = splits is not None
    return handle


def alltoall(tensor, splits=None, name=None):
    return synchronize(alltoall_async(tensor, splits, name))


# -- completion --------------------------------------------------------------
def synchronize(handle: Handle):
    """Wait for an async op and return its output(s), on the input's
    device; in-place variants copy back into the original tensors
    (reference: torch/mpi_ops.py:862-884 synchronize)."""
    if handle.inplace_targets:
        handle.wait().raise_if_error()
        outs = [_copy_out(t, e.output)
                for t, e in zip(handle.inplace_targets, handle.entries)]
        return outs[0] if len(outs) == 1 else outs
    out = _eager.synchronize(handle)
    if handle.wants_recv_splits:
        return out, torch.tensor(handle.entries[0].received_splits,
                                 dtype=torch.int32)
    return out


def poll(handle: Handle) -> bool:
    return handle.done()


# -- sparse gradients --------------------------------------------------------
def sparse_allreduce_async(tensor, name=None, op=None):
    """Gather-based sparse reduction (reference: torch/mpi_ops.py:512
    sparse_allreduce_async): allgather every rank's (indices, values) and
    sum duplicates by coalescing.  Returns a callable; ``handle()`` gives
    the reduced sparse tensor."""
    t = (tensor.coalesce() if tensor.is_sparse else tensor.to_sparse()) \
        .coalesce()
    base = name or f"sparse.{id(tensor)}"
    # A variable first dimension: indices travel as [nnz, ndim].
    all_idx = allgather(t.indices().t().contiguous(), name=f"{base}.idx")
    all_val = allgather(t.values().contiguous(), name=f"{base}.val")

    def _resolve():
        out = torch.sparse_coo_tensor(all_idx.t().contiguous(), all_val,
                                      size=t.shape).coalesce()
        if op is None or op is Average:
            out = out / size()
        return out

    return _resolve


def sparse_allreduce(tensor, name=None, op=None):
    return sparse_allreduce_async(tensor, name=name, op=op)()
