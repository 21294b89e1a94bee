"""The eager Horovod API on torch tensors.

The port's copy of the public API of ``horovod_tpu/__init__.py``: ``init``,
``shutdown``, ``rank``, ``size``, the sync and async forms of
``allreduce``, ``grouped_allreduce``, ``allgather``, ``broadcast``,
``alltoall`` and ``reducescatter``, ``synchronize``, ``poll``,
``barrier``, ``join``, ``broadcast_object``, ``allgather_object``, the
reduce ops and the ``*_built()`` queries.  A collective takes a tensor
on the CPU or on this rank's card (``cuda:<local_rank>``); the result
comes back on the input's device, in its dtype.  A CUDA tensor rides the
NCCL device plane (``HOROVOD_NCCL_OPERATIONS``), or in a world of one
stays on its card; it is never staged through the host, and in a world
of more than one rank without the device plane it raises.  An
allreduce takes ``op=Adasum`` and a wire codec (``compression=``: a name,
``none``/``fp16``/``bf16``/``int8``/``uint4``, or the binding's
``Compression.int8``/``uint4``; default ``HOROVOD_COMPRESSION``).
``run_with_recovery`` runs an idempotent collective under
``HOROVOD_ON_FAILURE`` (raise; retry over rebuilt channels; shrink, which
re-raises for the surrounding ``hvd.elastic.run``), and a dead or wedged
peer surfaces as ``RanksFailedError`` under ``HOROVOD_FAULT_TOLERANCE``.

Start a world with the launcher, ``horovodrun-tpu-torch -np 2 python
train.py`` (``runner/launch.py``; ``--min-np``/``--max-np`` and
``--host-discovery-script`` start the elastic driver), or from Python
with ``hvd.run(fn, np=2)`` (``runner/run_api.py``); each rank then calls
``hvd.init()``.
"""
from __future__ import annotations

import contextlib
import pickle
from typing import Any, Sequence

import numpy as np
import torch

from . import core
from .common.exceptions import (HorovodInternalError, HorovodTpuError,
                                HostsUpdatedInterrupt, RanksFailedError)
from .common.status import Status
from .core import (Handle, cross_rank, cross_size, init, is_homogeneous,
                   is_initialized, local_rank, local_size, rank, shutdown,
                   size, start_timeline, stop_timeline)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous",
    "start_timeline", "stop_timeline", "Handle", "Status",
    "HorovodInternalError", "HorovodTpuError", "HostsUpdatedInterrupt",
    "RanksFailedError", "Sum", "Average", "Adasum", "Min", "Max",
    "allreduce", "allreduce_async", "grouped_allreduce",
    "grouped_allreduce_async", "allgather", "allgather_async", "broadcast",
    "broadcast_async", "alltoall", "alltoall_async", "reducescatter",
    "reducescatter_async", "synchronize", "poll", "barrier", "join",
    "broadcast_object", "allgather_object", "run", "run_with_recovery",
    "start_profiler", "stop_profiler", "profiler_annotation", "tcp_built",
    "gloo_built", "nccl_built", "mpi_built", "mpi_enabled",
    "mpi_threads_supported", "xla_built"]


def run(func, args=(), kwargs=None, np=None, hosts=None, env=None,
        use_gloo=True, start_timeout=120.0, min_np=None, max_np=None,
        host_discovery_script=None, reset_limit=None,
        elastic_timeout=None, slots=None):
    """Run ``func(*args, **kwargs)`` on ``np`` worker processes (or on
    the slots of ``hosts``) and return the results by rank; with
    ``min_np``/``max_np``/``host_discovery_script`` under the elastic
    driver, keyed by final rank (reference: ``horovod_tpu.run``)."""
    from .runner.run_api import run as _run
    return _run(func, args=args, kwargs=kwargs, np=np, hosts=hosts,
                env=env, use_gloo=use_gloo, start_timeout=start_timeout,
                min_np=min_np, max_np=max_np,
                host_discovery_script=host_discovery_script,
                reset_limit=reset_limit, elastic_timeout=elastic_timeout,
                slots=slots)


def run_with_recovery(fn, *, policy=None, max_retries=None,
                      base_backoff=None):
    """Run an idempotent eager collective under HOROVOD_ON_FAILURE
    (raise | retry-with-rebuilt-channels | shrink-via-elastic)."""
    from .resilience import run_with_recovery as _rwr
    return _rwr(fn, policy=policy, max_retries=max_retries,
                base_backoff=base_backoff)


# --- Reduce-op markers (reference: horovod/common/basics.py) ----------------
class _ReduceOp:
    def __init__(self, name: str) -> None:
        self.name = name

    def __repr__(self) -> str:
        return f"hvd.{self.name}"


Sum = _ReduceOp("Sum")
Average = _ReduceOp("Average")
Adasum = _ReduceOp("Adasum")
# Min and Max are upstream Horovod's API; the reference has neither (its
# eager planes reduce by sum only), so they are a feature beyond it, and
# the port refuses them.
Min = _ReduceOp("Min")
Max = _ReduceOp("Max")


def _op_kind(op, average: bool | None) -> tuple[str, bool]:
    """Map (op, legacy average flag) → (sum|average, adasum?)."""
    if average is not None:
        if op is not None and op is not Average and op is not Sum:
            raise ValueError("Cannot specify both op and average")
        return ("average" if average else "sum"), False
    if op is None or op is Average:
        return "average", False
    if op is Sum:
        return "sum", False
    if op is Adasum:
        return "sum", True
    if op is Min or op is Max:
        raise NotImplementedError(
            f"{op} on the eager planes is beyond the reference (ROADMAP "
            f"queue A item 9(a), beyond the reference)")
    raise ValueError(f"Unknown reduce op: {op}")


# --- Output wrapping (reference: _wrap_like, _wrap_int_like) ----------------
def _wrap_like(reference: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The result as a contiguous tensor in the input's dtype, never an
    alias of the caller's input."""
    out = out.contiguous().to(reference.dtype)
    if out.untyped_storage().data_ptr() == \
            reference.untyped_storage().data_ptr():
        out = out.clone()
    return out


def _result(handle: Handle, reference: torch.Tensor) -> torch.Tensor:
    status = handle.wait()
    status.raise_if_error()
    return _wrap_like(reference, handle.entries[0].output)


_name_counters: dict[str, int] = {}


def _auto_name(prefix: str, name: str | None) -> str:
    if name is not None:
        return name
    n = _name_counters.get(prefix, 0)
    _name_counters[prefix] = n + 1
    return f"{prefix}.noname.{n}"


# ---------------------------------------------------------------------------
# Async collectives + handle plumbing (reference: torch/mpi_ops.py:95-900)
# ---------------------------------------------------------------------------
def allreduce_async(tensor: torch.Tensor, average: bool | None = None,
                    name: str | None = None, op=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None) -> Handle:
    kind, adasum = _op_kind(op, average)
    _, handle = core.enqueue_allreduce(
        _auto_name("allreduce", name), tensor, op=kind,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        adasum=adasum, codec=compression)
    handle.wrap_refs = [tensor]
    return handle


def grouped_allreduce_async(tensors: Sequence[torch.Tensor],
                            average: bool | None = None,
                            name: str | None = None, op=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=None) -> Handle:
    kind, adasum = _op_kind(op, average)
    base = _auto_name("grouped_allreduce", name)
    names = [f"{base}.{i}" for i in range(len(tensors))]
    _, handle = core.enqueue_grouped_allreduce(
        names, list(tensors), op=kind, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, adasum=adasum,
        codec=compression)
    handle.wrap_refs = list(tensors)
    return handle


def allgather_async(tensor: torch.Tensor, name: str | None = None) -> Handle:
    _, handle = core.enqueue_allgather(_auto_name("allgather", name), tensor)
    handle.wrap_refs = [tensor]
    return handle


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: str | None = None) -> Handle:
    _, handle = core.enqueue_broadcast(_auto_name("broadcast", name), tensor,
                                       root_rank)
    handle.wrap_refs = [tensor]
    return handle


def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: str | None = None) -> Handle:
    _, handle = core.enqueue_alltoall(_auto_name("alltoall", name), tensor,
                                      splits)
    handle.wrap_refs = [tensor]
    return handle


def reducescatter_async(tensor: torch.Tensor, name: str | None = None,
                        op=None, prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0) -> Handle:
    # op=None averages, matching upstream Horovod's reducescatter default.
    if op in (None, Average):
        op_name = "average"
    elif op is Sum:
        op_name = "sum"
    else:
        raise ValueError(f"Unknown reducescatter op: {op}")
    _, handle = core.enqueue_reducescatter(
        _auto_name("reducescatter", name), tensor, op=op_name,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor)
    handle.wrap_refs = [tensor]
    return handle


def synchronize(handle: Handle):
    """Wait for an async op; return its output(s)
    (reference: torch/mpi_ops.py:862-884)."""
    status = handle.wait()
    status.raise_if_error()
    refs = handle.wrap_refs or [None] * len(handle.entries)
    outs = [e.output if r is None else _wrap_like(r, e.output)
            for r, e in zip(refs, handle.entries)]
    return outs[0] if len(outs) == 1 else outs


def poll(handle: Handle) -> bool:
    """True if the async op has completed."""
    return handle.done()


# ---------------------------------------------------------------------------
# Synchronous collectives
# ---------------------------------------------------------------------------
def allreduce(tensor: torch.Tensor, average: bool | None = None,
              name: str | None = None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              compression=None) -> torch.Tensor:
    handle = allreduce_async(tensor, average, name, op, prescale_factor,
                             postscale_factor, compression)
    return _result(handle, tensor)


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      average: bool | None = None, name: str | None = None,
                      op=None, prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=None) -> list[torch.Tensor]:
    handle = grouped_allreduce_async(tensors, average, name, op,
                                     prescale_factor, postscale_factor,
                                     compression)
    status = handle.wait()
    status.raise_if_error()
    return [_wrap_like(t, e.output)
            for t, e in zip(tensors, handle.entries)]


def allgather(tensor: torch.Tensor, name: str | None = None) -> torch.Tensor:
    return _result(allgather_async(tensor, name), tensor)


def reducescatter(tensor: torch.Tensor, name: str | None = None, op=None,
                  prescale_factor: float = 1.0,
                  postscale_factor: float = 1.0) -> torch.Tensor:
    """Reduce over all ranks and return this rank's dim-0 slice."""
    return _result(reducescatter_async(tensor, name, op, prescale_factor,
                                       postscale_factor), tensor)


def broadcast(tensor: torch.Tensor, root_rank: int,
              name: str | None = None) -> torch.Tensor:
    return _result(broadcast_async(tensor, root_rank, name), tensor)


def alltoall(tensor: torch.Tensor, splits=None, name: str | None = None):
    """The received rows; with ``splits`` also the rows received from each
    rank (an int32 tensor)."""
    handle = alltoall_async(tensor, splits, name)
    status = handle.wait()
    status.raise_if_error()
    entry = handle.entries[0]
    out = _wrap_like(tensor, entry.output)
    if splits is None:
        return out
    return out, torch.tensor(entry.received_splits, dtype=torch.int32)


def barrier() -> None:
    _, handle = core.enqueue_barrier()
    handle.wait().raise_if_error()


def join() -> int:
    """Block until every rank has joined; meanwhile this rank participates
    in outstanding collectives with zero stand-ins
    (reference: torch/mpi_ops.py:885-900)."""
    _, handle = core.enqueue_join()
    handle.wait().raise_if_error()
    return int(handle.entries[0].output)


# ---------------------------------------------------------------------------
# Object sync (reference: torch/functions.py)
# ---------------------------------------------------------------------------
def _bytes_tensor(obj: Any) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(pickle.dumps(obj),
                                          dtype=np.uint8).copy())


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: str | None = None) -> Any:
    """Broadcast an arbitrary picklable object by serializing to bytes."""
    name = _auto_name("broadcast_object", name)
    if rank() == root_rank:
        payload = _bytes_tensor(obj)
        sz = torch.tensor([payload.numel()], dtype=torch.int64)
    else:
        payload = None
        sz = torch.tensor([0], dtype=torch.int64)
    sz = broadcast(sz, root_rank, name=f"{name}.size")
    if payload is None:
        payload = torch.zeros(int(sz[0]), dtype=torch.uint8)
    payload = broadcast(payload, root_rank, name=f"{name}.data")
    return pickle.loads(payload.numpy().tobytes()) \
        if rank() != root_rank else obj


# The trace started by start_profiler, until stop_profiler writes it.
_profiler = None


def start_profiler(logdir: str) -> None:
    """Start a trace of the host and the card (reference analogue: the
    Horovod Timeline and NVTX ranges): ``torch.profiler`` with CPU and,
    where there is a card, CUDA activity; ``stop_profiler`` writes it
    into ``logdir`` as TensorBoard's trace plugin reads it
    (``tensorboard_trace_handler``).  One trace at a time."""
    global _profiler
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    if _profiler is not None:
        raise RuntimeError("a profile is already being taken; "
                           "stop_profiler() it first")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    _profiler = prof


def stop_profiler() -> None:
    """Stop the trace of ``start_profiler`` and write it."""
    global _profiler
    if _profiler is None:
        raise RuntimeError("no profile started")
    prof, _profiler = _profiler, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def profiler_annotation(name: str):
    """Label a region in traces (reference: common/nvtx_op_range.h): a
    ``torch.profiler.record_function`` range and, where there is a card,
    an NVTX range of the same name."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def allgather_object(obj: Any, name: str | None = None) -> list:
    """Gather one arbitrary picklable object per rank; every rank receives
    the full list ordered by rank."""
    name = _auto_name("allgather_object", name)
    payload = _bytes_tensor(obj)
    sizes = allgather(torch.tensor([payload.numel()], dtype=torch.int64),
                      name=f"{name}.size")
    data = allgather(payload, name=f"{name}.data").numpy()
    objs, offset = [], 0
    for sz in sizes.reshape(-1).tolist():
        objs.append(pickle.loads(data[offset:offset + sz].tobytes()))
        offset += sz
    return objs


# Build-variant introspection (reference: horovod/common/util.py:137-186)
def tcp_built() -> bool:
    return True


def gloo_built() -> bool:   # compat alias: the TCP plane plays gloo's role
    return True


def nccl_built() -> bool:
    """True where torch.distributed has NCCL, the device plane's
    transport."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_nccl_available()


def xla_built() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False
