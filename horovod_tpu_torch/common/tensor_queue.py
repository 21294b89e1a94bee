"""Pending-tensor table + request queue shared with the background thread.

The port's copy of ``horovod_tpu/common/tensor_queue.py``.

Reference: horovod/common/tensor_queue.{cc,h}:28-65.  Semantics preserved:
duplicate tensor names are rejected while an op is in flight
(DUPLICATE_NAME_ERROR, common.h:169-172), and `finalize` fails every pending
entry with ABORTED at shutdown so callers never hang
(reference: operations.cc:571 FinalizeTensorQueue).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from .message import Request
from .status import Status

DUPLICATE_NAME_ERROR = (
    "Requested to collect a tensor with the same name as another tensor that "
    "is currently being processed. If you want to request another tensor, use "
    "a different tensor name.")


@dataclass
class TensorTableEntry:
    """One queued collective operand (reference: common.h:252-281)."""
    tensor_name: str
    tensor: Any = None                     # torch tensor payload
    output: Any = None                     # filled by the backend
    root_rank: int = -1
    device: int = -1                       # CUDA index, -1 on the CPU
    callback: Callable[[Status], None] | None = None
    # Alltoall split sizes along dim 0 (reference: common.h splits field).
    splits: list[int] = field(default_factory=list)
    received_splits: list[int] = field(default_factory=list)
    context: Any = None                    # framework op context (allocator)
    # Cross-rank trace id ("cycle.seq") of the response this entry rode,
    # stamped at pop by core so Timeline sub-activity spans and the
    # flight recorder can correlate one collective across ranks
    # (telemetry/trace.py); None until dispatched.
    trace: str | None = None
    # Absolute monotonic deadline propagated from the enqueuing thread
    # (resilience.deadline_scope — serving per-request SLOs); the
    # dispatch thread re-raises it through op_scope so transport waits
    # of this op are bounded by the SLO, not the full fault window.
    deadline: float | None = None
    # CUDA tensors only: recorded on the enqueuing thread's stream (the
    # plane waits on it before it reads the tensor), and on the plane's
    # stream once the output is written (the caller's stream waits on it
    # before it reads the output).
    ready_event: Any = None
    done_event: Any = None

    def finish(self, status: Status) -> None:
        cb, self.callback = self.callback, None
        if cb is not None:
            cb(status)


class TensorQueue:
    def __init__(self) -> None:
        self._mutex = threading.Lock()
        self._table: dict[str, TensorTableEntry] = {}
        self._queue: list[Request] = []
        self._finalized = False
        # Pulses on enqueue so the background loop can wake immediately
        # instead of finishing its cycle sleep (single-op latency); the
        # loop still applies a short batching grace so gradient bursts
        # keep fusing (the reason the reference holds a fixed cadence).
        self._work = threading.Event()

    def add_to_tensor_queue(self, entry: TensorTableEntry, request: Request) -> Status:
        return self.add_to_tensor_queue_multi([entry], [request])

    def add_to_tensor_queue_multi(
            self, entries: list[TensorTableEntry],
            requests: list[Request]) -> Status:
        with self._mutex:
            if self._finalized:
                return Status.aborted("Horovod has been shut down.")
            for e in entries:
                if e.tensor_name in self._table:
                    return Status.invalid_argument(DUPLICATE_NAME_ERROR)
            for e, r in zip(entries, requests):
                self._table[e.tensor_name] = e
                self._queue.append(r)
            self._work.set()
        return Status.ok()

    def pending_names(self) -> list[str]:
        """Names of every entry still in the tensor table — the set a
        poison ERROR response must cover so no local waiter is left
        hanging when the world aborts (resilience/)."""
        with self._mutex:
            return list(self._table)

    def wait_for_work(self, timeout: float) -> bool:
        """Block up to ``timeout`` seconds for an enqueue pulse; returns
        True if work arrived.  Resubmissions via push_back_to_queue do
        NOT pulse — they are next-cycle work by design."""
        if timeout <= 0:
            return self._work.is_set()
        fired = self._work.wait(timeout)
        self._work.clear()
        return fired

    def pop_messages_from_queue(self) -> list[Request]:
        with self._mutex:
            msgs, self._queue = self._queue, []
            return msgs

    def get_tensor_entry(self, name: str) -> TensorTableEntry:
        with self._mutex:
            return self._table[name]

    def has_tensor_entry(self, name: str) -> bool:
        with self._mutex:
            return name in self._table

    def get_tensor_entries(self, names: list[str]) -> list[TensorTableEntry]:
        """Remove and return entries for a finalized response."""
        with self._mutex:
            return [self._table.pop(n) for n in names]

    def pop_tensor_entry(self, name: str) -> TensorTableEntry:
        with self._mutex:
            return self._table.pop(name)

    def push_back_to_queue(self, request: Request) -> None:
        with self._mutex:
            self._queue.append(request)

    def remove_joined_tensor(self, name: str) -> None:
        with self._mutex:
            self._table.pop(name, None)

    def size(self) -> int:
        with self._mutex:
            return len(self._table)

    def finalize(self) -> None:
        """Abort everything still pending (reference: tensor_queue.cc
        FinalizeTensorQueue)."""
        with self._mutex:
            self._finalized = True
            entries = list(self._table.values())
            self._table.clear()
            self._queue.clear()
        aborted = Status.aborted("Horovod has been shut down.")
        for e in entries:
            e.finish(aborted)

    def reset(self) -> None:
        with self._mutex:
            self._finalized = False
            self._table.clear()
            self._queue.clear()
