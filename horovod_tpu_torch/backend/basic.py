"""Single-process (world size 1) backend.

The port's copy of ``horovod_tpu/backend/basic.py`` on torch tensors.
With one rank every collective
degenerates: allreduce = scale-by-factors copy, allgather/broadcast =
identity, alltoall = split passthrough.  A CUDA tensor stays on its
card: the fusion buffer is the card's and the scaling runs there.  This
is the terminal fallback in the priority chain (reference:
operations.cc:143-252).
"""
from __future__ import annotations

from ..common.message import Response
from ..common.status import Status
from ..common.tensor_queue import TensorTableEntry
from .base import CollectiveBackend


class BasicBackend(CollectiveBackend):
    name = "basic"
    # Purely rank-local (no shared wire/protocol state beyond the
    # per-instance fusion buffers core.init builds per stream).
    stream_safe = True

    def __init__(self, size: int = 1) -> None:
        self._size = size
        # Telemetry (no-op when HOROVOD_METRICS=off): single-rank worlds
        # still show their degenerate collectives in the same counters.
        from ..telemetry import metrics as _tm_metrics
        self._m_ops = _tm_metrics().counter(
            "horovod_basic_ops_total",
            "Degenerate single-rank collectives executed locally")

    def enabled(self, response, entries) -> bool:
        return self._size == 1

    def allreduce(self, response: Response,
                  entries: list[TensorTableEntry]) -> Status:
        buf = self.pack_fusion_buffer(response, entries)
        factor = response.prescale_factor * response.postscale_factor
        buf = self.scale_buffer(buf, factor)
        self.unpack_fusion_buffer(buf, response, entries)
        self._m_ops.inc()
        return Status.ok()

    def allgather(self, response, entries) -> Status:
        for e in entries:
            e.output = e.tensor
        return Status.ok()

    def broadcast(self, response, entries) -> Status:
        for e in entries:
            e.output = e.tensor
        return Status.ok()

    def alltoall(self, response, entries) -> Status:
        for e in entries:
            e.output = e.tensor
            e.received_splits = list(e.splits) if e.splits else \
                [e.tensor.shape[0]]
        return Status.ok()

    def reducescatter(self, response, entries) -> Status:
        buf = self.pack_fusion_buffer(response, entries)
        factor = response.prescale_factor * response.postscale_factor
        buf = self.scale_buffer(buf, factor)
        self.unpack_fusion_buffer(buf, response, entries)
        return Status.ok()
