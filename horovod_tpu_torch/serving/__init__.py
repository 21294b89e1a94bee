"""serving/ — continuous-batching data-parallel inference serving (the
counterpart of ``horovod_tpu/serving/``).

- :class:`~.queue.RequestQueue` — bounded ingress, SLO deadline stamped
  at the door.
- :class:`~.batcher.ContinuousBatcher` — token-budgeted batch assembly
  that admits new requests into in-flight decode batches.
- :class:`~.admission.AdmissionController` — deadline feasibility and
  load shedding keyed off the live step-time histogram.
- :class:`~.replica.ReplicaExecutor` — the per-rank serve loop:
  broadcast batch plans over a ``torch.distributed`` group (or a world of
  one), KV-cache prefill and greedy decode, dense or paged.
- :class:`~.kvpool.KVBlockPool` — paged KV blocks: free-list allocation
  with refcounts, FNV-chain prefix caching, copy-on-write and LRU
  eviction.
- ``python -m horovod_tpu_torch.serving.loadgen`` — open-loop Poisson SLO
  load harness writing ``SERVE_r{rank}.json``.
"""
from __future__ import annotations

from .admission import AdmissionController
from .batcher import Assignment, BatchPlan, ContinuousBatcher
from .kvpool import KVBlockPool
from .queue import RequestQueue, ServeRequest
from .replica import ReplicaExecutor, ServeConfig

__all__ = [
    "AdmissionController", "Assignment", "BatchPlan",
    "ContinuousBatcher", "KVBlockPool", "ReplicaExecutor",
    "RequestQueue", "ServeConfig", "ServeRequest",
]
