"""Stalled-collective detector.

The port's copy of ``horovod_tpu/common/stall_inspector.py``.

Reference: horovod/common/stall_inspector.{cc,h}:30-96.  When some ranks have
submitted a tensor and others have not for `HOROVOD_STALL_CHECK_TIME_SECONDS`
(default 60s), the coordinator logs which ranks are missing; past
`HOROVOD_STALL_SHUTDOWN_TIME_SECONDS` it aborts the job.  This is the
slow-failure detector that turns silent hangs into actionable errors.
"""
from __future__ import annotations

import time

from . import config
from .logging import logger


class StallInspector:
    def __init__(self) -> None:
        self.warning_time = float(config.STALL_CHECK_TIME_SECONDS.get())
        self.shutdown_time = float(config.STALL_SHUTDOWN_TIME_SECONDS.get())
        self.enabled = not config.STALL_CHECK_DISABLE.get()
        # Coordinator side: tensor name -> (first-seen time, ranks that
        # submitted it so far).
        self._ready: dict[str, tuple[float, set[int]]] = {}
        # Worker side: tensor name -> time submitted locally (for cached
        # tensors that never reach the coordinator).
        self._uncached: dict[str, float] = {}
        self._last_check = time.monotonic()

    # --- coordinator bookkeeping -------------------------------------------
    def record_uncached_tensor(self, name: str, rank: int) -> None:
        now = time.monotonic()
        first, ranks = self._ready.get(name, (now, set()))
        ranks.add(rank)
        self._ready[name] = (first, ranks)

    def remove_uncached_tensor(self, name: str) -> None:
        self._ready.pop(name, None)

    # --- worker-side cached-tensor bookkeeping -----------------------------
    def record_cached_tensor(self, name: str) -> None:
        self._uncached.setdefault(name, time.monotonic())

    def remove_cached_tensor(self, name: str) -> None:
        self._uncached.pop(name, None)

    def invalidate_stalled_cached_tensors(self, cache_coordinator,
                                          response_cache) -> None:
        """Mark cache bits invalid for tensors stalled on this rank so that
        the coordinated OR forces a full (re-)negotiation and the coordinator
        regains visibility (reference: controller.cc:125-135)."""
        if not self.enabled:
            return
        now = time.monotonic()
        for name, t0 in self._uncached.items():
            if now - t0 > self.warning_time:
                try:
                    pos = response_cache.peek_cache_position(name)
                except KeyError:
                    continue
                cache_coordinator.record_invalid(pos)
                cache_coordinator.uncached_in_queue = True

    def should_check(self) -> bool:
        if not self.enabled:
            return False
        return time.monotonic() - self._last_check > self.warning_time

    def check_for_stalled_tensors(self, global_size: int) -> bool:
        """Coordinator check. Returns True if the job should shut down."""
        self._last_check = time.monotonic()
        now = self._last_check
        should_shutdown = False
        for name, (first, ranks) in self._ready.items():
            lag = now - first
            if lag <= self.warning_time:
                continue
            missing = sorted(set(range(global_size)) - ranks)
            logger.warning(
                "One or more tensors were submitted to be reduced, gathered "
                "or broadcasted by subset of ranks and are waiting for "
                "remainder of ranks for more than %ds. Stalled op: %s "
                "[missing ranks: %s]. If the missing ranks are alive, they "
                "are likely submitting different collectives.",
                int(self.warning_time), name,
                ", ".join(map(str, missing)))
            if self.shutdown_time > 0 and lag > self.shutdown_time:
                should_shutdown = True
        return should_shutdown
