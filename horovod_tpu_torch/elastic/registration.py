"""Worker-state barrier for elastic rendezvous rounds.

The port's copy of ``horovod_tpu/elastic/registration.py``.

Upstream: horovod/runner/elastic/registration.py — ``WorkerStateRegistry``
collects READY / SUCCESS / FAILURE records from workers per rendezvous round;
when every live worker has reported, it triggers the driver's ``resume`` (on
failure or host change) or marks the job finished.
"""
from __future__ import annotations

import threading
from collections import defaultdict

from ..common.logging import logger

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, driver, host_manager, reset_limit: int | None = None,
                 verbose: bool = False) -> None:
        self._driver = driver
        self._host_manager = host_manager
        self._reset_limit = reset_limit
        self._verbose = verbose
        self._lock = threading.Lock()
        self._states: dict[str, str] = {}
        self._workers: dict[str, set[str]] = defaultdict(set)
        self._rendezvous_id = 0
        self._size = 0
        self._expected: set[str] | None = None
        self._round_complete = False

    @property
    def rendezvous_id(self) -> int:
        return self._rendezvous_id

    def get_recorded_slots(self) -> list[str]:
        with self._lock:
            return list(self._states)

    def get(self, state: str) -> list[str]:
        with self._lock:
            return sorted(self._workers.get(state, set()))

    def count(self, state: str) -> int:
        with self._lock:
            return len(self._workers.get(state, set()))

    def reset(self, size: int, expected_slots=None) -> None:
        """Start a new rendezvous round expecting ``size`` workers.

        ``expected_slots``: optional iterable of "host[slot]" keys; records
        for any other slot (e.g. a long-dead worker on a host removed in an
        earlier round) are ignored so they cannot complete the round
        barrier prematurely."""
        with self._lock:
            logger.debug("registry reset: size=%d round=%d", size,
                         self._rendezvous_id)
            self._states.clear()
            self._workers.clear()
            self._size = size
            self._expected = set(expected_slots) \
                if expected_slots is not None else None
            self._rendezvous_id += 1
            self._round_complete = False

    def size(self) -> int:
        with self._lock:
            return self._size

    def last_rendezvous(self) -> int:
        return self._rendezvous_id

    def record_ready(self, host: str, slot: int,
                     round_id: int | None = None) -> int:
        return self._record_state(host, slot, READY, round_id)

    def record_success(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, SUCCESS)

    def record_failure(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, FAILURE)

    def _record_state(self, host: str, slot: int, state: str,
                      round_id: int | None = None) -> int:
        if self._driver.finished():
            return self._rendezvous_id
        if state == FAILURE:
            # A failed worker taints its host for future assignment rounds.
            self._host_manager.blacklist(host)

        key = f"{host}[{slot}]"
        fire = False
        with self._lock:
            if round_id is not None and round_id != self._rendezvous_id:
                # The record targeted a round that already resolved (the
                # caller re-checks the epoch); dropping it prevents a READY
                # from leaking into the NEXT round's barrier.
                return self._rendezvous_id
            if self._expected is not None and key not in self._expected:
                logger.debug("ignoring %s record for %s: not part of "
                             "round %d", state, key, self._rendezvous_id)
                return self._rendezvous_id
            cur = self._states.get(key)
            if cur is None:
                self._states[key] = state
                self._workers[state].add(key)
            elif cur != state and state != READY:
                # A failure/success overrides a prior READY (worker died or
                # finished after declaring readiness); READY never downgrades.
                logger.debug("%s: state %s -> %s", key, cur, state)
                self._workers[cur].discard(key)
                self._states[key] = state
                self._workers[state].add(key)
            rendezvous_id = self._rendezvous_id
            if not self._round_complete and len(self._states) >= self._size:
                self._round_complete = True
                fire = True
        if fire:
            self._on_workers_recorded()
        return rendezvous_id

    def _on_workers_recorded(self) -> None:
        logger.debug("all %d workers recorded", self._size)
        if self.count(SUCCESS) == self._size:
            logger.info("all workers succeeded; job complete")
            self._driver.stop()
            return
        if self._driver.finished():
            return
        if self.count(FAILURE) > 0 and self._reset_limit is not None and \
                self._rendezvous_id >= self._reset_limit:
            logger.error(
                "reset limit %d reached; terminating job", self._reset_limit)
            self._driver.set_reset_limit_exceeded()
            self._driver.stop()
            return
        # Otherwise a new rendezvous round is wanted: either a host change
        # (all READY) or a failure with budget remaining.
        self._driver.resume()
