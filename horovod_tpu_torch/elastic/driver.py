"""The elastic driver: discovery polling, stable rank assignment, worker
lifecycle, and rendezvous-round formation.

The port's copy of ``horovod_tpu/elastic/driver.py``.

Upstream: horovod/runner/elastic/driver.py — a discovery thread re-runs the
user's host script (default every 1s), diffs the host set, notifies running
workers; rank assignments preserve existing placements where possible; failed
workers blacklist their host and trigger a resume on the surviving set.

Round protocol (TPU rebuild, replaces the reference's HTTP rendezvous
handler): the driver owns a monotonically increasing **epoch**.  Workers call
``get_assignment(host, slot, min_epoch)``:

- ``min_epoch <= current``: returns the current round's assignment (initial
  join);
- ``min_epoch > current``: counts as a READY record for that slot; the call
  blocks until a new round forms, which happens when every slot of the
  current round has recorded READY / SUCCESS / FAILURE.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from ..common.logging import logger
from ..runner.hosts import (HostInfo, SlotInfo, get_host_assignments,
                            host_ids_env)
from .discovery import HostManager, HostUpdateResult
from .registration import WorkerStateRegistry
from .rpc import RpcClient
from .worker import SECRET_ENV  # noqa: F401  (re-export convenience)

DISCOVERY_INTERVAL_SECS = 1.0


class ElasticDriver:
    def __init__(self, discovery, min_np: int, max_np: int | None = None,
                 timeout: float = 600.0, reset_limit: int | None = None,
                 secret: str = "", verbose: bool = False) -> None:
        self._host_manager = HostManager(discovery)
        self._min_np = min_np
        self._max_np = max_np
        self._timeout = timeout
        self._secret = secret
        self._verbose = verbose
        self.registry = WorkerStateRegistry(self, self._host_manager,
                                            reset_limit=reset_limit)

        self._lock = threading.Lock()
        self._round_cond = threading.Condition(self._lock)
        self._epoch = 0
        self._notify_clock = 0
        self._assignments: dict[tuple[str, int], SlotInfo] = {}
        self._host_order: list[str] = []
        self._running: set[tuple[str, int]] = set()
        self._results: dict[str, tuple[int, float]] = {}
        self._workers: dict[tuple[str, int], RpcClient] = {}

        # Autoscale target (statesync/autoscale.py): caps the slots the
        # next round assigns.  None = no cap beyond max_np.
        self._target_np: int | None = None

        self._finished = threading.Event()
        self._shutdown = threading.Event()
        self._reset_limit_exceeded = False
        self._resume_failed = False
        self._create_worker_fn: Callable[[SlotInfo], int] | None = None
        self._discovery_thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def start(self, np: int,
              create_worker_fn: Callable[[SlotInfo], int]) -> None:
        """Form the first round with ``np`` target slots and spawn workers.
        ``create_worker_fn(slot_info)`` must block until the worker process
        exits and return its exit code (run per-slot in a thread)."""
        self._create_worker_fn = create_worker_fn
        self.wait_for_available_slots(self._min_np)
        self._form_round()
        self._discovery_thread = threading.Thread(
            target=self._discover_hosts, daemon=True, name="hvd-discovery")
        self._discovery_thread.start()

    def wait_for_available_slots(self, min_np: int) -> None:
        deadline = time.monotonic() + self._timeout
        while True:
            self._host_manager.update_available_hosts()
            avail = sum(self._host_manager.current_hosts.values())
            if avail >= min_np:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {avail}/{min_np} slots became available within "
                    f"{self._timeout}s")
            time.sleep(DISCOVERY_INTERVAL_SECS)

    def stop(self) -> None:
        self._finished.set()
        with self._round_cond:
            self._round_cond.notify_all()
        # Reap the discovery loop (hvdlife HVD701): _finished is its
        # wakeup (the loop polls it every DISCOVERY_INTERVAL_SECS).
        # stop() can be invoked from the discovery thread itself on the
        # failed-resume path — never self-join.
        t = self._discovery_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=DISCOVERY_INTERVAL_SECS + 5.0)
            self._discovery_thread = None

    def finished(self) -> bool:
        return self._finished.is_set()

    def set_reset_limit_exceeded(self) -> None:
        self._reset_limit_exceeded = True

    @property
    def reset_limit_exceeded(self) -> bool:
        return self._reset_limit_exceeded

    @property
    def resume_failed(self) -> bool:
        """True when a mid-job resume could not re-form a round (e.g. too
        few surviving slots) — the job ended abnormally even if some
        workers exited 0."""
        return self._resume_failed

    def join(self, timeout: float | None = None) -> bool:
        return self._finished.wait(timeout)

    def wait_for_workers_exit(self, timeout: float = 30.0) -> None:
        """Drain live worker processes after the job finishes.  The
        registry marks the job complete on the workers' SUCCESS RPC, which
        arrives BEFORE their processes exit — collecting results without
        draining would miss the successful exit codes."""
        deadline = time.time() + timeout
        while self._running and time.time() < deadline:
            time.sleep(0.05)

    def shutdown(self) -> None:
        self.stop()
        self._shutdown.set()
        for client in self._workers.values():
            client.close()

    def get_results(self) -> dict[str, tuple[int, float]]:
        return dict(self._results)

    def world_size(self) -> int:
        """Size of the most recently formed world (0 before any round)."""
        return len(self._assignments)

    @property
    def current_epoch(self) -> int:
        """Epoch of the most recently formed round."""
        with self._round_cond:
            return self._epoch

    def set_target_np(self, n: int) -> None:
        """Autoscale hook (statesync/autoscale.py): cap the slots the
        NEXT round assigns to ``n`` (clamped to [min_np, max_np]).  The
        running round is untouched — the target applies when discovery
        changes or a resume re-forms the world."""
        n = max(int(n), self._min_np)
        if self._max_np is not None:
            n = min(n, self._max_np)
        with self._round_cond:
            self._target_np = n

    def target_np(self) -> int | None:
        with self._round_cond:
            return self._target_np

    def final_slots(self) -> dict[int, str]:
        """rank -> "host[local_rank]" of the most recently formed round."""
        with self._round_cond:
            return {s.rank: f"{s.hostname}[{s.local_rank}]"
                    for s in self._assignments.values()}

    def rank_to_slot(self) -> dict[int, "SlotInfo"]:
        """rank -> SlotInfo of the most recently formed round — the
        lookup the resilience shrink policy uses to map a
        RanksFailedError's failed-rank set onto hosts to blacklist
        (resilience/policy.py apply_shrink)."""
        with self._round_cond:
            return {s.rank: s for s in self._assignments.values()}

    # ------------------------------------------------------------------
    # Round formation / rank assignment
    # ------------------------------------------------------------------
    def _ordered_hosts(self) -> list[HostInfo]:
        """Current hosts in seniority order: hosts that already hold ranks
        keep their position; new hosts append (reference: driver.py
        _update_host_assignments rank-preservation)."""
        current = self._host_manager.current_hosts
        order = [h for h in self._host_order if h in current]
        order.extend(h for h in current if h not in order)
        self._host_order = order
        return [HostInfo(hostname=h, slots=current[h]) for h in order]

    def _form_round(self) -> None:
        """Compute assignments for the current host set and open a new
        epoch.  Called at start and whenever a round completes."""
        with self._round_cond:
            hosts = self._ordered_hosts()
            max_np = self._max_np if self._target_np is None \
                else self._target_np
            slots = get_host_assignments(hosts, self._min_np, max_np)
            self._assignments = {(s.hostname, s.local_rank): s
                                 for s in slots}
            self._epoch += 1
            self.registry.reset(len(slots),
                                expected_slots=[
                                    f"{s.hostname}[{s.local_rank}]"
                                    for s in slots])
            logger.info("elastic round %d: %d slots on %s", self._epoch,
                        len(slots), ",".join(h.hostname for h in hosts))
            self._round_cond.notify_all()
        # Spawn processes for slots that have no live worker.
        for key, slot in list(self._assignments.items()):
            if key not in self._running:
                self._launch_worker(slot)

    def resume(self) -> None:
        """Form a new round on the surviving host set (called by the
        registry when the current round fully resolves)."""
        if self.finished():
            return
        try:
            self.wait_for_available_slots(self._min_np)
            self._form_round()
        except (TimeoutError, ValueError) as exc:
            logger.error("cannot resume elastic job: %s", exc)
            self._resume_failed = True
            self.stop()

    def _launch_worker(self, slot: SlotInfo) -> None:
        key = (slot.hostname, slot.local_rank)
        self._running.add(key)

        def _run() -> None:
            try:
                exit_code = self._create_worker_fn(slot)
            except Exception as exc:  # noqa: BLE001 - spawn failure
                logger.error("worker %s[%d] spawn failed: %s",
                             slot.hostname, slot.local_rank, exc)
                exit_code = 1
            self._running.discard(key)
            self._handle_worker_exit(slot, exit_code)

        threading.Thread(target=_run, daemon=True,
                         name=f"hvd-worker-{slot.hostname}-"
                              f"{slot.local_rank}").start()

    def _handle_worker_exit(self, slot: SlotInfo, exit_code: int) -> None:
        name = f"{slot.hostname}[{slot.local_rank}]"
        self._results[name] = (exit_code, time.time())
        if self.finished():
            return
        if exit_code == 0:
            self.registry.record_success(slot.hostname, slot.local_rank)
        else:
            logger.warning("worker %s exited with code %d", name, exit_code)
            self.registry.record_failure(slot.hostname, slot.local_rank)

    # ------------------------------------------------------------------
    # RPC surface (called by workers through RpcServer)
    # ------------------------------------------------------------------
    def register_worker(self, host: str, slot: int, port: int) -> None:
        """Worker announces its notification service endpoint."""
        try:
            client = RpcClient(host, port, self._secret)
        except OSError as exc:
            logger.warning("cannot connect to worker %s[%d]: %s",
                           host, slot, exc)
            return
        self._workers[(host, slot)] = client

    def record_ready(self, host: str, slot: int) -> None:
        self.registry.record_ready(host, slot)

    def record_success(self, host: str, slot: int) -> None:
        self.registry.record_success(host, slot)

    def record_failure(self, host: str, slot: int) -> None:
        self.registry.record_failure(host, slot)

    def get_assignment(self, host: str, slot: int,
                       min_epoch: int) -> dict | None:
        """Return this slot's assignment once ``epoch >= min_epoch`` (and
        >= 1).  Asking beyond the current epoch records READY.  Returns
        None when the slot is not part of the new round (worker exits)."""
        with self._round_cond:
            current = self._epoch
        if min_epoch > current:
            # Record READY outside the round lock (the registry may resume()
            # synchronously, and _form_round re-acquires the lock), but
            # bound to the round it targets: if the round resolves between
            # the epoch read and the record, the registry drops it so the
            # stale READY cannot pre-complete the NEXT round's barrier.
            self.registry.record_ready(host, slot, round_id=current)
        deadline = time.monotonic() + self._timeout
        with self._round_cond:
            while self._epoch < max(min_epoch, 1) and not self.finished():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no rendezvous round >= {min_epoch} formed within "
                        f"{self._timeout}s")
                self._round_cond.wait(timeout=min(remaining, 1.0))
            if self.finished():
                return None
            info = self._assignments.get((host, slot))
            if info is None:
                return None
            return {
                "rank": info.rank, "size": info.size,
                "local_rank": info.local_rank,
                "local_size": info.local_size,
                "cross_rank": info.cross_rank,
                "cross_size": info.cross_size,
                "epoch": self._epoch,
                "notify_ts": self._notify_clock,
                "hostname": info.hostname,
                # Whole-round rank→host map: rounds formed on uneven
                # slots-per-host break the homogeneous layout that
                # local/cross-size topology auto-detection assumes, so the
                # worker feeds this into topology.resolve(hosts=...).
                "host_ids": host_ids_env(list(self._assignments.values())),
            }

    # ------------------------------------------------------------------
    # Discovery thread
    # ------------------------------------------------------------------
    def _discover_hosts(self) -> None:
        while not self._finished.is_set():
            try:
                res = self._host_manager.update_available_hosts()
            except Exception as exc:  # noqa: BLE001 - discovery script error
                logger.warning("host discovery failed: %s", exc)
                res = HostUpdateResult.NO_UPDATE
            if res != HostUpdateResult.NO_UPDATE:
                self._notify_workers_host_changes(res)
            self._finished.wait(DISCOVERY_INTERVAL_SECS)

    def _notify_workers_host_changes(self, update_res: int) -> None:
        with self._lock:
            self._notify_clock += 1
            timestamp = self._notify_clock
        logger.info("host changes detected (res=%d, ts=%d); notifying "
                    "workers", update_res, timestamp)
        for key, client in list(self._workers.items()):
            try:
                client.call("notify_hosts_updated", timestamp, update_res)
            except Exception:  # noqa: BLE001 - worker may be gone
                self._workers.pop(key, None)
