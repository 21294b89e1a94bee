"""Worker-side notification plumbing for elastic runs.

The port's copy of ``horovod_tpu/elastic/worker.py``.

Upstream: horovod/runner/elastic/worker.py — the driver pushes host-change
events into running workers; ``State.check_host_updates`` consumes them
between batches and raises :class:`HostsUpdatedInterrupt` so every rank
re-rendezvouses proactively instead of waiting for a collective to fail.
"""
from __future__ import annotations

import os
import threading

from ..common import config
from ..common.logging import logger
from .discovery import HostUpdateResult
from .rpc import SECRET_ENV, RpcClient, RpcServer

DRIVER_ADDR_ENV = "HOROVOD_DRIVER_ADDR"
DRIVER_PORT_ENV = "HOROVOD_DRIVER_PORT"


class _NotificationHandler:
    """RPC surface the driver calls into the worker."""

    def __init__(self, manager: "WorkerNotificationManager") -> None:
        self._manager = manager

    def notify_hosts_updated(self, timestamp: int, update_res: int) -> None:
        self._manager.handle_hosts_updated(timestamp, update_res)

    def ping(self) -> str:
        return "ok"


class WorkerNotificationManager:
    """Process-wide singleton workers use to receive driver events and to
    report lifecycle state (READY/SUCCESS/FAILURE) back to the driver."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._service: RpcServer | None = None
        self._driver: RpcClient | None = None
        self._listeners: list = []
        self._last_timestamp = 0
        self._pending_timestamp = 0
        self._pending_res = HostUpdateResult.NO_UPDATE

    # -- setup -------------------------------------------------------------
    def init(self) -> None:
        """Start the notification service and register with the driver.
        No-op when not launched by an elastic driver."""
        with self._lock:
            if self._service is not None or \
                    DRIVER_ADDR_ENV not in os.environ:
                return
            secret = os.environ.get(SECRET_ENV, "")
            self._service = RpcServer(_NotificationHandler(self), secret)
            self._driver = RpcClient(os.environ[DRIVER_ADDR_ENV],
                                     int(os.environ[DRIVER_PORT_ENV]),
                                     secret)
            hostname = config.HOSTNAME.get() or "localhost"
            local_rank = max(config.LOCAL_RANK.get(), 0)
            self._driver.call("register_worker", hostname, local_rank,
                              self._service.port)
            logger.debug("worker notification service on port %d",
                         self._service.port)

    @property
    def has_driver(self) -> bool:
        return self._driver is not None

    # -- driver-pushed events ---------------------------------------------
    def handle_hosts_updated(self, timestamp: int, update_res: int) -> None:
        with self._lock:
            if timestamp <= self._last_timestamp:
                return
            self._pending_timestamp = max(self._pending_timestamp, timestamp)
            self._pending_res |= update_res
            listeners = list(self._listeners)
        for listener in listeners:
            listener.on_hosts_updated(timestamp, update_res)

    def pending_update(self) -> tuple[int, int]:
        with self._lock:
            return self._pending_timestamp, self._pending_res

    def acknowledge(self, timestamp: int) -> None:
        with self._lock:
            self._last_timestamp = max(self._last_timestamp, timestamp)
            if self._pending_timestamp <= self._last_timestamp:
                self._pending_timestamp = 0
                self._pending_res = HostUpdateResult.NO_UPDATE

    def register_listener(self, listener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def remove_listener(self, listener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    # -- worker → driver lifecycle reports ---------------------------------
    def _slot(self) -> tuple[str, int]:
        return (config.HOSTNAME.get() or "localhost",
                max(config.LOCAL_RANK.get(), 0))

    def record_ready(self) -> None:
        if self._driver is not None:
            host, slot = self._slot()
            self._driver.call("record_ready", host, slot)

    def record_success(self) -> None:
        if self._driver is not None:
            host, slot = self._slot()
            self._driver.call("record_success", host, slot)

    def record_failure(self) -> None:
        if self._driver is not None:
            host, slot = self._slot()
            self._driver.call("record_failure", host, slot)

    def get_assignment(self, min_epoch: int) -> dict:
        """Fetch this slot's rank assignment for the next rendezvous epoch
        (blocking on the driver until one with epoch >= min_epoch exists)."""
        assert self._driver is not None
        host, slot = self._slot()
        return self._driver.call("get_assignment", host, slot, min_epoch)

    def shutdown(self) -> None:
        with self._lock:
            if self._service is not None:
                self._service.close()
                self._service = None
            if self._driver is not None:
                self._driver.close()
                self._driver = None


notification_manager = WorkerNotificationManager()
