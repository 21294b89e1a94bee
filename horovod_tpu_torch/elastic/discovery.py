"""Host discovery for elastic runs.

The port's copy of ``horovod_tpu/elastic/discovery.py``.

Upstream: horovod/runner/elastic/discovery.py — ``HostDiscoveryScript``
executes a user script whose stdout lists ``hostname:slots`` lines;
``HostManager`` tracks the active host set and a blacklist of hosts that
failed, so they are never assigned ranks again.
"""
from __future__ import annotations

import subprocess
import threading
from collections import OrderedDict

from ..common.logging import logger


class HostUpdateResult:
    NO_UPDATE = 0
    ADDED = 1
    REMOVED = 2
    MIXED = ADDED | REMOVED


class HostDiscovery:
    """Source of the current available hosts."""

    def find_available_hosts_and_slots(self) -> "OrderedDict[str, int]":
        """Return {hostname: slot_count} for every currently usable host."""
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """Runs a user-provided executable; each stdout line is ``host`` or
    ``host:slots`` (reference: discovery.py HostDiscoveryScript)."""

    def __init__(self, discovery_script: str, default_slots: int) -> None:
        self._script = discovery_script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> "OrderedDict[str, int]":
        out = subprocess.check_output(self._script, shell=True).decode()
        hosts: "OrderedDict[str, int]" = OrderedDict()
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                hostname, slots = line.rsplit(":", 1)
                hosts[hostname] = int(slots)
            else:
                hosts[line] = self._default_slots
        return hosts


class FixedHostDiscovery(HostDiscovery):
    """Static host set (used when -H/--hosts is given for an elastic run)."""

    def __init__(self, hosts: "OrderedDict[str, int]") -> None:
        self._hosts = OrderedDict(hosts)

    def find_available_hosts_and_slots(self) -> "OrderedDict[str, int]":
        return OrderedDict(self._hosts)


class HostManager:
    """Tracks available hosts and the blacklist of hosts whose workers
    failed, which are never assigned ranks again (upstream
    discovery.py HostManager).  The reference's blacklist cooldown and
    ``clear_blacklist`` have no caller in either package and are left
    out."""

    def __init__(self, discovery: HostDiscovery) -> None:
        self._discovery = discovery
        self._lock = threading.Lock()
        self._current_hosts: "OrderedDict[str, int]" = OrderedDict()
        self._blacklist: set[str] = set()

    def update_available_hosts(self) -> int:
        """Re-run discovery; return a HostUpdateResult bitmask."""
        discovered = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            usable = OrderedDict((h, s) for h, s in discovered.items()
                                 if h not in self._blacklist)
            prev = set(self._current_hosts)
            cur = set(usable)
            res = HostUpdateResult.NO_UPDATE
            if cur - prev:
                res |= HostUpdateResult.ADDED
            if prev - cur:
                res |= HostUpdateResult.REMOVED
            # Slot-count change on an existing host counts as an update too.
            if res == HostUpdateResult.NO_UPDATE and usable != \
                    self._current_hosts:
                res = HostUpdateResult.MIXED
            self._current_hosts = usable
            return res

    @property
    def current_hosts(self) -> "OrderedDict[str, int]":
        with self._lock:
            return OrderedDict(self._current_hosts)

    def blacklist(self, host: str) -> None:
        """Exclude ``host`` from assignment for the rest of the job."""
        with self._lock:
            if host in self._blacklist:
                return
            logger.warning("blacklisting host %s", host)
            self._blacklist.add(host)
            self._current_hosts.pop(host, None)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            return host in self._blacklist

    @property
    def blacklisted_hosts(self) -> set[str]:
        with self._lock:
            return set(self._blacklist)
