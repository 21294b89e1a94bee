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
import time
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
    """Tracks available hosts and the blacklist (upstream discovery.py
    HostManager).

    Unlike upstream Horovod, the blacklist is not one-way for the life
    of the driver: an entry can carry a cooldown (preempted cloud hosts
    routinely come back) and can be cleared manually
    (``clear_blacklist``).  A host whose entry expires
    or is cleared re-enters discovery on the next update with its
    CURRENT slot count — the discovery script's answer is authoritative,
    so a host that returned smaller or larger is assigned accordingly,
    never from a stale remembered count."""

    def __init__(self, discovery: HostDiscovery,
                 blacklist_cooldown: float | None = None) -> None:
        self._discovery = discovery
        self._lock = threading.Lock()
        self._current_hosts: "OrderedDict[str, int]" = OrderedDict()
        # host -> expiry (monotonic seconds; inf = until cleared).
        self._blacklist: dict[str, float] = {}
        self._default_cooldown = blacklist_cooldown

    def _expire_blacklist_locked(self) -> bool:
        now = time.monotonic()
        expired = [h for h, t in self._blacklist.items() if t <= now]
        for h in expired:
            logger.warning("blacklist for host %s expired; it may "
                           "re-enter discovery", h)
            del self._blacklist[h]
        return bool(expired)

    def update_available_hosts(self) -> int:
        """Re-run discovery; return a HostUpdateResult bitmask."""
        discovered = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            self._expire_blacklist_locked()
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

    def blacklist(self, host: str, cooldown: float | None = None) -> None:
        """Exclude ``host`` from assignment.  ``cooldown`` seconds (or
        the manager default) bound the exclusion; None on both means
        until :meth:`clear_blacklist`."""
        if cooldown is None:
            cooldown = self._default_cooldown
        expiry = float("inf") if cooldown is None \
            else time.monotonic() + float(cooldown)
        with self._lock:
            if self._blacklist.get(host, 0.0) >= expiry:
                return
            logger.warning(
                "blacklisting host %s%s", host,
                "" if cooldown is None else f" for {cooldown:g}s")
            self._blacklist[host] = expiry
            self._current_hosts.pop(host, None)

    def clear_blacklist(self, host: str) -> bool:
        """Manually re-admit a host (a returning preempted node, an
        operator override).  It re-enters on the next discovery update
        with whatever slot count the discovery source then reports."""
        with self._lock:
            if host not in self._blacklist:
                return False
            logger.warning("blacklist cleared for host %s", host)
            del self._blacklist[host]
            return True

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            self._expire_blacklist_locked()
            return host in self._blacklist

    @property
    def blacklisted_hosts(self) -> set[str]:
        with self._lock:
            self._expire_blacklist_locked()
            return set(self._blacklist)
