"""Heartbeat-based failure detection over the rendezvous liveness table.

The port's copy of ``horovod_tpu/resilience/heartbeat.py``
(``HeartbeatMonitor``) over the port's own ``RendezvousClient``.

Every rank runs ONE daemon monitor thread (only when
``HOROVOD_FAULT_TOLERANCE`` is on — the off-mode thread census is zero)
that each interval:

1. publishes its own heartbeat ``hb/<epoch>:<rank> = <seq>|<pid>`` to the
   rendezvous KV store — the coordinator liveness table (the KV server
   already exists for mesh bootstrap, so detection adds no new service);
2. reads every peer's heartbeat and records, in LOCAL monotonic time,
   when each peer's value last ADVANCED — staleness is judged by local
   observation of progress, never by comparing cross-host clocks;
3. reads the ``dead/<epoch>`` scope, where any rank that has direct
   transport evidence of a death (socket closed mid-message, shm PID
   gone) published the victim's rank — so failure knowledge reaches
   ranks that are several ring hops away from the broken socket within
   one poll interval instead of one fault timeout.

A peer is declared failed when its heartbeat has not advanced for
``fault_timeout`` seconds (grace: never before one full window after
monitor start, so slow-importing peers are not condemned at formation),
or immediately when a ``dead:`` mark for it appears.

Telemetry (no-op when ``HOROVOD_METRICS`` is off): per-peer
``horovod_liveness`` gauge (1 alive / 0 failed), ``horovod_failures_total``
counter by kind, and a ``horovod_failure_detection_ms`` histogram of
heartbeat-silence length at declaration time.
"""
from __future__ import annotations

import threading
import time

from ..common.logging import logger

_DEAD_SCOPE = "dead"
_HB_SCOPE = "hb"


class HeartbeatMonitor:
    """One background thread maintaining this rank's view of peer
    liveness.  All reads from the data path (`failed_ranks`) are plain
    attribute/dict reads of state the thread replaces atomically."""

    def __init__(self, rank: int, size: int, kv, epoch: str,
                 fault_timeout: float = 30.0,
                 interval: float | None = None,
                 registry=None) -> None:
        self.rank = rank
        self.size = size
        self.kv = kv
        self.epoch = epoch
        self.fault_timeout = float(fault_timeout)
        self.interval = max(0.1, self.fault_timeout / 8.0) \
            if interval is None else float(interval)
        self._seq = 0
        self._failed: frozenset[int] = frozenset()
        # Subset of _failed with CONFIRMED-death evidence (socket closed,
        # PID gone, heartbeat silent) as opposed to deadline-expiry
        # suspicion — the retry policy may rebuild over a suspect (slow
        # but alive) rank, never over a confirmed-dead one.
        self._confirmed: frozenset[int] = frozenset()
        self._reasons: dict[int, str] = {}
        # peer -> (last observed value, local monotonic time it changed)
        self._last_progress: dict[int, tuple[str, float]] = {}
        self._started_at = 0.0
        # True while the rendezvous KV itself is unreachable: peer
        # staleness windows are paused (nobody can stamp), so a
        # coordinator failover never reads as mass peer death.
        self._kv_outage = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # `registry` overrides the process registry (a NullRegistry keeps
        # many in-process monitors from minting per-peer gauges).
        if registry is None:
            from ..telemetry import metrics as _tm_metrics
            registry = _tm_metrics()
        tm = registry
        self._tm_on = tm.enabled
        self._m_liveness = {}
        if self._tm_on:
            self._m_liveness = {
                r: tm.gauge("horovod_liveness",
                            "1 while the peer's heartbeat advances, 0 "
                            "once it is declared failed",
                            labels={"rank": str(r)})
                for r in range(size) if r != rank}
            for g in self._m_liveness.values():
                g.set(1)
            self._m_failures = tm.counter(
                "horovod_failures_total",
                "Ranks declared failed, by detection kind",
                labels={"kind": "heartbeat"})
            self._m_marked = tm.counter(
                "horovod_failures_total",
                "Ranks declared failed, by detection kind",
                labels={"kind": "transport"})
            self._m_latency = tm.histogram(
                "horovod_failure_detection_ms",
                "Heartbeat silence observed when a rank was declared "
                "failed (detection latency upper bound)")

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._started_at = time.monotonic()
        self._publish()   # first stamp before any wait can consult us
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-heartbeat")
        self._thread.start()

    def stop(self, silent: bool = False) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval + 5.0)
            if t.is_alive():
                logger.warning("resilience: heartbeat monitor thread did "
                               "not stop within grace (rank=%d)", self.rank)
        self._thread = None
        if silent:
            # A simulated hard kill: the rank must fall silent WITHOUT a
            # goodbye — peers are supposed to detect the death from
            # heartbeat staleness.
            return
        # Orderly departure stamp: peers still watching THIS epoch (e.g.
        # mid-retry, about to rebuild under a new one) must not read the
        # coming heartbeat silence as death — a rank that leaves the
        # epoch deliberately says goodbye; only a killed/frozen rank
        # falls silent without one.
        try:
            self.kv.put(_HB_SCOPE, f"{self.epoch}:{self.rank}",
                        f"bye|{self._seq}".encode())
        except Exception:  # noqa: BLE001 - KV already gone at teardown
            pass

    # -- data-path reads -------------------------------------------------
    def failed_ranks(self) -> frozenset[int]:
        return self._failed

    def confirmed_failed_ranks(self) -> frozenset[int]:
        return self._confirmed

    def failure_reason(self, r: int) -> str:
        return self._reasons.get(r, "")

    # -- transport evidence ---------------------------------------------
    def mark_failed(self, r: int, reason: str,
                    confirmed: bool = True) -> None:
        """Direct evidence of a failure.  ``confirmed=True`` means death
        evidence (shm PID gone, heartbeat silence); ``False`` means the
        rank is unreachable but possibly alive — deadline expiry, or a
        closed socket that an errored-but-alive peer produces too (the
        retriable cases).  Publishes a dead-mark so every other rank's
        next poll converges on the same verdict."""
        if r in self._failed and (not confirmed or r in self._confirmed):
            return
        self._declare(r, reason, kind="transport", confirmed=confirmed)
        try:
            prefix = "confirmed" if confirmed else "suspect"
            self.kv.put(_DEAD_SCOPE, f"{self.epoch}:{r}",
                        f"{prefix}|by {self.rank}: {reason}".encode())
        except Exception:  # noqa: BLE001 - KV gone: local verdict stands
            pass

    def _declare(self, r: int, reason: str, kind: str,
                 confirmed: bool = True) -> None:
        self._failed = self._failed | {r}
        if confirmed:
            self._confirmed = self._confirmed | {r}
        self._reasons.setdefault(r, reason)
        logger.warning("resilience: rank %d declared FAILED (%s, %s): %s",
                       r, kind, "confirmed" if confirmed else "suspect",
                       reason)
        if self._tm_on:
            g = self._m_liveness.get(r)
            if g is not None:
                g.set(0)
            (self._m_failures if kind == "heartbeat"
             else self._m_marked).inc()

    # -- monitor thread --------------------------------------------------
    def _publish(self) -> None:
        self._seq += 1
        try:
            import os
            self.kv.put(_HB_SCOPE, f"{self.epoch}:{self.rank}",
                        f"{self._seq}|{os.getpid()}".encode())
        except Exception:  # noqa: BLE001 - KV hiccup: next beat retries
            pass

    def _note_kv_outage(self, now: float, was_down: bool) -> None:
        """Restart every peer's staleness window at `now` (the liveness
        table itself is down; one structured warning per outage)."""
        if not was_down and not self._kv_outage:
            logger.warning(
                "resilience: rendezvous KV unreachable — heartbeat "
                "staleness clock paused until an endpoint answers "
                "(coordinator restart/failover window)")
        self._kv_outage = True
        for r, (value, _t) in list(self._last_progress.items()):
            self._last_progress[r] = (value, now)

    def poll_once(self) -> None:
        """One detection pass (also called directly by tests)."""
        now = time.monotonic()
        kv_was_down = self._kv_outage
        self._kv_outage = False
        for r in range(self.size):
            # Suspect ranks keep being polled — heartbeat silence (or a
            # peer's confirmed mark) may upgrade them to confirmed.
            if r == self.rank or r in self._confirmed:
                continue
            # Fast path: a peer's direct transport evidence.
            try:
                mark = self.kv.get(_DEAD_SCOPE, f"{self.epoch}:{r}")
            except Exception:  # noqa: BLE001 - KV hiccup
                mark = None
            if mark is not None:
                text = mark.decode(errors="replace")
                kind_tag, _, reason = text.partition("|")
                confirmed = kind_tag != "suspect"
                if confirmed or r not in self._failed:
                    self._declare(r, reason or text, kind="transport",
                                  confirmed=confirmed)
                if confirmed:
                    continue
                # Suspect mark only: FALL THROUGH to the staleness check
                # — heartbeat silence must still be able to upgrade the
                # suspicion to confirmed death (a SIGKILLed rank whose
                # socket closed first would otherwise stay suspect
                # forever, and shrink-style recovery keys on
                # confirmation).
            try:
                raw = self.kv.get(_HB_SCOPE, f"{self.epoch}:{r}")
            except Exception:  # noqa: BLE001
                # KV unreachable (coordinator death / failover window):
                # nobody's stamp can advance, so observed silence says
                # nothing about the PEER.  Pause the staleness clock —
                # every peer's window restarts when the control plane
                # answers again — instead of condemning the whole world
                # for the coordinator's outage.
                self._note_kv_outage(now, kv_was_down)
                continue
            value = raw.decode(errors="replace") if raw is not None else ""
            if value.startswith("bye|"):
                # Orderly departure (shutdown or epoch rebuild): not
                # death evidence — the transport's own socket errors
                # cover the rank's absence from live collectives.
                self._last_progress[r] = (value, now)
                continue
            prev = self._last_progress.get(r)
            if prev is None or prev[0] != value:
                if value:
                    self._last_progress[r] = (value, now)
                continue
            silence = now - prev[1]
            grace_over = now - self._started_at > self.fault_timeout
            if silence > self.fault_timeout and grace_over:
                self._declare(
                    r, f"heartbeat silent for {silence:.1f}s "
                       f"(> {self.fault_timeout:g}s)", kind="heartbeat")
                if self._tm_on:
                    self._m_latency.observe(silence * 1e3)
        if kv_was_down and not self._kv_outage:
            logger.warning("resilience: rendezvous KV reachable again; "
                           "heartbeat staleness clock resumed")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._publish()
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - never kill the monitor
                logger.debug("resilience: liveness poll failed",
                             exc_info=True)
