"""Failure flight recorder: an always-on bounded ring of recent trace
events per rank, dumped as rank-stamped JSON the moment a structured
failure fires.

The port's own copy of ``horovod_tpu/telemetry/flight.py``.

HOROVOD_TIMELINE answers "where did the time go" only when it was enabled
before the run died.  The recorder keeps the last
``HOROVOD_FLIGHT_EVENTS`` trace events (enqueue, dispatch, completion,
failure conversions) in a ``collections.deque`` ring — one GIL-atomic
append per event, no locks, no threads, no file I/O until a failure
fires — and every structured failure path dumps it, so the dump's tail
names the in-flight op.

Off mode (``HOROVOD_FLIGHT=0``): every instrumentation point resolves to
the shared :data:`NULL_FLIGHT` no-op recorder, no SIGTERM handler is
installed, and the process's threads are the same either way (the
recorder never owns a thread).

Dump triggers, as in the reference: a fingerprint-divergence structured
ERROR (``Controller._check_fingerprints``, on the coordinator), every
RanksFailedError conversion of fault tolerance (the controller's poisoned
cycle and a data-plane wait in ``core._execute_response``; the
``ResilienceState`` records its ``mark-failed`` and ``deadline-convert``
observations into the ring first), and SIGTERM (preemption notice),
chained in front of any existing handler.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import threading
import time

from ..common import config
from ..common.logging import logger
from .exporter import resolve_dump_path

__all__ = ["NULL_FLIGHT", "FlightRecorder", "NullFlightRecorder",
           "configure", "recorder"]


class NullFlightRecorder:
    """Shared no-op recorder: the HOROVOD_FLIGHT=0 posture."""

    enabled = False

    def record(self, kind: str, name: str = "", trace=None,
               detail: str = "") -> None:
        pass

    def dump(self, reason: str = "") -> None:
        return None

    def snapshot(self) -> list:
        return []

    def set_metadata(self, **kv) -> None:
        pass


NULL_FLIGHT = NullFlightRecorder()


class FlightRecorder:
    """Lock-light bounded ring of recent trace events for one rank."""

    enabled = True

    def __init__(self, rank: int, capacity: int, path: str) -> None:
        self.rank = rank
        self.path = path
        # deque.append with maxlen is one GIL-atomic operation — the
        # recording hot path takes no lock (the dump lock below guards
        # only the failure path's file write).
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(capacity), 8))
        self._meta: dict = {}
        self._dump_lock = threading.Lock()
        self.dumps = 0
        self.last_dump_path: str | None = None

    # -- hot path --------------------------------------------------------
    def record(self, kind: str, name: str = "", trace=None,
               detail: str = "") -> None:
        """Append one trace event: (monotonic ts, kind, name, trace id,
        detail).  Callers pre-format strings only under
        ``if recorder.enabled`` so the off mode pays one attribute
        test."""
        self._ring.append((time.monotonic(), kind, name, trace, detail))

    def set_metadata(self, **kv) -> None:
        """Rank-level stitching metadata (clock offset, world size, …)
        included in every dump."""
        self._meta.update(kv)

    # -- failure path ----------------------------------------------------
    def snapshot(self) -> list[dict]:
        return [{"ts": ts, "kind": kind, "name": name, "trace": trace,
                 "detail": detail}
                for ts, kind, name, trace, detail in list(self._ring)]

    def dump(self, reason: str = "") -> str | None:
        """Write the rank-stamped JSON dump; returns the path (None on
        an unwritable target — evidence must never mask the original
        failure)."""
        with self._dump_lock:
            payload = {
                "rank": self.rank,
                "reason": reason,
                "dumped_wall_time": time.time(),
                "dumped_monotonic": time.monotonic(),
                "meta": dict(self._meta),
                "events": self.snapshot(),
            }
            try:
                # Write-then-rename: a concurrent reader (another
                # thread's conversion, a test, an operator tailing the
                # evidence) never sees a half-written dump.
                tmp = f"{self.path}.tmp{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(payload, f, indent=1)
                os.replace(tmp, self.path)
            except OSError as exc:
                logger.warning("flight: dump to %s failed: %s",
                               self.path, exc)
                return None
            self.dumps += 1
            self.last_dump_path = self.path
            return self.path


_lock = threading.Lock()
_recorder: FlightRecorder | NullFlightRecorder | None = None
_sigterm_chained = False
_prev_sigterm = None


def _sigterm_handler(signum, frame):
    rec = _recorder
    if rec is not None and rec.enabled:
        rec.record("sigterm")
        rec.dump(reason="SIGTERM")
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    else:
        # Default disposition: re-deliver so the process still dies with
        # the SIGTERM exit status the launcher expects.
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _chain_sigterm() -> None:
    global _sigterm_chained, _prev_sigterm
    if _sigterm_chained:
        return
    if threading.current_thread() is not threading.main_thread():
        return   # signal.signal is main-thread-only; workers skip
    try:
        _prev_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _sigterm_handler)
        _sigterm_chained = True
    except (ValueError, OSError):   # exotic embedding: recorder still works
        logger.debug("flight: SIGTERM handler not installed",
                     exc_info=True)


def configure(rank: int = 0):
    """(Re)build the process recorder from the environment (core.init);
    safe to call again across re-inits — the SIGTERM chain installs
    once, and the previous enabled ring's events carry over into the new
    recorder (bounded by the new capacity), so a failure dump after a
    re-init keeps the events of the world before it."""
    global _recorder
    with _lock:
        prev = _recorder
        if not config.FLIGHT.get():
            _recorder = NULL_FLIGHT
            return _recorder
        _recorder = FlightRecorder(
            rank, config.FLIGHT_EVENTS.get(),
            resolve_dump_path(config.FLIGHT_FILE.get(), rank))
        if isinstance(prev, FlightRecorder):
            _recorder._ring.extend(prev._ring)
        _chain_sigterm()
        return _recorder


def recorder():
    """The process flight recorder (never None; Null when off)."""
    global _recorder
    if _recorder is None:
        _recorder = configure()
    return _recorder
