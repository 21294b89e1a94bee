"""Per-process resilience state: fault timeout, per-op deadlines, and the
liveness view the transport's bounded waits consult.

The port's copy of ``horovod_tpu/resilience/context.py`` (``op_scope``,
``deadline_scope``, ``pending_deadline``, ``ResilienceState``,
``configure``, ``shutdown``).

Upstream Horovod's elastic layer (horovod/common/elastic.py, PAPER.md L7)
only reacts AFTER a collective has failed; the gap this module closes is
that on our socket/shm planes a dead or wedged peer previously produced
no failure at all — every survivor blocked forever in ``recv_into`` /
``kv_barrier`` / the 3-barrier shm lockstep.  A :class:`ResilienceState`
turns those blocking waits into deadline-bounded ones:

- every transport wait polls in short slices (``poll_interval``) and asks
  :meth:`ResilienceState.check` between slices;
- ``check`` raises :class:`RanksFailedError` the moment the heartbeat
  monitor declares any rank failed, or when the wait itself exceeds the
  per-op deadline (``op_timeout``, default ``HOROVOD_FAULT_TIMEOUT``) —
  the wedged-rank detector heartbeats alone cannot provide (a stuck main
  thread keeps heartbeating from its monitor thread);
- a transport-level death observation (peer socket closed mid-message)
  is fed back through :meth:`mark_failed`, which publishes a ``dead:``
  key to the rendezvous KV so every OTHER rank's next poll attributes
  its own stall to the true culprit instead of its silent neighbor.

Zero-overhead off mode: ``active_state()`` returns None unless
``HOROVOD_FAULT_TOLERANCE`` is on and a multi-rank world configured it,
and every instrumentation point reduces to one ``is None`` test.
"""
from __future__ import annotations

import threading
import time

from ..common import config
from ..common.exceptions import RanksFailedError
from ..common.logging import logger

__all__ = ["RanksFailedError", "ResilienceState", "active_state",
           "configure", "shutdown", "current_op", "op_scope",
           "current_op_deadline", "deadline_scope", "pending_deadline"]

# Name of the collective currently blocking this thread, for error
# attribution (set only when resilience is enabled — see op_scope).
_current_op = threading.local()

# Deadline a CALLER thread attaches to the collectives it is about to
# enqueue (serving/ per-request SLOs; see deadline_scope).  Read once at
# enqueue and stamped on the TensorTableEntry, which carries it to the
# background/stream thread that actually blocks — thread-locals do not
# cross that boundary on their own.
_pending_deadline = threading.local()


def current_op() -> str:
    return getattr(_current_op, "name", "")


def current_op_deadline() -> float | None:
    """Absolute monotonic deadline of the op this thread is executing,
    or None (set by op_scope on the dispatch thread)."""
    return getattr(_current_op, "deadline", None)


class op_scope:
    """Label the collective the calling thread is about to block in, so a
    RanksFailedError raised from a transport wait names it.  An optional
    absolute monotonic ``deadline`` additionally tightens the per-op
    deadline every bounded wait under this scope consults
    (:meth:`ResilienceState.op_timeout`) — the serving path's per-request
    SLO propagation."""

    __slots__ = ("_name", "_deadline", "_prev", "_prev_deadline")

    def __init__(self, name: str, deadline: float | None = None) -> None:
        self._name = name
        self._deadline = deadline

    def __enter__(self) -> "op_scope":
        self._prev = getattr(_current_op, "name", "")
        self._prev_deadline = getattr(_current_op, "deadline", None)
        _current_op.name = self._name
        _current_op.deadline = self._deadline
        return self

    def __exit__(self, *exc) -> None:
        _current_op.name = self._prev
        _current_op.deadline = self._prev_deadline


class deadline_scope:
    """Caller-side half of per-request deadline propagation: collectives
    enqueued by this thread inside the scope carry ``deadline`` (absolute
    ``time.monotonic()`` seconds) on their TensorTableEntries; the
    dispatch thread re-raises it through :class:`op_scope` so every
    transport wait of that op is bounded by the request SLO instead of
    the full HOROVOD_FAULT_TIMEOUT.  No-op overhead when fault tolerance
    is off (the entry field rides along but nothing reads it)."""

    __slots__ = ("_deadline", "_prev")

    def __init__(self, deadline: float | None) -> None:
        self._deadline = deadline

    def __enter__(self) -> "deadline_scope":
        self._prev = getattr(_pending_deadline, "value", None)
        _pending_deadline.value = self._deadline
        return self

    def __exit__(self, *exc) -> None:
        _pending_deadline.value = self._prev


def pending_deadline() -> float | None:
    """Deadline the calling thread attached via deadline_scope, if any
    (read by core at enqueue time)."""
    return getattr(_pending_deadline, "value", None)


class ResilienceState:
    """Liveness view + deadline policy for one world membership."""

    def __init__(self, rank: int, size: int, monitor,
                 fault_timeout: float | None = None) -> None:
        self.rank = rank
        self.size = size
        self.monitor = monitor          # HeartbeatMonitor (never None here)
        # Flight recorder (telemetry/flight.py): failure observations
        # land in the ring so the eventual RanksFailedError dump shows
        # WHEN this rank first suspected whom (Null when off).
        from ..telemetry import flight as _flight
        self.flight = _flight.recorder()
        self.fault_timeout = config.FAULT_TIMEOUT.get() \
            if fault_timeout is None else float(fault_timeout)
        # Transport waits poll in slices of this size between liveness
        # checks; short enough that a KV-propagated death mark is acted
        # on promptly, long enough that the off-CPU cost is negligible.
        self.poll_interval = max(0.05, min(0.25, self.fault_timeout / 8.0))

    # -- deadline policy -------------------------------------------------
    def op_timeout(self) -> float:
        """Per-op deadline for one blocking transport wait.  One fault
        window by default: a peer that neither completes its part of the
        op nor is declared dead within it is treated as wedged or
        unreachable.  When the executing op carries a propagated request
        deadline (serving SLOs, op_scope(deadline=...)), the window
        tightens to the remaining SLO budget — floored at a couple of
        poll slices so a healthy-but-busy peer is never declared wedged
        by an already-hopeless request alone."""
        deadline = current_op_deadline()
        if deadline is None:
            return self.fault_timeout
        remaining = deadline - time.monotonic()
        return min(self.fault_timeout,
                   max(remaining, 2.0 * self.poll_interval))

    # -- liveness --------------------------------------------------------
    def failed_ranks(self) -> frozenset[int]:
        return self.monitor.failed_ranks()

    def rank_failed(self, r: int) -> bool:
        return r in self.monitor.failed_ranks()

    def confirmed_dead(self, ranks) -> frozenset[int]:
        """Subset of `ranks` with CONFIRMED death evidence — the retry
        policy refuses to retry over these (a dead rank cannot rejoin a
        fixed-size world; that is shrink's job), while deadline-suspect
        ranks — alive but slow/wedged — stay retriable."""
        return frozenset(ranks) & self.monitor.confirmed_failed_ranks()

    def mark_failed(self, r: int, reason: str,
                    confirmed: bool = True) -> None:
        if self.flight.enabled:
            self.flight.record(
                "mark-failed", f"rank {r}",
                detail=f"{'confirmed' if confirmed else 'suspect'}: "
                       f"{reason[:160]}")
        self.monitor.mark_failed(r, reason, confirmed=confirmed)

    # -- the bounded-wait probe -----------------------------------------
    def check(self, peer: int, waited: float, phase: str) -> None:
        """Called by a transport wait after each expired poll slice.
        Raises RanksFailedError when the monitor has declared ANY rank
        failed (attributing the stall to the true culprit, which may not
        be the silent direct neighbor), or when this wait exceeded the
        per-op deadline (the peer is wedged: alive per heartbeat, absent
        from the collective)."""
        failed = self.monitor.failed_ranks()
        if failed:
            if self.flight.enabled:
                self.flight.record(
                    "deadline-convert", current_op(),
                    detail=f"phase={phase} failed="
                           f"{sorted(failed)} after {waited:.1f}s")
            raise RanksFailedError(failed, op=current_op(), phase=phase)
        if waited >= self.op_timeout():
            self.mark_failed(peer, f"unresponsive for {waited:.1f}s in "
                                   f"{phase}", confirmed=False)
            raise RanksFailedError(
                frozenset({peer}), op=current_op(), phase=phase,
                message=(f"rank {peer} sent no bytes for {waited:.1f}s "
                         f"(>= HOROVOD_FAULT_TIMEOUT="
                         f"{self.fault_timeout:g}s) while this rank "
                         f"blocked in {phase}; peer heartbeat still "
                         f"present — likely wedged mid-collective."))

    def peer_connection_lost(self, peer: int, phase: str,
                             detail: str) -> RanksFailedError:
        """A socket to `peer` closed/reset mid-message: record the
        failure (KV-propagated so distant ranks attribute correctly) and
        return the error for the caller to raise.  Marked SUSPECT, not
        confirmed: a peer that raised its own structured error and tore
        its mesh down also closes this socket — only heartbeat silence
        or a vanished PID confirms actual death (what the retry policy's
        refusal gate keys on).

        Forces one liveness poll FIRST: when a survivor detects the root
        failure, raises and exits, its ring neighbor sees the SURVIVOR's
        socket close — without the poll it would blame the messenger;
        the true culprit's dead-mark is already on the KV by then (marks
        publish before any raise), so one read attributes correctly."""
        try:
            self.monitor.poll_once()
        except Exception:  # noqa: BLE001 - attribution must never mask
            pass
        self.mark_failed(peer, f"connection lost: {detail}",
                         confirmed=False)
        return RanksFailedError(
            frozenset({peer}) | self.monitor.failed_ranks(),
            op=current_op(), phase=phase,
            message=f"connection to rank {peer} lost mid-collective "
                    f"({detail}).")

    def close(self) -> None:
        self.monitor.stop()


_lock = threading.Lock()
_state: ResilienceState | None = None


def active_state() -> ResilienceState | None:
    """The live ResilienceState, or None when fault tolerance is off or
    no multi-rank world has configured it (the zero-overhead off mode)."""
    return _state


def configure(rank: int, size: int, kv, epoch: str) -> ResilienceState | None:
    """Build (or rebuild, under elastic/retry re-init) the process
    resilience state.  Returns None — and tears down any previous state —
    unless HOROVOD_FAULT_TOLERANCE is on and the world is multi-rank."""
    global _state
    with _lock:
        if _state is not None:
            _state.close()
            _state = None
        if size <= 1 or kv is None or not config.FAULT_TOLERANCE.get():
            return None
        from .heartbeat import HeartbeatMonitor
        fault_timeout = config.FAULT_TIMEOUT.get()
        monitor = HeartbeatMonitor(rank, size, kv, epoch,
                                   fault_timeout=fault_timeout)
        monitor.start()
        _state = ResilienceState(rank, size, monitor,
                                 fault_timeout=fault_timeout)
        logger.debug("resilience: fault tolerance on (rank=%d size=%d "
                     "timeout=%.1fs)", rank, size, fault_timeout)
        return _state


def shutdown() -> None:
    global _state
    with _lock:
        if _state is not None:
            _state.close()
            _state = None
