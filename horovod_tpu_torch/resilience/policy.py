"""Recovery policy: what happens AFTER a collective raised
RanksFailedError (``HOROVOD_ON_FAILURE=raise|shrink|retry``).

The port's copy of ``horovod_tpu/resilience/policy.py``
(``run_with_recovery`` with ``raise``, ``retry`` and ``shrink``,
``_retry_epoch``, ``rebuild_world``, ``converge_confirmed_dead``,
``apply_shrink``).  The rebuild does not wait for a control-plane
failover, since the port's rendezvous has no replica set (ROADMAP queue A
item 12).

- ``raise`` (default): propagate — the safe behavior for fixed-size
  jobs, and what a surrounding elastic loop (``hvd.elastic.run``) needs
  to see to trigger its own restore/re-rendezvous.
- ``retry``: for *idempotent eager collectives* only.  Transport state
  after a deadline expiry is unrecoverable in place (a late frame from
  the slow rank would desync the byte stream), so a retry is a full
  channel rebuild: ``hvd.shutdown()``, a deterministic epoch bump every
  rank computes identically, ``hvd.init()`` against fresh mesh scopes,
  then the collective re-runs.  Exponential backoff between attempts;
  ranks the liveness monitor confirms DEAD are never retried over
  (a dead rank cannot rejoin a fixed-size world — that is shrink's job).
- ``shrink``: hand the surviving-rank set to the elastic driver: the
  dead ranks' hosts are blacklisted (reference: horovod/runner/elastic/
  driver.py host blacklist) and the next rendezvous round forms on the
  survivors.  Inside ``hvd.elastic.run`` this happens by re-raising —
  RanksFailedError IS a HorovodInternalError, so the elastic loop's
  restore + re-rendezvous path fires; :func:`apply_shrink` is the
  driver-side half that records the failures and lets the round resolve
  at the smaller world size.
"""
from __future__ import annotations

import os
import time

from ..common import config
from ..common.exceptions import HorovodInternalError, RanksFailedError
from ..common.logging import logger
from . import context as _context

__all__ = ["apply_shrink", "converge_confirmed_dead", "rebuild_world",
           "run_with_recovery"]

# Attempts taken by the most recent run_with_recovery call (observability
# for tests and post-mortems; single-threaded write from the caller).
last_attempts = 0


def _retry_epoch(base: str, attempt: int) -> str:
    """Deterministic epoch for retry attempt N: every rank computes the
    same value from the same base, so the rebuilt meshes' KV scopes
    agree without any extra coordination."""
    root = base.split("~r", 1)[0]
    return f"{root}~r{attempt}"


def rebuild_world(attempt: int) -> None:
    """Tear the runtime down and re-form every channel under a fresh
    rendezvous epoch (mesh scopes, shm regions, heartbeat table all key
    on it, so no stale state from the failed world is ever touched)."""
    from .. import core
    base = os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0")
    core.shutdown()
    os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = _retry_epoch(base, attempt)
    core.init()


def run_with_recovery(fn, *, policy: str | None = None,
                      max_retries: int | None = None,
                      base_backoff: float | None = None):
    """Run ``fn`` (an idempotent eager collective, or a closure of them)
    under the configured failure policy.  Returns ``fn()``'s result."""
    global last_attempts
    policy = (policy or config.ON_FAILURE.get()).strip().lower()
    if policy not in ("raise", "retry", "shrink"):
        raise ValueError(f"HOROVOD_ON_FAILURE must be raise|shrink|retry "
                         f"(got {policy!r})")
    retries = config.FAULT_RETRIES.get() if max_retries is None \
        else int(max_retries)
    backoff = config.FAULT_BACKOFF_SECONDS.get() if base_backoff is None \
        else float(base_backoff)
    attempt = 0
    while True:
        try:
            result = fn()
            last_attempts = attempt + 1
            return result
        except HorovodInternalError as exc:
            last_attempts = attempt + 1
            if policy in ("raise", "shrink"):
                # shrink: the surrounding elastic loop owns the resize —
                # RanksFailedError is a HorovodInternalError, so
                # hvd.elastic.run restores state and re-rendezvouses on
                # the post-blacklist host set (see apply_shrink).
                raise
            if attempt >= retries:
                logger.error("resilience: giving up after %d retry "
                             "attempt(s): %s", attempt, exc)
                raise
            state = _context.active_state()
            if isinstance(exc, RanksFailedError) and state is not None:
                dead = state.confirmed_dead(exc.failed_ranks)
                if dead:
                    logger.error(
                        "resilience: not retrying — rank(s) %s are "
                        "confirmed dead (retry cannot resize the world; "
                        "use HOROVOD_ON_FAILURE=shrink under elastic)",
                        sorted(dead))
                    raise
            delay = backoff * (2 ** attempt)
            logger.warning("resilience: attempt %d failed (%s); "
                           "rebuilding channels and retrying in %.2fs",
                           attempt, exc, delay)
            time.sleep(delay)
            attempt += 1
            rebuild_world(attempt)


def converge_confirmed_dead(exc: RanksFailedError) -> frozenset[int]:
    """Converge on the heartbeat-CONFIRMED dead set after a collective
    raised RanksFailedError: every survivor must compute the same
    membership before any of them renumbers the world, and suspicion
    alone (a slow-but-alive peer) must never shrink it — an
    unconfirmable failure re-raises ``exc`` instead.

    Polls the liveness monitor until the confirmed set is stable across
    two polls, bounded by two fault windows (the reference's serving
    shrink and statesync transitions call it; in the port they are
    ROADMAP queue A item 11)."""
    from . import context as _ctx

    state = _ctx.active_state()
    if state is None:
        raise exc
    suspects = set(exc.failed_ranks)
    deadline = time.monotonic() + 2.0 * state.fault_timeout
    confirmed: frozenset[int] = frozenset()
    while time.monotonic() < deadline:
        try:
            state.monitor.poll_once()
        except Exception:  # noqa: BLE001 - convergence must not mask
            pass
        suspects |= state.failed_ranks()
        now_confirmed = state.confirmed_dead(suspects)
        if now_confirmed and now_confirmed == confirmed:
            return confirmed           # stable across two polls
        confirmed = now_confirmed
        time.sleep(state.poll_interval)
    if confirmed:
        return confirmed
    raise exc                          # alive-but-wedged: not shrinkable


def apply_shrink(driver, failed_ranks) -> dict[int, str]:
    """Driver-side shrink: blacklist every failed rank's host and record
    the slot failures so the current rendezvous round can resolve and
    :meth:`ElasticDriver.resume` re-forms the world on the survivors.
    Returns {failed rank: host} for logging/telemetry."""
    slots = driver.rank_to_slot()
    shrunk: dict[int, str] = {}
    for r in sorted(set(failed_ranks)):
        slot = slots.get(r)
        if slot is None:
            continue
        shrunk[r] = slot.hostname
        driver.record_failure(slot.hostname, slot.local_rank)
    if shrunk:
        logger.warning("resilience: shrink — blacklisted %s; elastic "
                       "driver will resume on the survivors",
                       {r: h for r, h in shrunk.items()})
    return shrunk
