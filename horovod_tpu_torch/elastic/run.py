"""The elastic worker retry loop: ``hvd.elastic.run(train_fn)``.

The port's copy of ``horovod_tpu/elastic/run.py``.

Upstream: horovod/common/elastic.py:151-175 ``run_fn`` — wraps the training
function so that collective failures restore the last committed state and
host-membership changes re-rendezvous, both followed by re-initialising the
runtime with a freshly assigned rank.
"""
from __future__ import annotations

import functools
import os

from ..common import config
from ..common.exceptions import (HorovodInternalError,
                                 HostsUpdatedInterrupt)
from ..common.logging import logger
from .state import State
from .worker import notification_manager


class _WorkerDropped(Exception):
    """This worker's slot is not part of the new assignment; exit quietly."""


def _apply_assignment(assignment: dict) -> None:
    env = {
        "HOROVOD_RANK": assignment["rank"],
        "HOROVOD_SIZE": assignment["size"],
        "HOROVOD_LOCAL_RANK": assignment["local_rank"],
        "HOROVOD_LOCAL_SIZE": assignment["local_size"],
        "HOROVOD_CROSS_RANK": assignment["cross_rank"],
        "HOROVOD_CROSS_SIZE": assignment["cross_size"],
        "HOROVOD_HOST_IDS": assignment.get("host_ids", ""),
        "HOROVOD_RENDEZVOUS_EPOCH": assignment["epoch"],
    }
    for key, value in env.items():
        os.environ[key] = str(value)
    # The driver stamps each assignment with its notification clock: any
    # host-update notification at or before this epoch's formation is
    # already reflected in the assignment, so drop it.
    notification_manager.acknowledge(int(assignment.get("notify_ts", 0)))


def _rendezvous(min_epoch: int) -> int:
    """(Re-)initialise the runtime, pulling a fresh rank assignment from the
    driver when one is attached (reference: gloo_context.cc:154-200 re-reads
    rank from the rendezvous server on reset)."""
    from .. import core

    notification_manager.init()
    if notification_manager.has_driver:
        # Asking for an epoch newer than the driver's current one IS the
        # READY signal: the driver forms a new round once every expected
        # worker has asked (or failed).
        assignment = notification_manager.get_assignment(min_epoch)
        if assignment is None:
            raise _WorkerDropped()
        _apply_assignment(assignment)
        epoch = int(assignment["epoch"])
    else:
        epoch = min_epoch
    core.init()
    return epoch


def run(func):
    """Decorator for elastic training functions.

    The wrapped function must take a :class:`State` as its first argument::

        @hvd.elastic.run
        def train(state, ...):
            ...

    On ``HorovodInternalError`` the last committed state is restored; on
    ``HostsUpdatedInterrupt`` the current state is kept; either way the
    runtime re-initialises against the new world before retrying.
    """
    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        from .. import core

        reset_required = not core.is_initialized()
        skip_sync = False
        epoch = int(os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0"))
        if reset_required:
            try:
                epoch = _rendezvous(epoch)
            except _WorkerDropped:
                return None

        while True:
            try:
                if not skip_sync:
                    state.sync()
                result = func(state, *args, **kwargs)
                notification_manager.record_success()
                return result
            except HorovodInternalError:
                logger.warning("collective failure; restoring last "
                               "committed state and re-rendezvousing")
                state.restore()
                skip_sync = False
            except HostsUpdatedInterrupt as exc:
                logger.info("host membership changed; re-rendezvousing")
                skip_sync = exc.skip_sync
            except _WorkerDropped:
                return None

            core.shutdown()
            try:
                epoch = _rendezvous(epoch + 1)
            except _WorkerDropped:
                return None
            state.on_reset()

    return wrapper
