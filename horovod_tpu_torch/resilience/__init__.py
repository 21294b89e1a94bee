"""resilience/ — failure detection, deadline-bounded collectives, and the
deterministic fault-injection (chaos) harness.

The port's copy of ``horovod_tpu/resilience/``:

- :func:`configure` / :func:`active_state` — process resilience state
  (heartbeat monitor + deadline policy); None in the zero-overhead off
  mode (``HOROVOD_FAULT_TOLERANCE`` unset).
- :class:`~..common.exceptions.RanksFailedError` — the structured,
  attributed error every survivor raises instead of deadlocking when a
  peer dies, becomes unreachable, or misses a collective deadline.
- :func:`run_with_recovery` — applies ``HOROVOD_ON_FAILURE`` (raise |
  retry-with-rebuilt-channels | shrink, which re-raises for the
  surrounding ``hvd.elastic.run``); :func:`apply_shrink` is the elastic
  driver's half of shrink.
- :mod:`.chaos` — ``HOROVOD_CHAOS`` deterministic fault injection
  (kill/freeze/fail/preempt at a collective index, delay/drop/dup a
  specific peer-channel send), seeded and replayable.

The reference's ``specs.py`` (an hvdmc model-checking spec) belongs with
the analysis passes, ROADMAP queue A item 12.
"""
from __future__ import annotations

from ..common.exceptions import RanksFailedError
from . import chaos
from .context import (ResilienceState, active_state, configure, current_op,
                      current_op_deadline, deadline_scope, op_scope,
                      pending_deadline, shutdown)
from .policy import (apply_shrink, converge_confirmed_dead, rebuild_world,
                     run_with_recovery)

__all__ = [
    "RanksFailedError", "ResilienceState", "active_state", "apply_shrink",
    "chaos",
    "configure", "converge_confirmed_dead", "current_op",
    "current_op_deadline", "deadline_scope", "op_scope",
    "pending_deadline", "rebuild_world", "run_with_recovery", "shutdown",
]
