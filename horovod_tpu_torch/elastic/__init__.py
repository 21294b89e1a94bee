"""Elastic (fault-tolerant) training.

The port's copy of ``horovod_tpu/elastic/`` (upstream
horovod/runner/elastic/{driver,discovery,registration,worker}.py and
horovod/common/elastic.py).  Three cooperating pieces:

- the **driver** (launcher side): polls a host-discovery source, keeps a
  blacklist of failed hosts, computes stable rank assignments, spawns/respawns
  worker processes, and publishes assignments through the rendezvous KV;
- the **worker state machine**: ``hvd.elastic.run(fn)`` wraps the training
  function in a retry loop that commits/restores :class:`State` and
  re-rendezvouses on membership changes or collective failures;
- **notification plumbing**: the driver pushes host-change events into
  running workers so they can interrupt proactively instead of failing.

The driver's autoscale controller (``HOROVOD_AUTOSCALE``, statesync) is
ROADMAP queue A item 11.
"""
from __future__ import annotations

from .discovery import (FixedHostDiscovery, HostDiscovery,
                        HostDiscoveryScript, HostManager)
from .registration import READY, FAILURE, SUCCESS, WorkerStateRegistry
from .state import ArrayState, ObjectState, State
from .run import run
from .sampler import ElasticSampler

__all__ = [
    "ArrayState", "ElasticSampler", "FixedHostDiscovery", "HostDiscovery",
    "HostDiscoveryScript", "HostManager", "ObjectState", "State",
    "WorkerStateRegistry", "READY", "SUCCESS", "FAILURE", "run",
]
