"""statesync/ — elastic membership without a restart: peer-to-peer live
state streaming, preemption grace, and the autoscale policy loop (the
port's copy of ``horovod_tpu/statesync/``).

- :class:`~.service.StateSyncService` — one rank's membership agent:
  ``step_boundary()`` runs the per-step membership check (join
  admission → snapshot + donor thread, joiner-ready → grow transition,
  SIGTERM grace → proactive shrink), and ``shrink_on_failure()``
  packages the confirmed-dead shrink.
- :func:`~.service.join_world` — the joiner side: announce, pull the
  bulk snapshot from every live donor (disjoint shards, chunked,
  resumable across a donor death, digest-verified), pull the final
  boundary image while the incumbents rebuild channels, enter as
  rank N.
- :mod:`.snapshot` — flat state images, stamps and digests, ring-shard
  (ZeRO) re-layout math shared with ``checkpoint.py``.
- :mod:`.stream` — the donor/joiner streaming protocol over persistent
  duplex channels (``tcp_transport``'s state-frame verb).
- :mod:`.autoscale` — the policy loop driving the elastic driver's
  target world size from telemetry, with hysteresis.

The reference's protocol specs (``specs.py``, an hvdmc model) belong
with the analysis passes, ROADMAP queue A item 12.
"""
from __future__ import annotations

from .autoscale import (AutoscaleController, AutoscaleDecision,
                        AutoscalePolicy, registry_source)
from .service import (JoinInfo, StateSyncService, WorldChange,
                      fetch_donation, join_world, resync_replicated)
from .snapshot import (Snapshot, SnapshotStamp, concat_ring_shards,
                       flatten_state, load_state_into, reshard_ring_state,
                       shard_for_rank, state_digest, unflatten_state)
from .stream import (DonorLostError, DonorServer, JoinerPuller,
                     StreamError, TornSnapshotError)

__all__ = [
    "AutoscaleController", "AutoscaleDecision", "AutoscalePolicy",
    "DonorLostError", "DonorServer", "JoinInfo", "JoinerPuller",
    "Snapshot", "SnapshotStamp", "StateSyncService", "StreamError",
    "TornSnapshotError", "WorldChange", "concat_ring_shards",
    "fetch_donation", "flatten_state", "join_world", "load_state_into",
    "registry_source", "reshard_ring_state", "resync_replicated",
    "shard_for_rank", "state_digest", "unflatten_state",
]
