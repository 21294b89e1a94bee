"""The statesync membership service: zero-downtime world grow,
preemption grace, and the failure-shrink transition (the port's copy of
``horovod_tpu/statesync/service.py``).

Every rank's training (or serving) loop calls
:meth:`StateSyncService.step_boundary` once per step.  The boundary
runs ONE tiny symmetric collective — an ``allgather_object`` of each
rank's locally observed membership events — so every rank reaches the
identical verdict at the identical step:

- **join seen** → every incumbent takes a copy-on-write
  :class:`~.snapshot.Snapshot` at THIS boundary (coherent by
  construction: same step everywhere) and spawns a
  :class:`~.stream.DonorServer` thread.  Training never pauses; the
  donors stream from the frozen image.
- **joiner ready** (its bulk image digest-verified) → the grow
  transition: incumbents take the final boundary snapshot, hand it to
  their donor threads (streamed while the channel rebuild below runs
  anyway), publish the ``go`` record, and rebuild the world one rank
  larger under a fresh rendezvous epoch.  Incumbents keep their ranks;
  the joiner enters as rank N with the exact final-boundary state —
  they never blocked on the joiner's bulk catch-up.
- **departure announced** (SIGTERM inside the
  ``HOROVOD_PREEMPT_GRACE_S`` window) → the preempted rank finishes
  this step, optionally fast-donates its ring-sharded optimizer shard
  to the KV, writes its ``bye|`` liveness stamp (via the monitor's
  orderly shutdown) and exits 0; the survivors renumber and rebuild one
  rank smaller at the SAME boundary — a proactive shrink with no
  ``RanksFailedError`` and no heartbeat deadline anywhere.

The hard failure path (a peer SIGKILLed mid-step) still surfaces as
``RanksFailedError`` from the training collective; the loop hands it to
:meth:`StateSyncService.shrink_on_failure`, which converges on the
heartbeat-confirmed dead set (resilience/policy.py) and rebuilds on the
survivors — the elastic shrink, packaged next to the grow that undoes
it.

The port's state tree is an ordered mapping of name to tensor (or numpy
array, or number), flattened by :mod:`.snapshot` in its own order; a
tree in the flax leaf order with each leaf viewed in flax's shape
(serving's ``ReplicaExecutor.state_tree``) has the reference's bytes and
digest.  A ``TrainState``'s tree is ``checkpoint.train_state_tree``, and
``checkpoint.load_train_state`` puts a pulled one back.

A state with sharded parameters (``Trainer(param_rules=...)``) grows and
is preempted too.  Its service is built with ``sharded=True`` and its
provider is ``train_state_tree(state, gather=True)``, a collective of the
mesh.  The service calls the provider on every rank of the world at the
same boundary: at a join (``_start_donation``), at the grow
(``_transition_grow``), and at a departure (``_transition_depart``, the
departing rank included, so that its chunks do not leave with it).  The
image each incumbent donates is therefore the whole, unsharded state, and
two donors split one image as they do for a replicated state.  The
``WorldChange`` of a grow or a proactive shrink carries that whole tree
(``tree``: the final snapshot's, the image the joiner verified, or the
departing world's), and the loop re-cuts it on the new mesh: a
``Trainer`` with the same rules built after the transition, then
``load_train_state``.  The joiner's template is the tree of a fresh
unsharded state of the same model and optimizer
(``checkpoint.whole_tree_template``): it holds no mesh until it is
admitted.  A failure shrink of a sharded state raises: the dead ranks'
chunks are gone, and the state comes back from a checkpoint
(``checkpoint.restore_checkpoint`` into a Trainer on the new mesh).
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Any, Callable

import torch

from ..common import config
from ..common.logging import logger
from .snapshot import Snapshot, flatten_state, state_digest, unflatten_state
from .stream import DonorServer, JoinerPuller, sync_scope

__all__ = ["JoinInfo", "StateSyncService", "WorldChange", "fetch_donation",
           "join_world", "resync_replicated"]

_WORLD_SCOPE = "statesync"
_WORLD_KEY = "world"


def _world_key() -> str:
    # Two live worlds (train + serve) may share ONE rendezvous KV, so
    # the membership record is namespaced by HOROVOD_STATESYNC_WORLD;
    # join_world reads the same name to target the right world.
    return config.STATESYNC_WORLD.get() or _WORLD_KEY


def _grow_scope(epoch: str) -> str:
    return f"ssgrow.{epoch}"


def _donate_scope(epoch: str) -> str:
    return f"ssdonate.{epoch}"


@dataclasses.dataclass
class WorldChange:
    """What a step boundary (or failure) did to the world membership."""
    kind: str                      # "grow" | "shrink" | "departed"
    rank: int = 0
    size: int = 0
    dead: tuple = ()               # shrink: the removed launch ranks
    join_id: int = -1              # grow: the admitted join event
    # A sharded service's whole state tree at the transition (grow: the
    # final snapshot's; proactive shrink: the departing world's), to be
    # re-cut on the new mesh; None otherwise.
    tree: Any = None


@dataclasses.dataclass
class JoinInfo:
    """The joiner's view of its own admission (join_world)."""
    rank: int
    size: int
    epoch: str
    join_id: int
    seq: int                       # boundary counter to resume from
    stamp: Any                     # final verified SnapshotStamp
    catch_up_ms: float             # bulk round wall time
    bulk_bytes: int
    donor_stats: dict              # donor -> (bytes, wall_s), bulk round


def _kv_client():
    from ..runner.network import RendezvousClient

    addr = config.RENDEZVOUS_ADDR.get()
    port = config.RENDEZVOUS_PORT.get()
    if not addr or port <= 0:
        raise RuntimeError(
            "statesync needs the rendezvous KV "
            "(HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT)")
    return RendezvousClient(addr, port,
                            config.GLOO_TIMEOUT_SECONDS.get())


def _settled(tree: Any) -> Any:
    """``tree`` once the card has finished the work that produced its
    tensors: a sharded state's gather runs on the world's process group,
    which the transition that follows destroys."""
    for leaf in tree.values() if isinstance(tree, dict) else ():
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            break
    return tree


class StateSyncService:
    """One rank's membership agent.  Create AFTER ``hvd.init()``; the
    service survives every world transition (it is not owned by core).

    ``sharded=True``: the state has sharded parameters, and
    ``state_provider`` gathers it (a collective every rank of the world
    calls alike; see the module docstring)."""

    def __init__(self, state_provider: Callable[[], Any], *,
                 static_state: bool = False,
                 donate_provider: Callable[[], Any] | None = None,
                 kv=None, sharded: bool = False) -> None:
        if sharded and static_state:
            raise ValueError("a static state (serving) is not sharded")
        self._provider = state_provider
        self._donate_provider = donate_provider
        # Static state (serving: params never change between steps)
        # skips the final round — the bulk image IS the entry state.
        self.static_state = static_state
        self.sharded = sharded
        self._kv = kv if kv is not None else _kv_client()
        self._seq = 0
        self._lock = threading.Lock()
        self._pending_join = -1        # join id seen, not yet snapshotted
        self._ready_join = -1          # join id whose joiner verified
        self._join_cursor = 0
        self._active_join = -1
        self._donors: dict[int, DonorServer] = {}
        self._preempt_at: float | None = None
        self._departed = False
        self._grace_timer: threading.Timer | None = None
        # (donation-start, grow-done) wall pairs — the serving report's
        # goodput-during-grow window (serving/loadgen.py).
        self.grow_windows: list[tuple[float, float]] = []
        self._grow_t0 = 0.0
        self._stop = threading.Event()
        self._refresh_world()
        self._install_preempt_handler()
        self._watcher = threading.Thread(target=self._watch_loop,
                                         daemon=True,
                                         name="hvd-statesync-watch")
        self._watcher.start()

    # -- donor lifecycle -------------------------------------------------
    def _reap_donors(self, grace: float = 2.0) -> None:
        """Join and drop finished DonorServer threads.  Without the
        reap, one DonorServer object per admitted join survived every
        grow forever — the ``_donors`` dict pinned the thread AND its
        snapshot queue (a full state image per round) across all later
        epochs.  A donor
        still serving (the joiner pulls the final round while
        incumbents rebuild channels) gets a bounded join and is left
        for the next boundary's reap — never blocked on."""
        for join_id, donor in list(self._donors.items()):
            donor.join(timeout=grace if donor.is_alive() else 0.0)
            if not donor.is_alive():
                del self._donors[join_id]

    # -- world identity --------------------------------------------------
    def _refresh_world(self) -> None:
        from .. import core

        st = core.global_state()
        self._reap_donors()
        with self._lock:
            self.rank = st.rank
            self.size = st.size
            self._epoch = os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0")
            # The boundary counter is EPOCH-SCOPED: every transition
            # resets it, so survivors that caught a failure at
            # different steps (and a joiner entering fresh) agree on
            # the next flag-exchange name without negotiation.
            self._seq = 0
            self._pending_join = -1
            self._ready_join = -1
            self._join_cursor = 0
            self._active_join = -1
        from ..telemetry import metrics

        metrics().gauge(
            "horovod_world_size",
            "Live world size as seen by this rank's statesync service "
            "(tracks every elastic grow/shrink transition)").set(self.size)
        if self.rank == 0:
            try:
                self._kv.put(_WORLD_SCOPE, _world_key(), json.dumps(
                    {"epoch": self._epoch, "size": self.size,
                     "seq": self._seq}).encode())
            except Exception as exc:  # noqa: BLE001 - KV hiccup
                logger.warning("statesync: world record publish "
                               "failed: %s", exc)

    # -- preemption grace ------------------------------------------------
    def _install_preempt_handler(self) -> None:
        self._grace = config.PREEMPT_GRACE_SECONDS.get()
        if self._grace <= 0:
            return
        if threading.current_thread() is not threading.main_thread():
            logger.warning("statesync: SIGTERM grace requested off the "
                           "main thread; handler not installed")
            return
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except (ValueError, OSError):
            logger.debug("statesync: SIGTERM handler not installed",
                         exc_info=True)

    def _on_sigterm(self, signum, frame) -> None:
        if self._preempt_at is not None:
            return
        self._preempt_at = time.monotonic()
        from ..telemetry import flight

        rec = flight.recorder()
        if rec.enabled:
            rec.record("sigterm-grace",
                       detail=f"grace={self._grace:g}s; departing at "
                              f"the next step boundary")
        timer = threading.Timer(self._grace, self._grace_expired)
        timer.daemon = True
        # Named like every statesync thread; Timer defaults to Thread-N.
        timer.name = "hvd-preempt-backstop"
        timer.start()
        self._grace_timer = timer
        logger.warning("statesync: SIGTERM received; departing within "
                       "%.1fs grace (next step boundary)", self._grace)

    def _grace_expired(self) -> None:
        """Backstop: no step boundary arrived inside the grace window
        (a wedged step).  Stamp the orderly departure anyway, ship the
        flight evidence, and exit with the conventional SIGTERM status
        — strictly better than the SIGKILL the scheduler sends next."""
        if self._departed:
            return
        from ..resilience import active_state
        from ..telemetry import flight

        state = active_state()
        if state is not None:
            try:
                state.monitor.stop()   # writes the bye| stamp
            except Exception:  # noqa: BLE001 - best-effort stamp
                pass
        rec = flight.recorder()
        if rec.enabled:
            rec.record("sigterm-grace-expired")
            rec.dump(reason="SIGTERM grace expired before a step "
                            "boundary")
        os._exit(143)

    @property
    def preempt_requested(self) -> bool:
        return self._preempt_at is not None

    def request_depart(self) -> None:
        """Programmatic orderly departure: arm the same boundary path a
        SIGTERM preemption notice takes (announce via the ``depart``
        flag of the next membership exchange, fast-donate, depart with
        the ``bye|`` stamp — survivors shrink proactively, no
        RanksFailedError), minus the signal handler and the backstop
        timer."""
        if self._preempt_at is not None:
            return
        self._preempt_at = time.monotonic()
        from ..telemetry import flight

        rec = flight.recorder()
        if rec.enabled:
            rec.record("depart-requested",
                       detail="departing at the next step boundary")
        logger.info("statesync: departure requested; leaving at the "
                    "next step boundary")

    # -- watcher ---------------------------------------------------------
    def _watch_loop(self) -> None:
        poll = config.STATESYNC_POLL_SECONDS.get()
        kv_healthy = True
        while not self._stop.wait(poll):
            try:
                self._watch_once()
                if not kv_healthy:
                    kv_healthy = True
                    logger.warning(
                        "statesync: rendezvous KV reachable again "
                        "(endpoint %s); watcher resumed",
                        getattr(self._kv, "endpoint", "?"))
            except TimeoutError as exc:
                # Coordinator restart/failover window: the client's
                # bounded retry already rotated endpoints — keep the
                # watcher alive and name the outage once instead of
                # silently dropping membership events.
                if kv_healthy:
                    kv_healthy = False
                    logger.warning(
                        "statesync: rendezvous KV unreachable (%s); "
                        "watcher idling until an endpoint answers", exc)
            except Exception:  # noqa: BLE001 - never kill the watcher
                logger.debug("statesync: watcher poll failed",
                             exc_info=True)

    def _watch_once(self) -> None:
        with self._lock:
            epoch = self._epoch
            cursor = self._join_cursor
            active = self._active_join
        scope = _grow_scope(epoch)
        if active < 0:
            raw = self._kv.get(scope, f"join:{cursor}")
            if raw is not None:
                with self._lock:
                    if self._epoch == epoch:
                        self._pending_join = cursor
        else:
            raw = self._kv.get(scope, f"ready:{active}")
            if raw is not None:
                with self._lock:
                    if self._epoch == epoch:
                        self._ready_join = active

    # -- the boundary ----------------------------------------------------
    def step_boundary(self) -> WorldChange | None:
        """Run the membership check for one step boundary.  Returns a
        :class:`WorldChange` when this boundary changed the world (the
        caller must re-read rank/size and, on ``departed``, exit its
        loop), else None.  Cheap steady state: one small
        allgather_object on the existing collective plane."""
        from .. import eager as hvd

        seq = self._seq
        self._seq += 1
        with self._lock:
            local = {"join": self._pending_join,
                     "ready": self._ready_join,
                     "depart": self.rank if self._preempt_at is not None
                     else -1}
        # Unconditionally allgather'd — at size 1 the collective is a
        # local no-op returning [local]: ``views`` derives from a
        # collective exchange on every path, so the boundary decisions
        # below are world-symmetric by dataflow.
        views = hvd.allgather_object(
            local, name=f"statesync.flag.{seq}")
        departing = sorted({v["depart"] for v in views
                            if v["depart"] >= 0})
        ready_id = max(v["ready"] for v in views)
        join_id = max(v["join"] for v in views)
        if departing:
            return self._transition_depart(departing)
        if ready_id >= 0:
            return self._transition_grow(ready_id)
        if join_id >= 0:
            self._start_donation(join_id)
        return None

    # -- donation --------------------------------------------------------
    def _start_donation(self, join_id: int) -> None:
        with self._lock:
            if self._active_join >= 0 or join_id in self._donors:
                return
            self._active_join = join_id
            self._pending_join = -1
            self._join_cursor = join_id + 1
            epoch = self._epoch
        self._grow_t0 = time.monotonic()
        snap = Snapshot(self._provider(), epoch, self._seq)
        donor = DonorServer(self._kv, sync_scope(epoch, join_id),
                            self.rank, self.size)
        donor.offer_snapshot(0, snap)
        donor.start()
        self._donors[join_id] = donor
        from ..telemetry import flight

        rec = flight.recorder()
        if rec.enabled:
            rec.record("donate", f"join {join_id}",
                       detail=f"{len(snap)} bytes from the step-"
                              f"{self._seq} boundary snapshot")
        logger.info("statesync: join %d admitted; donating %d bytes "
                    "from the step-%d boundary snapshot", join_id,
                    len(snap), self._seq)

    # -- transitions -----------------------------------------------------
    def _transition_grow(self, join_id: int) -> WorldChange:
        from .. import core

        with self._lock:
            epoch = self._epoch
            old_rank, old_size = self.rank, self.size
        donor = self._donors.get(join_id)
        final = not self.static_state
        tree = None
        if final:
            if donor is None or not donor.is_alive():
                # The donor thread died (joiner vanished after ready?):
                # a fresh one serves the final round alone.
                donor = DonorServer(self._kv,
                                    sync_scope(epoch, join_id),
                                    old_rank, old_size)
                donor.start()
                self._donors[join_id] = donor
            tree = _settled(self._provider())
            donor.offer_snapshot(1, Snapshot(tree, epoch, self._seq))
        new_epoch = f"{epoch}~g{join_id}"
        new_size = old_size + 1
        if old_rank == 0:
            self._kv.put(_grow_scope(epoch), f"go:{join_id}",
                         json.dumps({"epoch": new_epoch,
                                     "size": new_size,
                                     "rank": old_size,
                                     "seq": self._seq,
                                     "final": final}).encode())
        logger.warning("statesync: grow %d->%d (join %d) at boundary "
                       "%d; rebuilding channels", old_size, new_size,
                       join_id, self._seq)
        from ..telemetry import flight

        rec = flight.recorder()
        if rec.enabled:
            rec.record("grow", f"join {join_id}",
                       detail=f"{old_size}->{new_size} seq={self._seq}")
        core.reinit_world(rank=old_rank, size=new_size, epoch=new_epoch)
        self.grow_windows.append((self._grow_t0, time.monotonic()))
        self._refresh_world()
        return WorldChange("grow", rank=self.rank, size=self.size,
                           join_id=join_id,
                           tree=tree if self.sharded else None)

    def _transition_depart(self, departing: list[int]) -> WorldChange:
        from .. import core

        with self._lock:
            epoch = self._epoch
            old_rank, old_size = self.rank, self.size
        # Every rank of the old world gathers a sharded state, the
        # departing ones included, before their chunks leave.
        tree = _settled(self._provider()) if self.sharded else None
        if old_rank in departing:
            if self._grace_timer is not None:
                # Cancel AND reap: cancel() only marks the timer; the
                # backstop thread itself must be gone before the clean
                # departure.
                self._grace_timer.cancel()
                self._grace_timer.join(timeout=2.0)
                self._grace_timer = None
            self._fast_donate(epoch)
            from ..telemetry import flight

            rec = flight.recorder()
            if rec.enabled:
                rec.record("departed",
                           detail=f"orderly SIGTERM departure at "
                                  f"boundary {self._seq}")
            self._departed = True
            # core.shutdown stops the heartbeat monitor, which writes
            # the bye| stamp — peers read an orderly goodbye, never
            # heartbeat silence.
            core.shutdown()
            logger.warning("statesync: departed cleanly (preemption "
                           "grace) at boundary %d", self._seq)
            return WorldChange("departed", rank=old_rank, size=old_size)
        survivors = [r for r in range(old_size) if r not in departing]
        new_rank = survivors.index(old_rank)
        tag = "_".join(str(r) for r in departing)
        new_epoch = f"{epoch}~p{tag}"
        from ..telemetry import flight

        rec = flight.recorder()
        if rec.enabled:
            rec.record("shrink-proactive", f"departed {departing}",
                       detail=f"{old_size}->{len(survivors)} at "
                              f"boundary {self._seq}; no "
                              f"RanksFailedError anywhere")
        logger.warning("statesync: proactive shrink %d->%d (preempted "
                       "rank(s) %s); this rank %d -> %d", old_size,
                       len(survivors), departing, old_rank, new_rank)
        core.reinit_world(rank=new_rank, size=len(survivors),
                          epoch=new_epoch)
        self._refresh_world()
        return WorldChange("shrink", rank=self.rank, size=self.size,
                           dead=tuple(departing), tree=tree)

    def shrink_on_failure(self, exc) -> WorldChange:
        """Hard-failure shrink: converge on the heartbeat-confirmed
        dead set (never a merely-slow peer), renumber deterministically,
        rebuild on the survivors.  Re-raises ``exc`` when the failure
        cannot be confirmed.  A sharded state raises at once: the dead
        ranks took their chunks with them."""
        from .. import core
        from ..resilience import converge_confirmed_dead

        if self.sharded:
            raise RuntimeError(
                "statesync: a failure shrink cannot keep a state with "
                "sharded parameters (the dead ranks' chunks are lost); "
                "rebuild the world and restore the last checkpoint with "
                "checkpoint.restore_checkpoint into a Trainer on the new "
                "mesh") from exc

        dead = converge_confirmed_dead(exc)
        with self._lock:
            epoch = self._epoch
            old_rank, old_size = self.rank, self.size
        if old_rank in dead:
            raise exc
        survivors = [r for r in range(old_size) if r not in dead]
        new_rank = survivors.index(old_rank)
        tag = "_".join(str(r) for r in sorted(dead))
        from ..telemetry import flight

        rec = flight.recorder()
        if rec.enabled:
            rec.record("shrink", f"dead {sorted(dead)}",
                       detail=f"{old_size}->{len(survivors)}; "
                              f"heartbeat-confirmed set")
        logger.warning("statesync: failure shrink %d->%d (dead=%s); "
                       "this rank %d -> %d", old_size, len(survivors),
                       sorted(dead), old_rank, new_rank)
        core.reinit_world(rank=new_rank, size=len(survivors),
                          epoch=f"{epoch}~f{tag}")
        self._refresh_world()
        return WorldChange("shrink", rank=self.rank, size=self.size,
                           dead=tuple(sorted(dead)))

    # -- fast donation on departure --------------------------------------
    def _fast_donate(self, epoch: str) -> None:
        if self._donate_provider is None or \
                not config.PREEMPT_DONATE.get():
            return
        try:
            tree = self._donate_provider()
            image = flatten_state(tree)
            self._kv.put(_donate_scope(epoch), f"{self.rank}.meta",
                         json.dumps({"digest": state_digest(image),
                                     "nbytes": len(image),
                                     "seq": self._seq}).encode())
            self._kv.put(_donate_scope(epoch), str(self.rank),
                         bytes(image))
            logger.info("statesync: fast-donated %d state bytes before "
                        "departure", len(image))
        except Exception as exc:  # noqa: BLE001 - donation best-effort
            logger.warning("statesync: fast-donate failed: %s", exc)

    def notify_world_changed(self) -> None:
        """Re-read the world identity after a transition the service
        did not drive itself (the serving shrink path reinits the world
        from its own failure handler)."""
        self._refresh_world()

    def close(self) -> None:
        self._stop.set()
        if self._grace_timer is not None:
            self._grace_timer.cancel()
            self._grace_timer.join(timeout=2.0)
            self._grace_timer = None
        self._watcher.join(timeout=2.0)
        self._reap_donors()


def resync_replicated(state_tree: Any, version: int,
                      name: str = "statesync.resync") -> Any:
    """Realign replicated training state after a failure shrink.

    Survivors can catch a peer's death on DIFFERENT steps — one applied
    the last update before its collective raised, its neighbor did not —
    so after the world rebuild the most-advanced rank (highest
    ``version``; ties break to the lowest rank) broadcasts its state and
    everyone adopts it.  One broadcast, symmetric on every rank; call it
    once right after ``shrink_on_failure`` returns.  (The preemption and
    grow paths never need it: their transitions are step-synchronous.)"""
    from .. import eager as hvd

    views = hvd.allgather_object(int(version), name=f"{name}.v")
    best = max(range(len(views)), key=lambda r: (views[r], -r))
    return hvd.broadcast_object(state_tree, root_rank=best,
                                name=f"{name}.state")


def fetch_donation(epoch: str, rank: int, template: Any,
                   kv=None) -> Any | None:
    """Fetch a departed rank's fast-donated state from the KV, verify
    its digest, and unflatten against ``template``.  Returns None when
    nothing (valid) was donated."""
    kv = kv if kv is not None else _kv_client()
    meta_raw = kv.get(_donate_scope(epoch), f"{rank}.meta")
    image = kv.get(_donate_scope(epoch), str(rank))
    if meta_raw is None or image is None:
        return None
    meta = json.loads(meta_raw)
    if state_digest(image) != int(meta["digest"]) or \
            len(image) != int(meta["nbytes"]):
        logger.warning("statesync: donated state from rank %d failed "
                       "its digest check; ignoring", rank)
        return None
    return unflatten_state(image, template)


# ---------------------------------------------------------------------------
# The joiner side
# ---------------------------------------------------------------------------
def join_world(template_state: Any, *, timeout: float | None = None,
               max_attempts: int = 3) -> tuple[Any, JoinInfo]:
    """Join a live world as rank N by streaming state from its peers.

    Announces through the rendezvous KV, pulls the bulk snapshot from
    every incumbent (disjoint shards, resumable), posts ``ready`` once
    the image digest-verifies, pulls the final boundary image while the
    incumbents rebuild channels, then enters the world via
    ``core.init``.  Returns ``(state_tree, JoinInfo)`` — the tree holds
    ``template_state``'s leaves as new CPU tensors in their shapes and
    dtypes, bit-identical to the donors' final snapshot."""
    import socket

    from .. import core

    kv = _kv_client()
    timeout = timeout if timeout is not None \
        else config.STATESYNC_TIMEOUT_SECONDS.get()
    last_exc: Exception | None = None
    for attempt in range(max_attempts):
        world = json.loads(kv.wait(_WORLD_SCOPE, _world_key(), timeout))
        epoch, size = world["epoch"], int(world["size"])
        scope = _grow_scope(epoch)
        join_id = kv.claim(scope, "joins",
                           task_key=f"{socket.gethostname()}:"
                                    f"{os.getpid()}:{attempt}")
        kv.put(scope, f"join:{join_id}",
               json.dumps({"id": join_id, "epoch": epoch}).encode())
        from ..telemetry import flight

        rec = flight.recorder()
        if rec.enabled:
            rec.record("join-announce", f"join {join_id}",
                       detail=f"epoch {epoch}, {size} donors, "
                              f"attempt {attempt}")
        puller = JoinerPuller(kv, sync_scope(epoch, join_id), size,
                              timeout=timeout)
        try:
            t0 = time.monotonic()
            puller.connect()
            image, stamp = puller.pull_round(0)
            catch_up_ms = (time.monotonic() - t0) * 1e3
            bulk_stats = dict(puller.donor_stats)
            kv.put(scope, f"ready:{join_id}",
                   json.dumps(stamp.as_meta()).encode())
            if rec.enabled:
                # Ready is posted ONLY after pull_round digest-verified
                # the bulk image.
                rec.record("join-ready", f"join {join_id}",
                           detail=f"bulk {stamp.nbytes} bytes verified "
                                  f"in {catch_up_ms:.0f} ms")
            go = json.loads(kv.wait(scope, f"go:{join_id}", timeout))
            if go["final"]:
                image, stamp = puller.pull_round(1)
            puller.close()
        except Exception as exc:  # noqa: BLE001 - round failed: retry
            logger.warning("statesync: join attempt %d failed: %s",
                           attempt, exc)
            last_exc = exc
            try:
                puller.close()
                # Consume the stale announcement so a later watcher
                # pass never re-admits this dead attempt.
                kv.delete(scope, f"join:{join_id}")
                kv.delete(scope, f"ready:{join_id}")
            except Exception:  # noqa: BLE001 - already torn down
                pass
            time.sleep(min(2.0 ** attempt, 5.0))
            continue
        # Entry: the image is digest-verified (pull_round) — unflatten
        # and form the new world.  Incumbents are blocked only on this
        # mesh formation, never on the bulk transfer above.
        tree = unflatten_state(image, template_state)
        core.reinit_world(rank=int(go["rank"]), size=int(go["size"]),
                          epoch=go["epoch"])
        rec = flight.recorder()
        if rec.enabled:
            rec.record("join-entered",
                       f"rank {go['rank']}/{go['size']}",
                       detail=f"epoch {go['epoch']} seq {go['seq']}")
        from ..telemetry import metrics

        metrics().histogram(
            "horovod_catch_up_ms",
            "Wall time of a joiner's bulk peer-streaming catch-up "
            "(announce to digest-verified image)").observe(catch_up_ms)
        metrics().gauge(
            "horovod_world_size",
            "Live world size as seen by this rank's statesync service "
            "(tracks every elastic grow/shrink transition)"
        ).set(int(go["size"]))
        # go["seq"] is the incumbents' NEXT boundary index (they bumped
        # theirs before the grow transition ran) — start exactly there.
        info = JoinInfo(rank=int(go["rank"]), size=int(go["size"]),
                        epoch=go["epoch"], join_id=join_id,
                        seq=int(go["seq"]),
                        stamp=stamp, catch_up_ms=catch_up_ms,
                        bulk_bytes=stamp.nbytes,
                        donor_stats=bulk_stats)
        logger.warning("statesync: joined as rank %d/%d (epoch %s); "
                       "bulk catch-up %.0f ms for %d bytes",
                       info.rank, info.size, info.epoch,
                       catch_up_ms, stamp.nbytes)
        return tree, info
    raise RuntimeError(
        f"statesync: could not join after {max_attempts} attempts"
    ) from last_exc
