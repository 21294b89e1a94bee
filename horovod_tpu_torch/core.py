"""Global state, background coordination thread, and the enqueue API.

The port's copy of ``horovod_tpu/core.py`` (``Handle``, ``HandleManager``,
``GlobalState``, ``init``, ``shutdown``, the rank/size getters,
``_background_loop``, ``_execute_response``, ``_enqueue`` and the
``enqueue_*`` functions, ``StreamDispatcher``) on torch tensors: on the
CPU, or on this rank's card (``cuda:<local_rank>``).  ``init`` forms the world in the
reference's order: the rendezvous KV, the device plane (the NCCL group,
where the reference forms its JAX world and XLA plane), the same-host
shm plane, the control and data meshes, the clock-offset probe, the TCP
plane and the world-of-one fallback.  A CUDA tensor rides the device
plane, or in a world of one the basic plane on its card; it is never
staged through the host, and in a world of more than one rank without
the device plane it raises.  Its enqueue records a CUDA event on the
caller's stream, the background thread runs the card's work on a stream
of its own after waiting on that event, and ``Handle.wait`` makes the
caller's stream wait on the event recorded after the output was written
(upstream Horovod's ready events).  An allreduce carries its wire codec
(the call's ``compression=``, else ``HOROVOD_COMPRESSION``) and Adasum
as the reference's requests do; the hierarchical plane forms after the
device plane under ``HOROVOD_HIERARCHICAL_ALLREDUCE``/``ALLGATHER``.

The runtime around the cycle is the reference's too:
``HOROVOD_NUM_STREAMS`` worker threads (``StreamDispatcher``) run one
cycle's stream-safe host responses at once, each stream over a PeerMesh
of its own (scope ``data<epoch>.s<k>``), while device responses stay on
stream 0 and on the one device stream made at ``init``;
``HOROVOD_AUTOTUNE`` runs the ``ParameterManager`` on the coordinator,
whose tuned values every rank applies on the same cycle (the pipeline,
fused and algorithm values before the cycle's dispatch, the cycle time
and codec after it); ``HOROVOD_FINGERPRINT`` folds every request into the
controller's tracker; ``HOROVOD_METRICS`` records into the process
registry (per-collective latency, bytes and bus bandwidth, per-stream
busy time, the cycle and fusion-fill histograms), served on
``HOROVOD_METRICS_PORT + rank`` and dumped to ``HOROVOD_METRICS_FILE``
at ``shutdown``; the flight recorder (``HOROVOD_FLIGHT``, on by default)
records enqueue, dispatch and completion.  The failure half is the
reference's too: ``HOROVOD_FAULT_TOLERANCE`` starts the heartbeat monitor
(``resilience/``) before any mesh forms, every transport wait is
deadline-bounded, a response runs under ``op_scope`` with the tightest
deadline its entries carry (``deadline_scope`` at enqueue), and each
conversion to ``RanksFailedError`` dumps the flight ring;
``HOROVOD_CHAOS`` fires its response actions on the ordered ResponseList
before dispatch.  ``reinit_world`` re-forms the world under a new
rendezvous epoch, rank and size (the elastic transition; under
``HOROVOD_ELASTIC`` the launcher's elastic driver hands them out): every
mesh, shm region, heartbeat table and the NCCL group's store key on the
epoch, and ``shutdown`` destroys the NCCL group, so the next epoch forms
it anew.  Left out, raising ``NotImplementedError`` naming its ROADMAP
item when asked for (``common/config.py`` ``check_eager_knobs``): the SAN
witness (item 9(d)).

Design: user threads enqueue TensorTableEntries + Requests; a single
background thread runs the controller protocol every CycleTime ms, receives
the identical fused ResponseList on every rank, and executes each Response
through the backend priority chain.  Completion flows back through per-entry
callbacks into Handle futures, never blocking the background thread.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import types
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from . import resilience
from .backend.base import OperationManager, is_device_response
from .backend.basic import BasicBackend
from .common import config
from .common.controller import Controller, LocalTransport
from .common.dtypes import from_any
from .common.exceptions import RanksFailedError
from .common.group_table import GroupTable
from .common.logging import configure as configure_logging
from .common.logging import logger
from .common.message import Request, RequestType, Response, ResponseType
from .common.response_cache import ResponseCache
from .common.stall_inspector import StallInspector
from .common.status import Status
from .common.tensor_queue import TensorQueue, TensorTableEntry
from .common.timeline import Timeline
from .resilience.context import op_scope, pending_deadline

JOIN_TENSOR_NAME = "__join__"


class Handle:
    """Future for one (possibly grouped) async collective
    (reference: torch/handle_manager.cc)."""

    __slots__ = ("_event", "status", "entries", "_pending", "_hid",
                 "wrap_refs", "inplace_targets", "wants_recv_splits")

    def __init__(self, entries: list[TensorTableEntry]) -> None:
        self._event = threading.Event()
        self.status: Status | None = None
        self.entries = entries
        self._pending = len(entries)
        self._hid = -1
        # The caller's input tensors, so async results come back in their
        # dtype, as the sync API's do.
        self.wrap_refs: list[Any] = []
        # The torch binding's: the tensors an in-place variant writes
        # back into, and whether alltoall returns the received splits.
        self.inplace_targets: list[Any] = []
        self.wants_recv_splits = False

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> Status:
        """Block until every entry finished; outputs on a card are then
        ready in the calling thread's stream order."""
        if not self._event.wait(timeout):
            raise TimeoutError("collective did not complete in time")
        assert self.status is not None
        for e in self.entries:
            out = e.output
            if e.done_event is not None and isinstance(out, torch.Tensor) \
                    and out.is_cuda:
                stream = torch.cuda.current_stream(out.device)
                stream.wait_event(e.done_event)
                out.record_stream(stream)
        return self.status

    def outputs(self) -> list[Any]:
        return [e.output for e in self.entries]


class HandleManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        self._handles: dict[int, Handle] = {}

    def allocate(self, entries: list[TensorTableEntry]) -> tuple[int, Handle]:
        handle = Handle(entries)
        with self._lock:
            hid = self._next
            self._next += 1
            handle._hid = hid
            self._handles[hid] = handle
        return hid, handle

    def get(self, hid: int) -> Handle:
        with self._lock:
            return self._handles[hid]

    def entry_done(self, handle: Handle, status: Status) -> None:
        with self._lock:
            handle._pending -= 1
            # First error wins; OK only recorded if nothing failed.
            if handle.status is None or (handle.status.ok_p()
                                         and not status.ok_p()):
                handle.status = status
            if handle._pending <= 0:
                # Auto-release: the caller's Handle is the only owner now.
                self._handles.pop(handle._hid, None)
                handle._event.set()

    def release(self, hid: int) -> None:
        with self._lock:
            self._handles.pop(hid, None)


class StreamDispatcher:
    """HOROVOD_NUM_STREAMS persistent worker threads executing the
    independent responses of one cycle concurrently — the multi-stream
    analogue of upstream Horovod's per-stream NCCL queues
    (HOROVOD_NUM_NCCL_STREAMS).  Workers live for the whole run (no
    per-cycle/per-response thread spawn); the background loop enqueues a
    cycle's responses with their deterministic stream assignment and
    blocks on the cycle latch, so the controller protocol still advances
    one fully-executed cycle at a time.  The workers overlap where the
    GIL is released: socket I/O, the native ring and torch ops."""

    def __init__(self, num_streams: int) -> None:
        self.num_streams = num_streams
        self._queues: list[queue.Queue] = [queue.Queue()
                                           for _ in range(num_streams)]
        self._threads = [
            threading.Thread(target=self._worker, args=(k,), daemon=True,
                             name=f"hvd-stream-{k}")
            for k in range(num_streams)]
        for t in self._threads:
            t.start()

    def run_cycle(self, work: list[tuple[int, Any]]) -> None:
        """Execute [(stream, thunk)] concurrently across the stream
        workers; returns when every thunk finished."""
        if not work:
            return
        remaining = len(work)
        lock = threading.Lock()
        done = threading.Event()

        def _count_down() -> None:
            nonlocal remaining
            with lock:
                remaining -= 1
                if remaining == 0:
                    done.set()

        for stream, thunk in work:
            self._queues[stream].put((thunk, _count_down))
        done.wait()

    def _worker(self, k: int) -> None:
        q = self._queues[k]
        while True:
            item = q.get()
            if item is None:
                return
            thunk, count_down = item
            try:
                thunk()
            except Exception as exc:  # noqa: BLE001 - entry.finish reports
                logger.error("stream %d execution failed: %s", k, exc)
            finally:
                count_down()

    def stop(self) -> None:
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5)


@dataclass
class GlobalState:
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    initialized: bool = False
    shutdown_requested: bool = False
    background_thread: threading.Thread | None = None
    tensor_queue: TensorQueue = field(default_factory=TensorQueue)
    group_table: GroupTable = field(default_factory=GroupTable)
    controller: Controller | None = None
    op_manager: OperationManager | None = None
    # Multi-stream response dispatch (HOROVOD_NUM_STREAMS): op_managers[k]
    # is stream k's backend chain (stream 0 = the full chain above;
    # streams 1.. carry per-stream TCP/basic instances over their own
    # PeerMesh channel sets).  active_streams <= len(op_managers) is the
    # runtime width (autotuner-adjustable through the ResponseList).
    op_managers: list[OperationManager] = field(default_factory=list)
    stream_dispatcher: StreamDispatcher | None = None
    tcp_collectives: list[Any] = field(default_factory=list)
    active_streams: int = 1
    handle_manager: HandleManager = field(default_factory=HandleManager)
    timeline: Timeline | None = None
    # Metrics registry (telemetry/; HOROVOD_METRICS).  Null when off so
    # hot paths test one attribute and skip all instrumentation.
    telemetry: Any = None
    # Flight recorder (telemetry/flight.py; HOROVOD_FLIGHT).  Null when
    # off; records a bounded ring of trace events and dumps it on every
    # structured failure.
    flight: Any = None
    # Chaos engine (resilience/chaos.py; HOROVOD_CHAOS).  None when off;
    # survives shutdown/re-init so consumed counts persist across a
    # retry's rebuild.
    chaos: Any = None
    parameter_manager: Any = None
    cycle_time_ms: float = 1.0
    joined: bool = False
    # Runtime default wire codec (autotuner override via the ResponseList
    # tuned_codec field); None = honor HOROVOD_COMPRESSION.
    codec_override: str | None = None
    # Resolved fabric layout (common/topology.Topology): drives the ring
    # order and the torus allreduce eligibility.
    topology: Any = None
    # This rank's card (parallel/multihost.local_card), whether the
    # device plane formed, and the background thread's stream on the card.
    device_index: int = 0
    device_plane: bool = False
    device_stream: Any = None
    # resources to close at shutdown (sockets, shm regions, ...)
    resources: list[Any] = field(default_factory=list)

    def mark_done_callback(self, handle: Handle):
        def _cb(status: Status) -> None:
            self.handle_manager.entry_done(handle, status)
        return _cb


_global = GlobalState()
_init_lock = threading.Lock()
_atexit_registered = False


def global_state() -> GlobalState:
    return _global


# ---------------------------------------------------------------------------
# Initialization / shutdown (reference: operations.cc:651-769)
# ---------------------------------------------------------------------------
def init(*, rank: int | None = None, size: int | None = None,
         rendezvous_addr: str | None = None,
         rendezvous_port: int | None = None,
         local_rank: int | None = None, local_size: int | None = None,
         cross_rank: int | None = None, cross_size: int | None = None) -> None:
    """Initialize the runtime: discover the world from env/args, connect the
    control plane, build backends, spawn the background thread."""
    with _init_lock:
        if _global.initialized:
            return
        config.check_eager_knobs()
        # Under jsrun (LSF) or mpirun every rank receives the same
        # environment; rank identity arrives via JSM/OMPI/PMIx vars
        # instead of per-slot env.
        from .runner.js_run import adopt_jsm_env
        adopt_jsm_env()

        def _resolve(kwarg, knob, fallback):
            if kwarg is not None:
                return kwarg
            env = knob.get()
            return env if env >= 0 else fallback

        rank = _resolve(rank, config.RANK, 0)
        size = _resolve(size, config.SIZE, 1)
        # Topology default: one host holding every rank (local == global).
        local_rank = _resolve(local_rank, config.LOCAL_RANK, rank)
        local_size = _resolve(local_size, config.LOCAL_SIZE, size)
        cross_rank = _resolve(cross_rank, config.CROSS_RANK, 0)
        cross_size = _resolve(cross_size, config.CROSS_SIZE, 1)

        configure_logging(rank)
        # Telemetry registry BEFORE any mesh/controller construction —
        # they cache metric handles from the configured registry.
        from . import telemetry as _telemetry
        _global.telemetry = _telemetry.configure(rank)
        _global.flight = _telemetry.flight.configure(rank)
        if _global.telemetry.enabled:
            _global.telemetry.gauge(
                "horovod_world_size",
                "Live world size of this rank's world (set at every "
                "init)").set(size)
        _global.rank, _global.size = rank, size
        _global.local_rank, _global.local_size = local_rank, local_size
        _global.cross_rank, _global.cross_size = cross_rank, cross_size
        # Fabric layout (HOROVOD_TOPOLOGY; common/topology.py): the knob is
        # launcher-uniform, so every rank resolves the same Topology.
        from .common import topology as _topology
        # The launcher exports the full rank→host-index map (hosts.py
        # host_ids_env) for layouts that break the homogeneous host-major
        # assumption behind local/cross-size auto-detection; a map whose
        # length doesn't match the world (stale env across an elastic
        # resize) is ignored rather than trusted.
        host_ids = config.HOST_IDS.get()
        hosts = None
        if host_ids:
            try:
                parsed = tuple(int(x) for x in host_ids.split(","))
            except ValueError:
                parsed = ()
            if len(parsed) == size:
                hosts = parsed
        topo = _topology.resolve(size, local_size, cross_size, hosts=hosts)
        _global.topology = topo
        _global.cycle_time_ms = config.CYCLE_TIME.get()
        _global.shutdown_requested = False
        _global.tensor_queue.reset()
        _global.joined = False
        _global.tcp_collectives = []
        _global.stream_dispatcher = None
        _global.active_streams = 1
        # A tuned codec belongs to the world that tuned it.
        _global.codec_override = None
        from .parallel import multihost
        card = multihost.local_card(local_rank)
        _global.device_index = local_rank if card is None else card
        _global.device_plane = False
        _global.device_stream = None

        # EVERY rank records its own trace file: rank 0 keeps the exact
        # configured path, ranks > 0 get the '.r<rank>' suffix.
        _global.timeline = Timeline(
            config.TIMELINE.get(),
            mark_cycles=config.TIMELINE_MARK_CYCLES.get(), rank=rank)

        backends = []
        stream_managers: list[OperationManager] = []
        epoch = os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0")
        if size > 1:
            addr = rendezvous_addr or config.RENDEZVOUS_ADDR.get()
            port = rendezvous_port if rendezvous_port is not None \
                else config.RENDEZVOUS_PORT.get()
            if not addr or port <= 0:
                raise RuntimeError(
                    "Multi-process world requires a rendezvous server: set "
                    "HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT (a RendezvousServer "
                    "of horovod_tpu_torch.runner.network serves them).")
            from .backend.tcp import TcpBackend, TcpCollectives
            from .common.tcp_transport import TcpTransport
            from .runner.network import PeerMesh, RendezvousClient

            timeout = config.GLOO_TIMEOUT_SECONDS.get()
            kv = RendezvousClient(addr, port, timeout)
            # Resilience BEFORE any mesh/shm formation: every PeerMesh
            # and ShmWorld captures the process ResilienceState (and the
            # chaos engine) at construction.  None when
            # HOROVOD_FAULT_TOLERANCE is off — the zero-overhead mode.
            _global.chaos = resilience.chaos.configure(rank)
            resilience.configure(rank, size, kv, epoch)
            # The device plane first (the reference forms its JAX world
            # and puts the XLA plane first here): the NCCL group over the
            # rendezvous KV, once every rank offers a card of its own.
            nccl_mode = config.parse_tristate(config.NCCL_OPERATIONS.get())
            why_not = "HOROVOD_NCCL_OPERATIONS=0"
            if nccl_mode is not False:
                offer = card if multihost.should_init(size, local_rank) \
                    else None
                why_not = multihost.agree_on_cards(
                    rank, size, kv, offer, timeout=max(timeout, 120.0))
                if why_not is not None and nccl_mode is True:
                    raise RuntimeError(
                        f"HOROVOD_NCCL_OPERATIONS=1 requires the device "
                        f"plane, and it did not form: {why_not}")
            if why_not is not None:
                logger.debug("no device plane: %s", why_not)
            else:
                from .backend.nccl import NcclBackend, NcclCommunicator
                multihost.init_process_group(
                    rank, size, kv=kv, card=card,
                    timeout=max(timeout, 120.0))
                _global.resources.append(
                    types.SimpleNamespace(close=multihost.shutdown))
                backends.append(NcclBackend(NcclCommunicator(
                    device=torch.device("cuda", card))))
                _global.device_plane = True
            # Same-host shared-memory plane: formation is collective and
            # unanimous through the KV store.
            shm_backend = None
            shm_mode = config.parse_tristate(config.SHM_OPERATIONS.get())
            shm_capacity = config.SHM_CAPACITY.get() or \
                max(config.FUSION_THRESHOLD.get(), 64 * 1024 * 1024)
            if shm_mode is not False:
                from .backend.shm import ShmBackend, ShmWorld
                shm_world = ShmWorld(
                    rank, size, kv, scope=f"shm{epoch}",
                    capacity=shm_capacity, timeout=timeout)
                if shm_world.formed:
                    _global.resources.append(shm_world)
                    shm_backend = ShmBackend(shm_world)
                elif shm_mode is True:
                    raise RuntimeError(
                        "HOROVOD_SHM_OPERATIONS=1 requires every rank on "
                        "one host/memory domain; formation failed.")
            ctrl_mesh = PeerMesh(rank, size, kv, scope=f"ctrl{epoch}",
                                 timeout=timeout)
            data_mesh = PeerMesh(rank, size, kv, scope=f"data{epoch}",
                                 timeout=timeout)
            _global.resources.extend([ctrl_mesh, data_mesh])
            transport = TcpTransport(ctrl_mesh)
            # Per-rank clock-offset estimate against the coordinator (the
            # FIRST frames on the ctrl mesh), recorded as trace metadata.
            clock_offset_us, clock_rtt_us = transport.estimate_clock_offset()
            _global.timeline.set_clock_sync(clock_offset_us, clock_rtt_us)
            _global.flight.set_metadata(
                rank=rank, size=size, clock_offset_us=clock_offset_us,
                clock_rtt_us=clock_rtt_us)
            # The two-level host planes (upstream NCCLHierarchicalAllreduce,
            # nccl_operations.cc:187-398): local and cross sub-meshes when
            # the knobs are on.  After the device plane in the chain, so
            # CUDA tensors keep the card.
            hier = _hierarchical_backend(
                rank, size, local_rank, local_size, cross_rank, cross_size,
                topo, kv, epoch, timeout, shm_mode, shm_capacity)
            if hier is not None:
                backends.append(hier)
            # Topology-aware ring order + torus shape for the data plane;
            # identity order keeps the flat schedule.
            ring_order = topo.ring_order() if topo.kind != "flat" else None
            torus_shape = (topo.rows, topo.cols) \
                if topo.kind == "torus" else None
            tcp_coll = TcpCollectives(data_mesh, ring_order=ring_order,
                                      torus=torus_shape)
            tcp_backend = TcpBackend(tcp_coll)
            _global.tcp_collectives = [tcp_coll]
            if shm_backend is not None:
                shm_backend.tcp = tcp_backend   # oversized-alltoall delegate
                backends.append(shm_backend)
            backends.append(tcp_backend)
            # Multi-stream response dispatch (HOROVOD_NUM_STREAMS): one
            # more PeerMesh channel set + TCP backend chain per stream, so
            # concurrent responses never interleave bytes on a shared
            # socket and fusion staging buffers are per-stream.  Mesh
            # formation is collective; the knob is launcher-set and the
            # same on every rank.  The device plane gets no stream of its
            # own: its responses ride stream 0.
            num_streams = max(config.NUM_STREAMS.get(), 1)
            for s in range(1, num_streams):
                stream_mesh = PeerMesh(rank, size, kv,
                                       scope=f"data{epoch}.s{s}",
                                       timeout=timeout)
                _global.resources.append(stream_mesh)
                coll_s = TcpCollectives(stream_mesh,
                                        ring_order=ring_order,
                                        torus=torus_shape)
                _global.tcp_collectives.append(coll_s)
                tcp_s = TcpBackend(coll_s)
                basic_s = BasicBackend(size)
                tcp_s.stream = basic_s.stream = s
                tcp_s.timeline = basic_s.timeline = _global.timeline
                stream_managers.append(OperationManager([tcp_s, basic_s]))
            _global.active_streams = num_streams
            if num_streams > 1:
                _global.stream_dispatcher = StreamDispatcher(num_streams)
        else:
            transport = LocalTransport()
            _global.chaos = resilience.chaos.configure(rank)
            _global.timeline.set_clock_sync(0.0, 0.0)
            _global.flight.set_metadata(rank=rank, size=size,
                                        clock_offset_us=0.0,
                                        clock_rtt_us=0.0)
        backends.append(BasicBackend(size))
        if card is not None and (size == 1 or _global.device_plane):
            # The one stream the card's collective work runs on, whichever
            # thread runs it (the background thread or stream 0's worker).
            _global.device_stream = torch.cuda.Stream(
                torch.device("cuda", _global.device_index))

        # Runtime collective-symmetry fingerprinting (HOROVOD_FINGERPRINT;
        # analysis/fingerprint.py): divergent ranks get a structured error
        # naming the first divergent op instead of a stall.
        from .analysis.fingerprint import FingerprintTracker
        _global.controller = Controller(
            rank=rank, size=size, transport=transport,
            tensor_queue=_global.tensor_queue,
            group_table=_global.group_table,
            response_cache=ResponseCache(config.CACHE_CAPACITY.get()),
            stall_inspector=StallInspector(),
            local_rank=local_rank, local_size=local_size,
            cross_rank=cross_rank, cross_size=cross_size,
            timeline=_global.timeline,
            fingerprint=FingerprintTracker.from_config())
        for backend in backends:
            backend.timeline = _global.timeline
        _global.op_manager = OperationManager(backends)
        _global.op_managers = [_global.op_manager] + stream_managers

        if config.AUTOTUNE.get():
            from .common.parameter_manager import ParameterManager
            _global.parameter_manager = ParameterManager(
                _global.controller, rank == 0)

        if _global.telemetry.enabled and config.METRICS_PORT.get() > 0:
            from .telemetry import MetricsExporter
            _global.resources.append(MetricsExporter(
                _global.telemetry, rank, config.METRICS_PORT.get()))

        _global.background_thread = threading.Thread(
            target=_background_loop, daemon=True, name="hvd-background")
        _global.initialized = True
        _global.background_thread.start()
        # Finalize on interpreter exit like the reference: a script that
        # returns without shutdown() still flushes the timeline and tears
        # sockets/regions down cleanly.
        global _atexit_registered
        if not _atexit_registered:
            import atexit
            atexit.register(shutdown)
            _atexit_registered = True
        logger.debug("horovod_tpu_torch initialized: rank=%d size=%d",
                     rank, size)


def _hierarchical_backend(rank, size, local_rank, local_size, cross_rank,
                          cross_size, topo, kv, epoch, timeout, shm_mode,
                          shm_capacity):
    """The hierarchical plane of ``init``, or None.  Every rank makes the
    same build-or-skip decision: a declared torus builds row and column
    meshes (the knob is launcher-uniform); otherwise every rank publishes
    whether its layout is the homogeneous host-major one and the plane
    forms only when all of them say so."""
    hier_ar = config.HIERARCHICAL_ALLREDUCE.get()
    hier_ag = config.HIERARCHICAL_ALLGATHER.get()
    if not (hier_ar or hier_ag):
        return None
    from .backend.hierarchical import HierarchicalTcpBackend
    from .backend.tcp import TcpCollectives
    from .runner.network import PeerMesh
    if topo.kind == "torus":
        # RS along the row, AR along the column, AG back along the row.
        t_row, t_col = divmod(rank, topo.cols)
        row_mesh = PeerMesh(t_col, topo.cols, kv,
                            scope=f"htor{epoch}.r{t_row}", timeout=timeout)
        col_mesh = PeerMesh(t_row, topo.rows, kv,
                            scope=f"htor{epoch}.c{t_col}", timeout=timeout)
        _global.resources.extend([row_mesh, col_mesh])
        return HierarchicalTcpBackend(
            TcpCollectives(row_mesh), TcpCollectives(col_mesh),
            allreduce_on=hier_ar, allgather_on=hier_ag)
    layout_ok = (local_size > 1 and cross_size > 1 and
                 local_size * cross_size == size and
                 rank == cross_rank * local_size + local_rank)
    kv.put(f"hier{epoch}", f"ok:{rank}", b"1" if layout_ok else b"0")
    if not all(kv.wait(f"hier{epoch}", f"ok:{r}", timeout) == b"1"
               for r in range(size)):
        logger.warning(
            "hierarchical collectives requested but the rank layout is "
            "not homogeneous host-major on every rank (here: rank=%d "
            "local=%d/%d cross=%d/%d); using the flat path", rank,
            local_rank, local_size, cross_rank, cross_size)
        return None
    local_mesh = PeerMesh(local_rank, local_size, kv,
                          scope=f"hloc{epoch}.{cross_rank}", timeout=timeout)
    cross_mesh = PeerMesh(cross_rank, cross_size, kv,
                          scope=f"hcross{epoch}.{local_rank}", timeout=timeout)
    _global.resources.extend([local_mesh, cross_mesh])
    # The intra-host legs ride shm when the local ranks share a memory
    # domain (a per-host decision: the cross legs are the same either way).
    hier_shm = None
    if shm_mode is not False:
        from .backend.shm import ShmWorld
        hier_shm = ShmWorld(local_rank, local_size, kv,
                            scope=f"hshm{epoch}.{cross_rank}",
                            capacity=shm_capacity, timeout=timeout)
        if hier_shm.formed:
            _global.resources.append(hier_shm)
        else:
            hier_shm = None
    return HierarchicalTcpBackend(
        TcpCollectives(local_mesh), TcpCollectives(cross_mesh),
        allreduce_on=hier_ar, allgather_on=hier_ag, shm_local=hier_shm)


def shutdown() -> None:
    with _init_lock:
        if not _global.initialized:
            return
        _global.shutdown_requested = True
        thread = _global.background_thread
    if thread is not None:
        thread.join(timeout=60)
    with _init_lock:
        if not _global.initialized:
            return   # a concurrent shutdown won the race past the join
        _global.tensor_queue.finalize()
        dispatcher = _global.stream_dispatcher
        _global.stream_dispatcher = None
        timeline = _global.timeline
        telemetry = _global.telemetry
        resources = list(_global.resources)
        _global.resources.clear()
        _global.controller = None
        _global.op_manager = None
        _global.op_managers = []
        _global.tcp_collectives = []
        _global.parameter_manager = None
        _global.active_streams = 1
        _global.device_plane = False
        _global.device_stream = None
        _global.initialized = False
        _global.background_thread = None
    # The teardown that can wait (stream-worker joins, the timeline
    # writer, the metrics dump, channel closes) runs outside the lock.
    if dispatcher is not None:
        dispatcher.stop()
    if timeline is not None:
        timeline.stop()
    if telemetry is not None and telemetry.enabled:
        metrics_file = config.METRICS_FILE.get()
        if metrics_file:
            from .telemetry import dump_json
            try:
                dump_json(telemetry, metrics_file, _global.rank)
            except OSError as exc:
                logger.warning("telemetry: metrics dump to %s "
                               "failed: %s", metrics_file, exc)
    for res in resources:
        try:
            res.close()
        except Exception:  # noqa: BLE001 - best-effort cleanup
            pass
    resilience.shutdown()   # stop the heartbeat monitor (if any)


def reinit_world(*, rank: int, size: int, epoch: str) -> None:
    """Tear the world down and re-form it under a new rendezvous epoch
    with a (possibly) different rank/size — the elastic transition
    primitive (reference: ``horovod_tpu/core.py`` ``reinit_world``).
    Every mesh/shm/heartbeat scope and the NCCL group's store key on the
    epoch, so no stale state from the previous membership is ever
    touched; the env writes make the new identity survive any later
    env-driven re-init."""
    shutdown()
    os.environ["HOROVOD_RENDEZVOUS_EPOCH"] = epoch
    os.environ["HOROVOD_RANK"] = str(rank)
    os.environ["HOROVOD_SIZE"] = str(size)
    init()


def is_initialized() -> bool:
    return _global.initialized


def _require_init() -> GlobalState:
    if not _global.initialized:
        raise RuntimeError(
            "horovod_tpu_torch has not been initialized; call hvd.init().")
    return _global


def rank() -> int:
    return _require_init().rank


def size() -> int:
    return _require_init().size


def local_rank() -> int:
    return _require_init().local_rank


def local_size() -> int:
    return _require_init().local_size


def cross_rank() -> int:
    return _require_init().cross_rank


def cross_size() -> int:
    return _require_init().cross_size


def is_homogeneous() -> bool:
    """True when every host runs the same number of ranks."""
    st = _require_init()
    return st.size % max(st.local_size, 1) == 0 and \
        st.cross_size * st.local_size == st.size


def start_timeline(path: str, mark_cycles: bool = False) -> None:
    st = _require_init()
    if st.timeline is not None:
        st.timeline._mark_cycles = mark_cycles
        st.timeline.start(path)


def stop_timeline() -> None:
    st = _require_init()
    if st.timeline is not None:
        st.timeline.stop()


# ---------------------------------------------------------------------------
# Background loop (reference: operations.cc:589-647 RunLoopOnce)
# ---------------------------------------------------------------------------
def _background_loop() -> None:
    st = _global
    tm = st.telemetry
    tm_on = tm is not None and tm.enabled
    if tm_on:
        # Metric handles resolved once — the per-cycle cost is the update
        # itself (one uncontended per-metric lock), nothing else.
        m_cycle = tm.histogram(
            "horovod_controller_cycle_ms",
            "Background-loop cycle wall time (pop + sync + dispatch)")
        m_qdepth = tm.gauge(
            "horovod_controller_tensor_queue_depth",
            "Pending tensor-table entries after dispatch")
        m_fill = tm.histogram(
            "horovod_fusion_fill_ratio",
            "Fused-response payload bytes / fusion threshold")
    while True:
        t0 = time.monotonic()
        try:
            response_list = st.controller.compute_response_list(
                st.shutdown_requested)
        except Exception as exc:  # noqa: BLE001 - control-plane failure
            logger.error("controller failure: %s", exc)
            st.tensor_queue.finalize()
            return
        if st.timeline is not None:
            st.timeline.mark_cycle()

        # Pipeline autotune parameters apply BEFORE this cycle's dispatch:
        # they ride the identical broadcast ResponseList, so every rank
        # flips segment size / stream width on the same cycle and the
        # round-robin stream assignment below stays rank-symmetric.
        if response_list.tuned_segment_bytes >= 0:
            for coll in st.tcp_collectives:
                coll.segment_bytes = response_list.tuned_segment_bytes
        if response_list.tuned_num_streams > 0:
            st.active_streams = min(response_list.tuned_num_streams,
                                    max(len(st.op_managers), 1))
        if response_list.tuned_fused >= 0:
            # The fused codec passes flip on the same cycle on every rank
            # (both settings are bitwise identical and frame-compatible);
            # the shm plane carries the same dispatch attribute.
            for coll in st.tcp_collectives:
                coll.fused = bool(response_list.tuned_fused)
            for mgr in st.op_managers:
                for be in mgr.backends:
                    if be.name == "shm":
                        be.fused = bool(response_list.tuned_fused)
        # Allreduce-algorithm autotune applies BEFORE dispatch for the
        # same reason as the pipeline knobs: all ranks flip on the same
        # broadcast cycle, so _select_algo stays rank-symmetric.
        if response_list.tuned_algo >= 0:
            from .common.topology import algo_name
            for coll in st.tcp_collectives:
                coll.algo = algo_name(response_list.tuned_algo)
        if response_list.tuned_tree_threshold >= 0:
            for coll in st.tcp_collectives:
                coll.tree_threshold = response_list.tuned_tree_threshold

        # Chaos harness (HOROVOD_CHAOS): deterministic response-level
        # fault injection fires HERE, on the coordinator-ordered
        # ResponseList — the global collective index is identical on
        # every rank, so a kill/freeze/fail at index N is replayable and
        # (for rank=*) rank-symmetric.
        if st.chaos is not None:
            for i, response in enumerate(response_list.responses):
                if response.response_type in (ResponseType.JOIN,
                                              ResponseType.ERROR):
                    continue
                if st.chaos.on_response(response.tensor_names) == "fail":
                    # REPLACE, never mutate: the original Response object
                    # may be held by the response cache, and an in-place
                    # flip to ERROR would poison every later cache hit.
                    response_list.responses[i] = Response(
                        response_type=ResponseType.ERROR,
                        tensor_names=list(response.tensor_names),
                        error_message=(
                            "chaos: injected collective failure "
                            f"(HOROVOD_CHAOS, tensors "
                            f"{response.tensor_names})"))

        if st.stream_dispatcher is not None \
                and len(response_list.responses) > 1:
            _dispatch_cycle(st, response_list.responses)
        else:
            for response in response_list.responses:
                _perform_operation(st, response)

        total_bytes = 0
        tensor_names: list[str] = []
        fusion_threshold = st.controller.fusion_threshold_bytes() \
            if tm_on else 0
        for response in response_list.responses:
            if response.response_type in (ResponseType.ALLREDUCE,
                                          ResponseType.ADASUM):
                from .common.dtypes import element_size
                resp_bytes = sum(response.tensor_sizes) * \
                    element_size(response.tensor_type)
                total_bytes += resp_bytes
                tensor_names.extend(response.tensor_names)
                if tm_on and fusion_threshold > 0 and \
                        len(response.tensor_names) > 1:
                    m_fill.observe(resp_bytes / fusion_threshold)

        # Autotune: the coordinator scores the window and proposes new
        # parameters; every rank applies them from the ResponseList.
        if response_list.tuned_cycle_time_ms > 0:
            st.cycle_time_ms = response_list.tuned_cycle_time_ms
        if response_list.tuned_codec >= 0:
            from .compress import CompressionCodec, codec_name
            st.codec_override = codec_name(
                CompressionCodec(response_list.tuned_codec))
        if st.parameter_manager is not None:
            st.parameter_manager.observe(tensor_names, total_bytes)

        if response_list.shutdown:
            # Flip the visible flag: ranks that never submitted anything
            # must observe that the world shut down around them.
            st.shutdown_requested = True
            st.tensor_queue.finalize()
            return

        elapsed = time.monotonic() - t0
        if tm_on:
            m_cycle.observe(elapsed * 1e3)
            st.controller.record_cycle(elapsed * 1e3)
            m_qdepth.set(st.tensor_queue.size())
        timeline = st.timeline
        if timeline is not None and timeline.enabled \
                and response_list.responses:
            # Counter tracks ("ph":"C"): queue depth and cumulative wire
            # bytes as series in the trace, next to the op spans.
            timeline.counter("tensor_queue_depth",
                             {"depth": st.tensor_queue.size()})
            if st.tcp_collectives:
                timeline.counter(
                    "wire_bytes",
                    {"sent": sum(c.mesh.bytes_sent
                                 for c in st.tcp_collectives),
                     "received": sum(c.mesh.bytes_received
                                     for c in st.tcp_collectives)})
        sleep_s = st.cycle_time_ms / 1000.0 - elapsed
        if sleep_s > 0:
            # Wake early on fresh enqueues, then grant a short batching
            # grace so bursts still fuse into one response.
            if st.tensor_queue.wait_for_work(sleep_s):
                time.sleep(min(0.0003, st.cycle_time_ms / 5000.0))


def _perform_join(st: GlobalState, response: Response) -> None:
    st.joined = False
    if st.tensor_queue.has_tensor_entry(JOIN_TENSOR_NAME):
        entry = st.tensor_queue.pop_tensor_entry(JOIN_TENSOR_NAME)
        entry.output = torch.tensor(response.last_joined_rank,
                                    dtype=torch.int32)
        entry.finish(Status.ok())
        if st.timeline is not None and st.timeline.enabled:
            st.timeline.queue_end(JOIN_TENSOR_NAME,
                                  trace=response.trace_id())


def _pop_entries(st: GlobalState,
                 response: Response) -> list[TensorTableEntry]:
    """Pop the response's entries from the tensor table (background
    thread only) and close their negotiation spans."""
    entries: list[TensorTableEntry] = []
    for name in response.tensor_names:
        if st.tensor_queue.has_tensor_entry(name):
            entries.append(st.tensor_queue.pop_tensor_entry(name))
        else:
            # Joined rank: participate with a zero stand-in
            # (reference: controller.cc:254-308 joined-rank handling).
            entries.append(TensorTableEntry(tensor_name=name))
    trace = response.trace_id()
    for e in entries:
        e.trace = trace
    timeline = st.timeline
    if timeline is not None and timeline.enabled:
        for e in entries:
            timeline.negotiate_end(e.tensor_name, trace=trace)
    return entries


def _execute_response(st: GlobalState, response: Response,
                      entries: list[TensorTableEntry],
                      stream: int = 0) -> None:
    """Execute one response on stream `stream`'s backend chain and finish
    its entries (runs on the background thread when streams == 1, on a
    stream worker otherwise)."""
    timeline = st.timeline
    trace = response.trace_id()
    if timeline is not None and timeline.enabled:
        for e in entries:
            timeline.activity_start(e.tensor_name,
                                    response.response_type.name,
                                    stream=stream, trace=trace)
    fl = st.flight
    fl_on = fl is not None and fl.enabled
    if fl_on:
        head = response.tensor_names[0] if response.tensor_names else ""
        fl.record("dispatch", head, trace=trace,
                  detail=f"{response.response_type.name.lower()}"
                         f" x{len(entries)} stream={stream}")
    if response.response_type == ResponseType.ERROR:
        status = Status.precondition_error(response.error_message)
    else:
        tm = st.telemetry
        tm_on = tm is not None and tm.enabled
        res = resilience.active_state()
        try:
            manager = st.op_managers[stream]
            if tm_on:
                backend = manager.resolve(response, entries)
                plane = backend.name if backend is not None else "none"
                t0 = time.monotonic()
            if res is not None:
                # Label the blocking waits below for failure attribution
                # (RanksFailedError.op); off mode skips the string build.
                # The tightest propagated request deadline of the fused
                # entries bounds every transport wait of this op
                # (resilience.deadline_scope -> entry.deadline).
                deadlines = [e.deadline for e in entries
                             if e.deadline is not None]
                with op_scope(f"{response.response_type.name.lower()}"
                              f"({response.tensor_names[0]}"
                              f"{'…' if len(response.tensor_names) > 1 else ''})"
                              if response.tensor_names else
                              response.response_type.name.lower(),
                              deadline=min(deadlines) if deadlines
                              else None):
                    status = _execute_on(st, manager, response, entries)
            else:
                status = _execute_on(st, manager, response, entries)
            if tm_on:
                algo = getattr(backend, "last_algo", "none") \
                    if backend is not None else "none"
                _observe_collective(tm, response, plane, stream,
                                    (time.monotonic() - t0) * 1e3, algo,
                                    st)
        except Exception as exc:  # noqa: BLE001 - backend failure
            logger.error("collective execution failed: %s", exc)
            status = Status.unknown_error(str(exc))
            if fl_on and isinstance(exc, RanksFailedError):
                # A data-plane wait converted a dead/wedged peer into
                # the structured error: ship the evidence — the dump's
                # tail is the "dispatch" event of this in-flight op.
                fl.record("ranks-failed", head, trace=trace,
                          detail=str(exc)[:200])
                fl.dump(reason=str(exc))

    if timeline is not None and timeline.enabled:
        for e in entries:
            timeline.activity_end(e.tensor_name)

    if fl_on:
        fl.record("done" if status.ok_p() else "error", head,
                  trace=trace,
                  detail="" if status.ok_p() else status.reason[:200])

    # Release explicit groups everywhere — the coordinator deregisters
    # during response construction; worker ranks would leak one group
    # per grouped collective.
    st.group_table.deregister_groups(response.tensor_names)

    for e in entries:
        e.finish(status)
    if timeline is not None and timeline.enabled:
        # Close the enqueue->callback spans AFTER the callbacks ran.
        for e in entries:
            timeline.queue_end(e.tensor_name, trace=trace)


def _execute_on(st: GlobalState, manager: OperationManager,
                response: Response,
                entries: list[TensorTableEntry]) -> Status:
    """Run a response on the host planes, or on its card."""
    card = _card_of(st, response, entries)
    if card is None:
        return manager.execute_operation(response, entries)
    return _execute_on_card(st, card, manager, response, entries)


def _observe_collective(tm, response: Response, plane: str, stream: int,
                        latency_ms: float, algo: str = "none",
                        st: GlobalState | None = None) -> None:
    """Per-plane/per-codec collective latency+bytes, per-stream busy
    time, and the bus-bandwidth observation (registry lookups are dict
    hits; metric objects are cached by the registry itself)."""
    from .common.dtypes import element_size
    from .compress import CompressionCodec, codec_name
    from .telemetry import perfmodel
    op = response.response_type.name.lower()
    codec = codec_name(CompressionCodec(response.codec))
    nbytes = sum(response.tensor_sizes) * element_size(response.tensor_type)
    tm.histogram(
        "horovod_collective_latency_ms",
        "End-to-end latency of one executed response, by data plane, "
        "op, wire codec and collective algorithm",
        labels={"plane": plane, "op": op, "codec": codec, "algo": algo}
    ).observe(latency_ms)
    tm.counter(
        "horovod_collective_algo_total",
        "Executed responses by collective algorithm (ring / tree / rhd "
        "/ torus / hierarchical / ... — the per-size selection verdict)",
        labels={"algo": algo}).inc(1)
    tm.counter(
        "horovod_collective_bytes_total",
        "Uncompressed payload bytes of executed responses (allgather "
        "counts per-rank first dims as elements)",
        labels={"plane": plane, "op": op}).inc(nbytes)
    tm.counter(
        "horovod_stream_busy_ms_total",
        "Cumulative execution time on each dispatch stream",
        labels={"stream": str(stream)}).inc(latency_ms)
    # Bus bandwidth per (plane, op, codec, algo, size-bucket) — the
    # nccl-tests normalization, comparable across algorithms and world
    # sizes.
    size = st.size if st is not None else 1
    if size > 1 and nbytes > 0 and latency_ms > 0.0:
        busbw = perfmodel.busbw_mbps(op, nbytes, latency_ms, size)
        bucket = perfmodel.size_bucket(nbytes)
        tm.histogram(
            "horovod_collective_busbw_mbps",
            "Bus bandwidth of one executed collective (busbw = algbw x "
            "op factor, MB/s) by data plane, op, wire codec, algorithm "
            "and payload size bucket (telemetry/perfmodel.py)",
            labels={"plane": plane, "op": op, "codec": codec,
                    "algo": algo, "size_bucket": bucket}
        ).observe(busbw)
        peak = tm.gauge(
            "horovod_collective_busbw_peak_mbps",
            "Best bus bandwidth any collective demonstrated on this "
            "rank's data planes")
        if busbw > peak.value:
            peak.set(busbw)
        roof = float(config.PERF_PEAK_MBPS.get()) or peak.value
        tm.gauge(
            "horovod_collective_efficiency",
            "Roofline-relative bus-bandwidth efficiency of the most "
            "recent collective in each (plane, algo, size-bucket) cell: "
            "busbw / peak (HOROVOD_PERF_PEAK_MBPS, else the "
            "self-calibrated peak gauge)",
            labels={"plane": plane, "algo": algo, "size_bucket": bucket}
        ).set(busbw / roof if roof > 0.0 else 0.0)


def _card_of(st: GlobalState, response: Response,
             entries: list[TensorTableEntry]) -> torch.device | None:
    """The card a response's work runs on, None for host work.  A joined
    rank's stand-ins hold no tensor: they follow the response."""
    for e in entries:
        if e.tensor is not None:
            return e.tensor.device if e.tensor.is_cuda else None
    if st.device_plane and is_device_response(response):
        return torch.device("cuda", st.device_index)
    return None


def _execute_on_card(st: GlobalState, card: torch.device,
                     manager: OperationManager, response: Response,
                     entries: list[TensorTableEntry]) -> Status:
    """Run a response on the rank's device stream, made at ``init``:
    after the inputs' ready events, and record the event the callers
    wait on.  Device responses ride stream 0 (the device plane is not
    stream-safe), but a cycle of one response runs on the background
    thread and a longer one on stream 0's worker, so the thread sets the
    rank's card before it touches CUDA."""
    stream = st.device_stream
    torch.cuda.set_device(card)
    with torch.cuda.stream(stream):
        for e in entries:
            if e.ready_event is not None:
                stream.wait_event(e.ready_event)
            if e.tensor is not None:
                # The caller may drop its input before the card reads it.
                e.tensor.record_stream(stream)
        status = manager.execute_operation(response, entries)
        done = torch.cuda.Event()
        done.record(stream)
    for e in entries:
        e.done_event = done
    return status


def _perform_operation(st: GlobalState, response: Response) -> None:
    """Reference: operations.cc:256-329 PerformOperation."""
    if response.response_type == ResponseType.JOIN:
        _perform_join(st, response)
        return
    _execute_response(st, response, _pop_entries(st, response), stream=0)


def _dispatch_cycle(st: GlobalState, responses: list[Response]) -> None:
    """Multi-stream dispatch of one cycle's responses.

    Stream assignment is round-robin over the coordinator-ordered
    ResponseList, counting only stream-safe responses — both the order
    and each response's resolved backend are identical on every rank
    (enabled() checks are rank-symmetric by contract), so rank R's
    stream-k worker exchanges bytes exactly with every peer's stream-k
    worker.  Responses whose plane keeps process-global protocol state
    (shm lockstep, the NCCL device plane, the hierarchical sub-meshes)
    all ride stream 0, preserving their relative execution order."""
    work: list[tuple[int, Any]] = []
    rr = 0
    for response in responses:
        if response.response_type == ResponseType.JOIN:
            _perform_join(st, response)
            continue
        entries = _pop_entries(st, response)
        stream = 0
        if response.response_type != ResponseType.ERROR:
            backend = st.op_managers[0].resolve(response, entries)
            if backend is not None and backend.stream_safe:
                stream = rr % max(st.active_streams, 1)
                rr += 1

        def _thunk(response=response, entries=entries, stream=stream):
            _execute_response(st, response, entries, stream=stream)

        work.append((stream, _thunk))
    st.stream_dispatcher.run_cycle(work)


# ---------------------------------------------------------------------------
# Enqueue API (reference: operations.cc:919-1226)
# ---------------------------------------------------------------------------
def check_device(device: torch.device) -> None:
    """A collective takes a tensor on the CPU or on this rank's card.  A
    CUDA tensor is never staged through the host: in a world of more
    than one rank it needs the device plane."""
    if device.type == "cpu":
        return
    st = _require_init()
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if device.index != st.device_index:
        raise ValueError(f"a tensor on {device}: this rank's card is "
                         f"cuda:{st.device_index}")
    if st.size > 1 and not st.device_plane:
        raise RuntimeError(
            f"a CUDA tensor in a world of {st.size} ranks needs the device "
            f"plane (NCCL), which did not form: HOROVOD_NCCL_OPERATIONS=0, "
            f"or a rank without NCCL or a card of its own; pass a CPU "
            f"tensor")


def _as_tensor(tensor) -> torch.Tensor:
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"horovod_tpu_torch collectives take torch tensors, "
                        f"not {type(tensor).__name__}")
    check_device(tensor.device)
    return tensor.detach()


def _entry(name: str, tensor: torch.Tensor, **kwargs) -> TensorTableEntry:
    """The table entry of one tensor; a CUDA tensor's carries its card
    and the event its producer's stream reaches once it is written."""
    if not tensor.is_cuda:
        return TensorTableEntry(tensor_name=name, tensor=tensor, **kwargs)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(tensor.device))
    return TensorTableEntry(tensor_name=name, tensor=tensor,
                            device=tensor.device.index, ready_event=ready,
                            **kwargs)


def _enqueue(entries: list[TensorTableEntry],
             requests: list[Request]) -> tuple[int, Handle]:
    st = _require_init()
    hid, handle = st.handle_manager.allocate(entries)
    cb = st.mark_done_callback(handle)
    for e in entries:
        e.callback = cb
    # Open the enqueue->callback trace span BEFORE submission: the
    # background loop may finish an entry before this thread runs again.
    timeline = st.timeline
    tl_on = timeline is not None and timeline.enabled
    fl = st.flight
    # Per-request deadline propagation (serving SLOs): the enqueuing
    # thread's deadline_scope rides the entries to the dispatch thread,
    # which re-raises it through op_scope around the transport waits.
    deadline = pending_deadline()
    for e in entries:
        if deadline is not None:
            e.deadline = deadline
        if tl_on:
            timeline.queue_start(e.tensor_name)
        if fl is not None and fl.enabled:
            fl.record("enqueue", e.tensor_name)
    status = st.tensor_queue.add_to_tensor_queue_multi(entries, requests)
    if not status.ok_p():
        # Fail synchronously (duplicate name / shut down).
        for e in entries:
            e.callback = None
            if tl_on:
                timeline.queue_end(e.tensor_name)
        handle.status = status
        st.handle_manager.release(hid)
        handle._event.set()
    return hid, handle


def _resolve_codec(codec) -> tuple[int, int]:
    """(codec id, block size) for a Request: explicit argument beats the
    autotuner's runtime override beats the HOROVOD_COMPRESSION knob."""
    from .compress import (QUANTIZED_CODECS, CompressionCodec,
                           codec_from_name, default_block_size)
    if codec is None:
        codec = _global.codec_override
    if codec is None:
        codec = config.COMPRESSION.get()
    c = codec_from_name(codec)
    if c not in QUANTIZED_CODECS:
        return int(c), 0
    bs = default_block_size()
    if bs <= 0:
        raise ValueError(
            f"HOROVOD_COMPRESSION_BLOCK_SIZE must be positive (got {bs})")
    if c == CompressionCodec.UINT4 and bs % 2:
        raise ValueError(
            "uint4 compression requires an even "
            f"HOROVOD_COMPRESSION_BLOCK_SIZE (got {bs})")
    return int(c), int(bs)


def enqueue_allreduce(name: str, tensor, *, op: str = "sum",
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      adasum: bool = False,
                      codec=None) -> tuple[int, Handle]:
    return enqueue_grouped_allreduce([name], [tensor], op=op,
                                     prescale_factor=prescale_factor,
                                     postscale_factor=postscale_factor,
                                     adasum=adasum, register_group=False,
                                     codec=codec)


def enqueue_grouped_allreduce(names: Sequence[str], tensors: Sequence[Any], *,
                              op: str = "sum",
                              prescale_factor: float = 1.0,
                              postscale_factor: float = 1.0,
                              adasum: bool = False,
                              register_group: bool = True,
                              codec=None) -> tuple[int, Handle]:
    st = _require_init()
    if op == "average":
        postscale_factor = postscale_factor / st.size
    elif op != "sum":
        raise ValueError(f"Unknown allreduce op: {op}")
    rtype = RequestType.ADASUM if adasum else RequestType.ALLREDUCE
    codec_id, codec_bs = _resolve_codec(codec)
    arrs = [_as_tensor(t) for t in tensors]
    if len({a.device for a in arrs}) > 1:
        raise ValueError("a grouped allreduce takes its tensors on one "
                         "device: all on the CPU or all on this rank's card")
    entries, requests = [], []
    if register_group and len(names) > 1:
        st.group_table.register_group(list(names))
    for name, arr in zip(names, arrs):
        entry = _entry(name, arr)
        entries.append(entry)
        requests.append(Request(
            request_rank=st.rank, request_type=rtype,
            tensor_type=from_any(arr.dtype), tensor_name=name,
            device=entry.device, tensor_shape=tuple(arr.shape),
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor,
            codec=codec_id, codec_block_size=codec_bs))
    return _enqueue(entries, requests)


def enqueue_reducescatter(name: str, tensor, *, op: str = "sum",
                          prescale_factor: float = 1.0,
                          postscale_factor: float = 1.0
                          ) -> tuple[int, Handle]:
    """Reduce over all ranks, scatter dim-0 slices back."""
    st = _require_init()
    if op == "average":
        postscale_factor = postscale_factor / st.size
    elif op != "sum":
        raise ValueError(f"Unknown reducescatter op: {op}")
    arr = _as_tensor(tensor)
    entry = _entry(name, arr)
    request = Request(request_rank=st.rank,
                      request_type=RequestType.REDUCESCATTER,
                      tensor_type=from_any(arr.dtype), tensor_name=name,
                      device=entry.device, tensor_shape=tuple(arr.shape),
                      prescale_factor=prescale_factor,
                      postscale_factor=postscale_factor)
    return _enqueue([entry], [request])


def enqueue_allgather(name: str, tensor) -> tuple[int, Handle]:
    st = _require_init()
    arr = _as_tensor(tensor)
    entry = _entry(name, arr)
    request = Request(request_rank=st.rank,
                      request_type=RequestType.ALLGATHER,
                      tensor_type=from_any(arr.dtype), tensor_name=name,
                      device=entry.device, tensor_shape=tuple(arr.shape))
    return _enqueue([entry], [request])


def enqueue_broadcast(name: str, tensor,
                      root_rank: int) -> tuple[int, Handle]:
    st = _require_init()
    arr = _as_tensor(tensor)
    entry = _entry(name, arr, root_rank=root_rank)
    request = Request(request_rank=st.rank,
                      request_type=RequestType.BROADCAST,
                      tensor_type=from_any(arr.dtype), tensor_name=name,
                      root_rank=root_rank, device=entry.device,
                      tensor_shape=tuple(arr.shape))
    return _enqueue([entry], [request])


def enqueue_alltoall(name: str, tensor,
                     splits=None) -> tuple[int, Handle]:
    st = _require_init()
    arr = _as_tensor(tensor)
    split_list = [int(x) for x in torch.as_tensor(splits).reshape(-1)] \
        if splits is not None else []
    # Validate at ENQUEUE like the reference (operations.cc:1176): the
    # submitting rank fails fast before negotiation.
    if split_list:
        if len(split_list) != st.size:
            raise ValueError(
                f"alltoall splits must have one entry per rank (got "
                f"{len(split_list)} for world size {st.size})")
        if any(s < 0 for s in split_list):
            raise ValueError(
                f"alltoall splits must be non-negative (got {split_list})")
        if sum(split_list) != arr.shape[0]:
            raise ValueError(
                f"alltoall splits sum to {sum(split_list)} but tensor "
                f"first dimension is {arr.shape[0]}")
    entry = _entry(name, arr, splits=split_list)
    request = Request(request_rank=st.rank,
                      request_type=RequestType.ALLTOALL,
                      tensor_type=from_any(arr.dtype), tensor_name=name,
                      device=entry.device, tensor_shape=tuple(arr.shape))
    return _enqueue([entry], [request])


def enqueue_barrier() -> tuple[int, Handle]:
    st = _require_init()
    name = "__barrier__"
    entry = TensorTableEntry(tensor_name=name)
    request = Request(request_rank=st.rank, request_type=RequestType.BARRIER,
                      tensor_name=name)
    return _enqueue([entry], [request])


def enqueue_join() -> tuple[int, Handle]:
    """Graceful uneven-data exit (reference: operations.cc:1202-1226).

    After join() this rank keeps participating in negotiated collectives
    with zero stand-ins until every rank has joined."""
    st = _require_init()
    st.joined = True
    entry = TensorTableEntry(tensor_name=JOIN_TENSOR_NAME)
    request = Request(request_rank=st.rank, request_type=RequestType.JOIN,
                      tensor_name=JOIN_TENSOR_NAME)
    return _enqueue([entry], [request])
