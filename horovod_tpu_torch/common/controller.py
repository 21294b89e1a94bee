"""Coordination protocol: which tensors are globally ready, fused how.

The port's copy of ``horovod_tpu/common/controller.py`` (``Controller``,
``LocalTransport``, ``compute_response_list``): responses, cache bits and
fusion, the collective fingerprint's fold and check (a divergence records
and dumps the flight ring), the metrics counters and histograms with the
coordinator's straggler aggregation, and the autotuner's
``pending_tuned_*`` proposals with the negotiation they force, and fault
tolerance's conversion of a RanksFailedError raised by a gather or drain
into the structured ERROR that poisons the cycle.

The reference's own lineage: a rebuild of Horovod's Controller
(reference: horovod/common/controller.{cc,h} — ComputeResponseList at
controller.cc:69-450, ConstructResponse at 472-749, FuseResponses at
778-915, IncrementTensorCount at 943-966).

Protocol per background cycle (all ranks run it in lockstep):
1. Pop locally-submitted Requests.
2. Cache path: look up each request in the ResponseCache; sync two bitvector
   words across ranks (AND of hits, OR of invalid+flags); execute common hits
   straight from the cache — steady state never ships RequestLists.
3. Uncached path (when any rank has uncached work, globally OR-decided):
   workers send their RequestList to the coordinator (rank 0); the
   coordinator counts readiness per tensor, validates cross-rank consistency
   (dtype/shape/op/root mismatches become structured ERROR responses, never
   hangs), fuses ready responses up to the fusion threshold with look-ahead,
   and broadcasts the final ResponseList.
4. Every rank executes the identical ResponseList in identical order — the
   deadlock-freedom invariant.

Transport (gather/broadcast/bitwise-allreduce) is abstract: LocalTransport
for single-process worlds, TcpTransport (runner/network.py) for
multi-process worlds over the DCN control plane.
"""
from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

from . import config
from ..analysis.fingerprint import FingerprintTracker, OpRecord
from .dtypes import element_size
from .exceptions import RanksFailedError
from .group_table import GroupTable
from .message import (Request, RequestList, RequestType, Response,
                      ResponseList, ResponseType)
from .response_cache import CacheCoordinator, CacheState, ResponseCache
from .stall_inspector import StallInspector
from .tensor_queue import TensorQueue

# Fusion buffers are sized in multiples of this unit so fused buffers always
# divide evenly for hierarchical ops (reference: common.h:103
# FUSION_BUFFER_ATOMIC_UNIT=64, controller.cc:452-470).
FUSION_BUFFER_ATOMIC_UNIT = 64

# The quantized codecs' ids (reference: compress/__init__.py
# CompressionCodec INT8 = 3, UINT4 = 4); Adasum refuses them.
QUANTIZED_CODECS = frozenset({3, 4})


def _round_to_atomic(threshold: int, divisor: int) -> int:
    unit = FUSION_BUFFER_ATOMIC_UNIT * max(divisor, 1)
    if threshold <= 0:
        return 0
    return max(unit, (threshold // unit) * unit)


@dataclass
class _TensorCount:
    """Coordinator-side readiness record for one tensor name."""
    requests: dict[int, Request] = field(default_factory=dict)  # rank -> req
    arrival: int = 0   # order in which the tensor was first requested
    # rank -> monotonic time its request arrived (telemetry straggler
    # signal; only populated when HOROVOD_METRICS is on).
    times: dict[int, float] = field(default_factory=dict)


class Transport(ABC):
    """Control-plane primitives between ranks (DCN/TCP or in-process)."""

    @abstractmethod
    def bitwise_sync(self, and_word: int, or_word: int) -> tuple[int, int]:
        """Allreduce: bitwise AND over first word, OR over second."""

    @abstractmethod
    def gather_requests(self, request_list: RequestList) -> list[RequestList] | None:
        """Workers send; coordinator returns all lists indexed by rank."""

    @abstractmethod
    def broadcast_responses(self, response_list: ResponseList | None) -> ResponseList:
        """Coordinator sends its list; workers receive it."""

    @abstractmethod
    def barrier(self) -> None:
        """Block until every rank arrives."""


class LocalTransport(Transport):
    """Single-process world: all ops are identities."""

    def bitwise_sync(self, and_word: int, or_word: int) -> tuple[int, int]:
        return and_word, or_word

    def gather_requests(self, request_list: RequestList):
        return [request_list]

    def broadcast_responses(self, response_list):
        return response_list

    def barrier(self) -> None:
        return None


class Controller:
    def __init__(self,
                 rank: int,
                 size: int,
                 transport: Transport,
                 tensor_queue: TensorQueue,
                 group_table: GroupTable | None = None,
                 response_cache: ResponseCache | None = None,
                 stall_inspector: StallInspector | None = None,
                 local_rank: int = 0,
                 local_size: int = 1,
                 cross_rank: int = 0,
                 cross_size: int = 1,
                 timeline=None,
                 fingerprint: FingerprintTracker | None = None) -> None:
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self.transport = transport
        self.tensor_queue = tensor_queue
        self.group_table = group_table or GroupTable()
        self.response_cache = response_cache if response_cache is not None \
            else ResponseCache(config.CACHE_CAPACITY.get())
        self.stall_inspector = stall_inspector or StallInspector()
        self.fingerprint = fingerprint if fingerprint is not None \
            else FingerprintTracker.from_config()
        self.timeline = timeline
        self.tensor_fusion_threshold = config.FUSION_THRESHOLD.get()
        self.disable_group_fusion = config.DISABLE_GROUP_FUSION.get()

        # Coordinator-side readiness table.
        self._message_table: dict[str, _TensorCount] = {}
        self._arrival_counter = 0
        # Join bookkeeping (reference: controller.cc:254-308).
        self.joined_ranks: set[int] = set()
        self.last_joined_rank = -1
        # Requests that hit the local cache this cycle, by name — if the
        # global AND kills their bit they must be renegotiated.
        self._local_hits: dict[str, Request] = {}
        # This rank has called join() and is riding along with zero
        # stand-ins until everyone joins.
        self.local_joined = False
        # Autotuner proposals awaiting broadcast (coordinator only).
        self.pending_tuned_params: tuple[int, float] | None = None
        self.pending_tuned_codec: int | None = None
        # (segment_bytes, num_streams) TCP-pipeline proposal.
        self.pending_tuned_pipeline: tuple[int, int] | None = None
        # Fused-codec-pass proposal (0/1; compress/fused.py dispatch).
        self.pending_tuned_fused: int | None = None
        # (algo index, tree threshold bytes) allreduce-algorithm proposal
        # (common/topology.ALGO_NAMES; backend/tcp.py selection).
        self.pending_tuned_algo: tuple[int, int] | None = None
        # Last request params per tensor, for cache insertion on every rank.
        self._last_request_params: dict[str, Request] = {}

        # Telemetry (HOROVOD_METRICS; telemetry/): controller-plane
        # counters + the coordinator's cross-rank straggler aggregation.
        # The Null registry makes every call below a no-op when off.
        from ..telemetry import metrics as _tm_metrics
        self.metrics = _tm_metrics()
        self._m_cache_hit = self.metrics.counter(
            "horovod_controller_cache_hit_total",
            "Requests answered from the response cache at controller pop")
        self._m_cache_miss = self.metrics.counter(
            "horovod_controller_cache_miss_total",
            "Requests that needed (re-)negotiation")
        self._m_negotiations = self.metrics.counter(
            "horovod_controller_negotiations_total",
            "Full RequestList gather/broadcast cycles")
        self._m_negotiation_ms = self.metrics.histogram(
            "horovod_controller_negotiation_ms",
            "Wall time of one gather+broadcast negotiation round")
        self._m_sync_wait_ms = self.metrics.histogram(
            "horovod_controller_sync_wait_ms",
            "Wall time blocked in the per-cycle bitvector sync (a fast "
            "rank's wait here is a slow peer's lag)")
        self.straggler = None
        if self.metrics.enabled and self.is_coordinator and size > 1:
            from ..telemetry.straggler import StragglerAggregator
            self.straggler = StragglerAggregator(size, self.metrics)
        # Worker-side window accumulators for the RequestList tm_*
        # snapshot (core's background loop feeds record_cycle).
        self._tm_cycles = 0
        self._tm_cycle_ms = 0.0
        self._tm_sync_wait_ms = 0.0
        # Within-round per-rank arrival times of the current gather.
        self._gather_arrivals: dict[int, float] = {}

        # Distributed-trace cycle counter: advances once per
        # compute_response_list call.  Cycles are lockstep across ranks,
        # so a locally-incremented counter is identical on every rank.
        self._trace_cycle = 0
        # Flight recorder (telemetry/flight.py): Null when HOROVOD_FLIGHT
        # is off, so every hook below is one attribute test.
        from ..telemetry import flight as _flight
        self.flight = _flight.recorder()

    # ------------------------------------------------------------------
    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def fusion_threshold_bytes(self) -> int:
        return _round_to_atomic(self.tensor_fusion_threshold, self.local_size)

    # ------------------------------------------------------------------
    def compute_response_list(self, shutdown_requested: bool = False) -> ResponseList:
        self._trace_cycle += 1
        message_queue = self.tensor_queue.pop_messages_from_queue()
        if self.fingerprint.enabled:
            # Fold every locally-submitted op into this rank's rolling
            # fingerprint in submission order (fold() itself skips JOIN —
            # rank-asymmetric by design — and requests re-popped after a
            # cache-bit miss, which were already folded on first pop).
            for req in message_queue:
                self.fingerprint.fold(req)
        if self.timeline is not None:
            for req in message_queue:
                self.timeline.negotiate_start(req.tensor_name,
                                              req.request_type)

        # Stall check rides the every-cycle heartbeat, not just
        # negotiation: a one-sided tensor leaves every queue empty after
        # its single submission, so negotiation never runs again — exactly
        # the stalled state the inspector exists to catch. The decision
        # propagates through the cache bit-sync OR (cache on) or the
        # gathered RequestList (cache off).
        if self.is_coordinator and self.stall_inspector.should_check():
            if self.stall_inspector.check_for_stalled_tensors(self.size):
                shutdown_requested = True

        cached_responses: list[Response] = []

        for req in message_queue:
            if req.request_type == RequestType.JOIN:
                self.local_joined = True

        if self.response_cache.enabled():
            coordinator = CacheCoordinator(self.response_cache.capacity)
            uncached: list[Request] = []
            if self.local_joined:
                # A joined rank asserts the cache bits of ops a zero
                # stand-in can legally satisfy (allreduce/adasum) so the
                # global AND still passes for the remaining ranks
                # (reference: controller.cc joined-rank cache handling).
                # Ops where absence has MEANING — allgather/alltoall/
                # reducescatter contribute shaped blocks, broadcast a
                # root — cannot be fabricated: mark those positions
                # INVALID instead, so the OR-propagated invalidation
                # evicts them everywhere, the peers renegotiate, and
                # ConstructResponse surfaces the structured
                # join-unsupported error rather than this rank executing
                # a cached response it never submitted (or hanging its
                # peers by silently dropping the bit).
                fabricatable = {ResponseType.ALLREDUCE, ResponseType.ADASUM}
                for pos in self.response_cache.positions():
                    rtype = self.response_cache.response_type_by_position(
                        pos)
                    if rtype in fabricatable:
                        coordinator.record_hit(pos)
                    else:
                        coordinator.record_invalid(pos)
            if self.is_coordinator and (
                    self.pending_tuned_params is not None
                    or self.pending_tuned_codec is not None
                    or self.pending_tuned_pipeline is not None
                    or self.pending_tuned_fused is not None
                    or self.pending_tuned_algo is not None):
                # Force one negotiation cycle so autotuned parameters reach
                # every rank even in cache steady state.
                coordinator.uncached_in_queue = True
            if self.fingerprint.strict:
                # Strict mode: a negotiation heartbeat EVERY cycle, so
                # fingerprints are compared in cache steady state too
                # (which otherwise never ships RequestLists).
                coordinator.uncached_in_queue = True
            for req in message_queue:
                state = self.response_cache.cached(req)
                if state == CacheState.HIT:
                    pos = self.response_cache.peek_cache_position(
                        req.tensor_name)
                    coordinator.record_hit(pos)
                    self._local_hits[req.tensor_name] = req
                    self.stall_inspector.record_cached_tensor(req.tensor_name)
                    self._m_cache_hit.inc()
                else:
                    if state == CacheState.INVALID:
                        pos = self.response_cache.peek_cache_position(
                            req.tensor_name)
                        coordinator.record_invalid(pos)
                    coordinator.uncached_in_queue = True
                    uncached.append(req)
                    self._m_cache_miss.inc()
            coordinator.shutdown = shutdown_requested
            self.stall_inspector.invalidate_stalled_cached_tensors(
                coordinator, self.response_cache)

            # Both words sync every cycle — this is the lockstep heartbeat
            # that keeps all ranks advancing together (reference:
            # controller.cc:751-776 CoordinateCacheAndState).
            and_word, or_word = coordinator.pack()
            t0 = time.monotonic() if self.metrics.enabled else 0.0
            try:
                and_word, or_word = self.transport.bitwise_sync(and_word,
                                                                or_word)
            except RanksFailedError as exc:
                return self._poison_response_list(exc)
            if self.metrics.enabled:
                wait_ms = (time.monotonic() - t0) * 1e3
                self._m_sync_wait_ms.observe(wait_ms)
                self._tm_sync_wait_ms += wait_ms
            coordinator.unpack(and_word, or_word)

            if coordinator.shutdown:
                return ResponseList(shutdown=True)

            for pos in sorted(coordinator.invalid_bits):
                self.response_cache.erase_by_position(pos)

            # Execute globally-common cache hits in bit order — positions are
            # identical across ranks because cache insertions happen in
            # identical response order on every rank.
            for pos in sorted(coordinator.hit_bits):
                resp = self.response_cache.get_response_by_position(pos)
                for name in resp.tensor_names:
                    self.stall_inspector.remove_cached_tensor(name)
                    self._local_hits.pop(name, None)
                cached_responses.append(resp)

            # Local hits whose bit didn't survive the AND: some rank hasn't
            # submitted this tensor yet.  Resubmit next cycle and wait for
            # the global AND to pass — negotiation is only entered when the
            # globally-ORed uncached flag says so, keeping every rank's
            # decision identical (the deadlock-freedom invariant).
            for req in self._local_hits.values():
                self.tensor_queue.push_back_to_queue(req)
            self._local_hits.clear()
            message_queue = uncached

            need_negotiation = coordinator.uncached_in_queue
        else:
            # Without a cache the reference gathers every cycle; an idle rank
            # still participates so the coordinator can make progress.
            need_negotiation = True

        fused_cached = self.fuse_responses(cached_responses)
        if not need_negotiation:
            return self._stamp_trace_ids(
                ResponseList(responses=fused_cached))

        response_list = self._negotiate(message_queue, shutdown_requested,
                                        trace_offset=len(fused_cached))
        if self._is_poison(response_list):
            # World poisoned mid-negotiation (resilience/): drop this
            # cycle's cached hits — their data-plane execution would
            # block on the dead rank; the poison ERROR already names
            # every pending tensor, so no waiter is left hanging.
            return response_list
        response_list.responses = fused_cached + response_list.responses
        self._stamp_trace_ids(response_list)

        if self.response_cache.enabled():
            for resp in response_list.responses:
                self._maybe_cache(resp)
        if response_list.tuned_fusion_threshold >= 0:
            self.tensor_fusion_threshold = response_list.tuned_fusion_threshold
        return response_list

    def _poison_response_list(self, exc: RanksFailedError) -> ResponseList:
        """Convert a detected rank failure into the structured-ERROR
        shutdown every rank performs locally: one ERROR response naming
        EVERY tensor still pending in the local table (so each blocked
        Handle raises RanksFailedError rather than hanging or getting a
        generic abort), plus the shutdown flag.  Rank-local tensor naming
        is safe here precisely because ERROR responses never touch a
        data plane — nothing about this list has to match across ranks.
        The coordinator's transport has already poison-broadcast the
        same failure to all survivors, so the whole world converges
        within one detection window."""
        names = sorted(set(self.tensor_queue.pending_names()))
        for name in names:
            self._message_table.pop(name, None)
            self.stall_inspector.remove_uncached_tensor(name)
        if self.flight.enabled:
            # Every structured failure ships the last N trace events:
            # the dump's tail names the op the world died inside.
            self.flight.record("ranks-failed", exc.op,
                               detail=exc.to_wire()[:200])
            self.flight.dump(reason=exc.to_wire())
        return ResponseList(
            responses=[Response(response_type=ResponseType.ERROR,
                                tensor_names=names,
                                error_message=exc.to_wire())],
            shutdown=True)

    @staticmethod
    def _is_poison(response_list: ResponseList) -> bool:
        return (response_list.shutdown and bool(response_list.responses)
                and response_list.responses[0].response_type
                == ResponseType.ERROR
                and RanksFailedError.matches(
                    response_list.responses[0].error_message))

    # ------------------------------------------------------------------
    def _stamp_trace_ids(self, response_list: ResponseList) -> ResponseList:
        """Assign the monotone (cycle, seq) trace id to every response
        that does not already carry one from the wire.  Negotiated
        responses arrive stamped by the coordinator (seq offset past
        this cycle's cached hits); cache-steady responses are stamped
        here — the final list is identical on every rank, so the local
        stamp is rank-identical too."""
        for seq, resp in enumerate(response_list.responses):
            if resp.trace_seq < 0:
                resp.trace_cycle = self._trace_cycle
                resp.trace_seq = seq
        return response_list

    def _maybe_cache(self, resp: Response) -> None:
        """Cache single-tensor non-error responses keyed by their request.

        Fused responses are not cached as a unit: each member caches
        individually (via earlier single-tensor cycles) and steady-state
        hits are re-fused by fuse_responses — matching the reference, where
        cache entries are per-tensor and fusion happens after lookup.
        """
        if resp.response_type in (ResponseType.ERROR, ResponseType.JOIN,
                                  ResponseType.BARRIER):
            return
        if len(resp.tensor_names) != 1:
            return
        req = self._last_request_params.get(resp.tensor_names[0])
        if req is None:
            # This rank never submitted the request (it has joined): cache
            # with parameters synthesized from the response so bit positions
            # stay identical on every rank.  The synthesized flat shape can
            # only cause a harmless INVALID→renegotiation if this rank ever
            # submits the tensor again.
            rtype = {ResponseType.ALLREDUCE: RequestType.ALLREDUCE,
                     ResponseType.ADASUM: RequestType.ADASUM,
                     ResponseType.REDUCESCATTER: RequestType.REDUCESCATTER,
                     ResponseType.ALLGATHER: RequestType.ALLGATHER,
                     ResponseType.BROADCAST: RequestType.BROADCAST,
                     ResponseType.ALLTOALL: RequestType.ALLTOALL}.get(
                         resp.response_type)
            if rtype is None:
                return
            req = Request(request_rank=self.rank, request_type=rtype,
                          tensor_type=resp.tensor_type,
                          tensor_name=resp.tensor_names[0],
                          root_rank=resp.root_rank,
                          tensor_shape=(sum(resp.tensor_sizes),),
                          prescale_factor=resp.prescale_factor,
                          postscale_factor=resp.postscale_factor,
                          codec=resp.codec,
                          codec_block_size=resp.codec_block_size)
        self.response_cache.put(resp, req)

    # ------------------------------------------------------------------
    def record_cycle(self, cycle_ms: float) -> None:
        """Fold one background-loop cycle's wall time into the window
        snapshot the next negotiation ships (core's background loop calls
        this only when metrics are on)."""
        self._tm_cycles += 1
        self._tm_cycle_ms += cycle_ms

    def _attach_telemetry_snapshot(self, my_list: RequestList,
                                   queue_depth: int) -> None:
        my_list.tm_cycles = self._tm_cycles
        my_list.tm_cycle_ms = self._tm_cycle_ms
        my_list.tm_sync_wait_ms = self._tm_sync_wait_ms
        my_list.tm_queue_depth = queue_depth
        self._tm_cycles = 0
        self._tm_cycle_ms = 0.0
        self._tm_sync_wait_ms = 0.0

    def _negotiate(self, message_queue: list[Request],
                   shutdown_requested: bool,
                   trace_offset: int = 0) -> ResponseList:
        for req in message_queue:
            self._last_request_params[req.tensor_name] = req
        my_list = RequestList(requests=list(message_queue),
                              shutdown=shutdown_requested)
        if self.fingerprint.enabled:
            seq, digest, tail = self.fingerprint.snapshot()
            my_list.fp_seq, my_list.fp_digest = seq, digest
            my_list.fp_tail_seqs = [rec.seq for rec in tail]
            my_list.fp_tail_digests = [rec.digest for rec in tail]
            my_list.fp_tail_descs = [rec.descriptor for rec in tail]
        tm_on = self.metrics.enabled
        if tm_on:
            self._attach_telemetry_snapshot(my_list, len(message_queue))
            t_neg = time.monotonic()
        if self.is_coordinator:
            try:
                gathered = self.transport.gather_requests(my_list)
            except RanksFailedError as exc:
                # The transport has already poison-broadcast to the
                # survivors; this is the coordinator's local half.
                return self._poison_response_list(exc)
            assert gathered is not None
            if self.straggler is not None:
                self.straggler.observe_snapshots(gathered)
                # Within-round arrival times from the transport (absent on
                # LocalTransport; _handle_request then stamps on handle).
                self._gather_arrivals = dict(getattr(
                    self.transport, "last_gather_arrivals", {}) or {})
            shutdown = False
            for rank_list in gathered:
                shutdown = shutdown or rank_list.shutdown
                for req in rank_list.requests:
                    self._handle_request(req)
            responses = [self._construct_response(names)
                         for names in self._pop_ready_tensors()]
            fp_error = self._check_fingerprints(gathered)
            if fp_error is not None:
                # The divergence error leads the list so every rank fails
                # the divergent entries before executing anything else.
                responses.insert(0, fp_error)
            join_resp = self._maybe_join_response()
            if join_resp is not None:
                responses.append(join_resp)
            # (Stall check already ran on the compute_response_list
            # heartbeat; shutdown_requested carries its verdict here.)
            response_list = ResponseList(responses=self.fuse_responses(responses),
                                         shutdown=shutdown)
            if self.pending_tuned_params is not None:
                threshold, cycle = self.pending_tuned_params
                response_list.tuned_fusion_threshold = threshold
                response_list.tuned_cycle_time_ms = cycle
                self.pending_tuned_params = None
            if self.pending_tuned_codec is not None:
                response_list.tuned_codec = self.pending_tuned_codec
                self.pending_tuned_codec = None
            if self.pending_tuned_pipeline is not None:
                segment, streams = self.pending_tuned_pipeline
                response_list.tuned_segment_bytes = segment
                response_list.tuned_num_streams = streams
                self.pending_tuned_pipeline = None
            if self.pending_tuned_fused is not None:
                response_list.tuned_fused = self.pending_tuned_fused
                self.pending_tuned_fused = None
            if self.pending_tuned_algo is not None:
                algo, tree_threshold = self.pending_tuned_algo
                response_list.tuned_algo = algo
                response_list.tuned_tree_threshold = tree_threshold
                self.pending_tuned_algo = None
            # Coordinator-assigned trace ids ride the broadcast wire
            # (the fp_* pattern): seq is offset past this cycle's cached
            # hits, which every rank prepends in the same order.
            for i, resp in enumerate(response_list.responses):
                resp.trace_cycle = self._trace_cycle
                resp.trace_seq = trace_offset + i
            try:
                self.transport.broadcast_responses(response_list)
            except RanksFailedError as exc:
                return self._poison_response_list(exc)
        else:
            try:
                self.transport.gather_requests(my_list)
                response_list = self.transport.broadcast_responses(None)
            except RanksFailedError as exc:
                # Local detection (coordinator dead/unreachable) or a
                # received poison frame: same structured local shutdown.
                return self._poison_response_list(exc)
            for resp in response_list.responses:
                if resp.response_type == ResponseType.JOIN:
                    self.joined_ranks.clear()
                    self.last_joined_rank = -1
                    self.local_joined = False
        if tm_on:
            self._m_negotiation_ms.observe(
                (time.monotonic() - t_neg) * 1e3)
            self._m_negotiations.inc()
        return response_list

    # ------------------------------------------------------------------
    # Coordinator internals
    # ------------------------------------------------------------------
    def _check_fingerprints(self, gathered: list[RequestList]) -> Response | None:
        """Compare the ranks' rolling collective fingerprints; divergence
        becomes a structured ERROR naming the first divergent op — the
        failure the per-tensor validation in _construct_single can never
        see (it needs every rank to submit the SAME tensor name; ranks
        submitting different ops entirely otherwise stall until the stall
        inspector's warning or the job timeout)."""
        if not self.fingerprint.enabled:
            return None
        divergence = self.fingerprint.check_gathered([
            (rl.fp_seq, rl.fp_digest,
             [OpRecord(s, d, t) for s, d, t in
              zip(rl.fp_tail_seqs, rl.fp_tail_digests, rl.fp_tail_descs)])
            for rl in gathered])
        if divergence is None:
            return None
        if self.flight.enabled:
            self.flight.record("fingerprint-divergence", "",
                               detail=divergence.message()[:200])
            self.flight.dump(reason=divergence.message())
        names = divergence.tensor_names()
        for name in names:
            # Divergent tensors will never become globally ready: drop
            # their readiness records so the stall inspector does not
            # keep warning about an already-reported failure.
            self._message_table.pop(name, None)
            self.stall_inspector.remove_uncached_tensor(name)
        return Response(response_type=ResponseType.ERROR,
                        tensor_names=names,
                        error_message=divergence.message())

    def _handle_request(self, req: Request) -> None:
        if req.request_type == RequestType.JOIN:
            self.joined_ranks.add(req.request_rank)
            self.last_joined_rank = max(self.last_joined_rank,
                                        req.request_rank)
            return
        rec = self._message_table.get(req.tensor_name)
        if rec is None:
            rec = _TensorCount(arrival=self._arrival_counter)
            self._arrival_counter += 1
            self._message_table[req.tensor_name] = rec
        rec.requests[req.request_rank] = req
        if self.straggler is not None:
            rec.times[req.request_rank] = self._gather_arrivals.get(
                req.request_rank, time.monotonic())
        self.stall_inspector.record_uncached_tensor(req.tensor_name,
                                                    req.request_rank)

    def _required_count(self) -> int:
        return self.size - len(self.joined_ranks)

    def _pop_ready_tensors(self) -> list[list[str]]:
        """Return groups of tensor names ready for response construction.

        Grouped tensors (GroupTable) are only released when every member is
        ready (reference: controller.cc:199-223); ungrouped tensors release
        individually, ordered by first arrival for determinism.
        """
        required = self._required_count()
        ready = [name for name, rec in self._message_table.items()
                 if len(rec.requests) >= required]
        ready.sort(key=lambda n: self._message_table[n].arrival)

        out: list[list[str]] = []
        ready_set = set(ready)
        seen_groups: set[int] = set()
        for name in ready:
            gid = self.group_table.get_group_id(name)
            if gid < 0:
                out.append([name])
            elif gid not in seen_groups:
                members = self.group_table.get_group_tensor_names(gid)
                if all(m in ready_set for m in members):
                    seen_groups.add(gid)
                    out.append(members)
        return out

    def _maybe_join_response(self) -> Response | None:
        if self.size > 0 and len(self.joined_ranks) == self.size:
            resp = Response(response_type=ResponseType.JOIN,
                            last_joined_rank=self.last_joined_rank)
            self.joined_ranks.clear()
            self.last_joined_rank = -1
            self.local_joined = False
            return resp
        return None

    # -- ConstructResponse (reference: controller.cc:472-749) ----------
    def _construct_response(self, names: list[str]) -> Response:
        if len(names) == 1:
            resp = self._construct_single(names[0])
        else:
            parts = [self._construct_single(n) for n in names]
            err = next((p for p in parts
                        if p.response_type == ResponseType.ERROR), None)
            if err is not None:
                # One bad member poisons the group: report the error for all
                # member tensors so no entry is left hanging.
                all_names = [n for p in parts for n in p.tensor_names]
                resp = Response(response_type=ResponseType.ERROR,
                                tensor_names=all_names,
                                error_message=err.error_message)
            else:
                resp = parts[0]
                resp.grouped = True
                for p in parts[1:]:
                    resp.tensor_names.extend(p.tensor_names)
                    resp.tensor_sizes.extend(p.tensor_sizes)
        self.group_table.deregister_groups(names)
        return resp

    def _construct_single(self, name: str) -> Response:
        rec = self._message_table.pop(name)
        self.stall_inspector.remove_uncached_tensor(name)
        if self.straggler is not None and rec.times:
            # The tensor just became globally ready: the spread of its
            # request arrivals IS the negotiation skew, and the last
            # arrival names the straggler (telemetry/straggler.py).
            self.straggler.observe_tensor(rec.times)
        reqs = [rec.requests[r] for r in sorted(rec.requests)]
        first = reqs[0]

        def error(msg: str) -> Response:
            return Response(response_type=ResponseType.ERROR,
                            tensor_names=[name], error_message=msg)

        if any(r.request_type != first.request_type for r in reqs):
            ops = {r.request_rank: r.request_type.name for r in reqs}
            return error(f"Mismatched collective operations for tensor "
                         f"{name}: {ops}. All ranks must submit the same "
                         f"operation.")
        if any(r.tensor_type != first.tensor_type for r in reqs):
            dts = {r.request_rank: r.tensor_type.name for r in reqs}
            return error(f"Mismatched data types for tensor {name}: {dts}.")
        if any(r.prescale_factor != first.prescale_factor or
               r.postscale_factor != first.postscale_factor for r in reqs):
            return error(f"Mismatched prescale/postscale factors for tensor "
                         f"{name}.")
        if any(r.codec != first.codec or
               r.codec_block_size != first.codec_block_size for r in reqs):
            # A rank decoding int8 blocks against a peer's raw payload
            # would corrupt silently — same failure class as a dtype
            # mismatch, same structured-ERROR answer (SURVEY §5.2).
            codecs = {r.request_rank: (r.codec, r.codec_block_size)
                      for r in reqs}
            return error(f"Mismatched compression codecs for tensor "
                         f"{name}: {codecs}. All ranks must use the same "
                         f"codec and block size.")

        if any((r.device < 0) != (first.device < 0) for r in reqs):
            # Upstream Horovod's check: one name on the CPU on one rank
            # and on a card on another would put one collective on two
            # planes.
            where = {r.request_rank: "CPU" if r.device < 0
                     else f"cuda:{r.device}" for r in reqs}
            return error(f"Mismatched CPU/GPU device selection for tensor "
                         f"{name}: {where}. All ranks must submit it on "
                         f"the CPU, or all on their card.")

        rtype = first.request_type
        joined = len(self.joined_ranks) > 0
        devices = [0] * self.size
        for r in reqs:
            if 0 <= r.request_rank < self.size:
                devices[r.request_rank] = r.device

        if rtype in (RequestType.ALLREDUCE, RequestType.ADASUM,
                     RequestType.REDUCESCATTER):
            if rtype == RequestType.REDUCESCATTER and joined:
                # A joined rank's zero stand-in has no shape, and the
                # dim-0 output split needs every rank's shape — same
                # category as allgather/broadcast under Join.
                return error("Reducescatter is not supported after a rank "
                             "has joined: all ranks must participate.")
            for r in reqs[1:]:
                if tuple(r.tensor_shape) != tuple(first.tensor_shape):
                    return error(
                        f"Mismatched {rtype.name.lower()} tensor shapes for "
                        f"tensor {name}: rank {r.request_rank} has shape "
                        f"{tuple(r.tensor_shape)}, rank "
                        f"{first.request_rank} has shape "
                        f"{tuple(first.tensor_shape)}.")
            if rtype == RequestType.ADASUM and \
                    first.codec in QUANTIZED_CODECS:
                # Adasum's per-layer dot products are computed on the
                # wire payload; quantized blocks would make the norms
                # meaningless.  Cast codecs (fp16/bf16) compose fine.
                return error("Adasum does not support quantized "
                             "compression codecs (int8/uint4); use none, "
                             "fp16 or bf16.")
            resp_type = {
                RequestType.ALLREDUCE: ResponseType.ALLREDUCE,
                RequestType.ADASUM: ResponseType.ADASUM,
                RequestType.REDUCESCATTER: ResponseType.REDUCESCATTER,
            }[rtype]
            return Response(
                response_type=resp_type, tensor_names=[name],
                devices=devices, tensor_type=first.tensor_type,
                tensor_sizes=[first.tensor_size_elements()],
                prescale_factor=first.prescale_factor,
                postscale_factor=first.postscale_factor,
                last_joined_rank=self.last_joined_rank,
                codec=first.codec,
                codec_block_size=first.codec_block_size,
                sp_spec=first.sp_spec)

        if rtype == RequestType.ALLGATHER:
            if joined:
                return error("Allgather is not supported after a rank has "
                             "joined: all ranks must participate.")
            for r in reqs[1:]:
                if len(r.tensor_shape) != len(first.tensor_shape) or \
                        tuple(r.tensor_shape[1:]) != tuple(first.tensor_shape[1:]):
                    return error(
                        f"Mismatched allgather tensor shapes for tensor "
                        f"{name}: all dimensions except the first must "
                        f"match (rank {r.request_rank}: "
                        f"{tuple(r.tensor_shape)} vs "
                        f"{tuple(first.tensor_shape)}).")
            sizes = [(r.tensor_shape[0] if r.tensor_shape else 1)
                     for r in reqs]
            return Response(response_type=ResponseType.ALLGATHER,
                            tensor_names=[name], devices=devices,
                            tensor_type=first.tensor_type,
                            tensor_sizes=sizes,
                            sp_spec=first.sp_spec)

        if rtype == RequestType.BROADCAST:
            if joined:
                return error("Broadcast is not supported after a rank has "
                             "joined: all ranks must participate.")
            if any(r.root_rank != first.root_rank for r in reqs):
                roots = {r.request_rank: r.root_rank for r in reqs}
                return error(f"Mismatched broadcast root ranks for tensor "
                             f"{name}: {roots}.")
            root = next((r for r in reqs
                         if r.request_rank == first.root_rank), first)
            for r in reqs:
                if tuple(r.tensor_shape) != tuple(root.tensor_shape):
                    return error(
                        f"Mismatched broadcast tensor shapes for tensor "
                        f"{name}: rank {r.request_rank} has "
                        f"{tuple(r.tensor_shape)}, root has "
                        f"{tuple(root.tensor_shape)}.")
            return Response(response_type=ResponseType.BROADCAST,
                            tensor_names=[name], devices=devices,
                            tensor_type=first.tensor_type,
                            tensor_sizes=[root.tensor_size_elements()],
                            root_rank=first.root_rank,
                            sp_spec=first.sp_spec)

        if rtype == RequestType.ALLTOALL:
            if joined:
                return error("Alltoall is not supported after a rank has "
                             "joined: all ranks must participate.")
            for r in reqs[1:]:
                if tuple(r.tensor_shape[1:]) != tuple(first.tensor_shape[1:]):
                    return error(
                        f"Mismatched alltoall tensor shapes for tensor "
                        f"{name}: trailing dimensions must match.")
            return Response(response_type=ResponseType.ALLTOALL,
                            tensor_names=[name], devices=devices,
                            tensor_type=first.tensor_type)

        if rtype == RequestType.BARRIER:
            return Response(response_type=ResponseType.BARRIER,
                            tensor_names=[name])

        return error(f"Unsupported request type {rtype} for tensor {name}.")

    # -- FuseResponses (reference: controller.cc:778-915) --------------
    def _response_payload_bytes(self, resp: Response) -> int:
        """Bytes a response contributes to a fusion buffer.  Allreduce:
        element count × element size.  Allgather: OUTPUT bytes —
        sum of per-rank first dims × the entry's trailing-dim element
        count (reference: controller.cc:917-937
        TotalByteSizeOfAllgatherOutput, looked up via the tensor queue
        exactly as the reference does).  Fusion-determinism invariant:
        every rank that reaches here with an allgather response HAS the
        entry — it submitted the request (a joined rank invalidates
        cached allgather bits instead of asserting them, so these
        responses never execute there), and trailing dims are cross-rank
        validated equal — so the computed size is identical on all ranks.
        The KeyError arm is defensive only."""
        esz = element_size(resp.tensor_type)
        total = sum(resp.tensor_sizes)
        if resp.response_type == ResponseType.ALLGATHER:
            try:
                entry = self.tensor_queue.get_tensor_entry(
                    resp.tensor_names[0])
                shape = getattr(entry.tensor, "shape", ())
                rest = 1
                for d in shape[1:]:
                    rest *= int(d)
            except KeyError:   # defensive: see docstring
                rest = 1
            return total * rest * esz
        return total * esz

    def fuse_responses(self, responses: list[Response]) -> list[Response]:
        """Greedy fusion with look-ahead: merge compatible
        allreduce/adasum/allgather responses until the fusion-buffer
        threshold is reached.  Later compatible responses may be pulled
        forward past incompatible ones — legal because the merged order
        is identical on all ranks.  A fused allgather response keeps one
        world_size block of per-rank first dims per entry in
        tensor_sizes (reference: message.cc:380-388
        Response::add_allgather_response)."""
        threshold = self.fusion_threshold_bytes()
        if threshold <= 0:
            return list(responses)
        fusable = {ResponseType.ALLREDUCE, ResponseType.ADASUM,
                   ResponseType.ALLGATHER}
        out: list[Response] = []
        pending = list(responses)
        i = 0
        while i < len(pending):
            resp = pending[i]
            i += 1
            if resp.response_type not in fusable or not resp.tensor_sizes:
                out.append(resp)
                continue
            if self.disable_group_fusion and getattr(resp, "grouped", False):
                out.append(resp)
                continue
            acc_bytes = self._response_payload_bytes(resp)
            if acc_bytes >= threshold:
                out.append(resp)
                continue
            j = i
            while j < len(pending) and acc_bytes < threshold:
                cand = pending[j]
                if (cand.response_type == resp.response_type and
                        cand.tensor_type == resp.tensor_type and
                        cand.devices == resp.devices and
                        cand.prescale_factor == resp.prescale_factor and
                        cand.postscale_factor == resp.postscale_factor and
                        cand.codec == resp.codec and
                        cand.codec_block_size == resp.codec_block_size and
                        cand.tensor_sizes and
                        not (self.disable_group_fusion and
                             getattr(cand, "grouped", False))):
                    cand_bytes = self._response_payload_bytes(cand)
                    if acc_bytes + cand_bytes <= threshold:
                        resp.tensor_names.extend(cand.tensor_names)
                        resp.tensor_sizes.extend(cand.tensor_sizes)
                        acc_bytes += cand_bytes
                        pending.pop(j)
                        continue
                j += 1
            out.append(resp)
        return out

    # ------------------------------------------------------------------
    def reset(self) -> None:
        self._message_table.clear()
        self._arrival_counter = 0
        self.joined_ranks.clear()
        self.last_joined_rank = -1
        self._local_hits.clear()
        self._last_request_params.clear()
        self.response_cache.clear()
        self.fingerprint.reset()
        self._tm_cycles = 0
        self._tm_cycle_ms = 0.0
        self._tm_sync_wait_ms = 0.0
        self._gather_arrivals.clear()
        self._trace_cycle = 0
