"""Controller transport over TCP sockets — the Gloo-controller equivalent.

The port's copy of ``horovod_tpu/common/tcp_transport.py`` (``TcpTransport``
with its clock-offset probe and the poison frames of fault tolerance:
``POISON_MAGIC``, ``check_poison``, ``broadcast_poison`` and the
coordinator's drains that poison the survivors on a detected failure)
and the state-frame verb of statesync's peer streaming (``STATE_MAGIC``,
the six ``STATE_*`` kinds, ``pack_state_frame``/``unpack_state_frame``),
whose frames are bitwise the reference's.

Reference: horovod/common/gloo/gloo_controller.cc:35-199 — the same
coordination protocol as MPI (request gather to rank 0, response broadcast,
bitvector sync) but over point-to-point TCP bootstrapped from the rendezvous
KV store.  Here all three primitives run over a dedicated PeerMesh (separate
from the bulk data-plane mesh so control never queues behind tensor bytes).
"""
from __future__ import annotations

import struct
import time

from .controller import Transport
from .exceptions import RanksFailedError
from .logging import logger
from .message import RequestList, ResponseList
from ..runner.network import PeerMesh

_WORDLEN = struct.Struct(">I")

# Poison/abort frame (resilience/): when the coordinator's bounded drain
# detects a dead or deadline-missing rank it broadcasts this frame to
# every surviving peer, whatever recv state that peer is blocked in
# (bitwise reply, ResponseList broadcast, barrier release) — the leading
# 0xff byte cannot open any legitimate control frame (bitwise payloads
# start with a 4-byte big-endian length <= 2^24, Request/ResponseList
# bytes with a bool), so one prefix test per control recv suffices.
# The payload is the RanksFailedError wire form, riding the same
# structured-ERROR path the fingerprint divergence errors use.
POISON_MAGIC = b"\xffHVDPOISON\xff"


def check_poison(raw) -> None:
    """Raise the carried RanksFailedError when `raw` is a poison frame."""
    if raw[:len(POISON_MAGIC)] == POISON_MAGIC:
        raise RanksFailedError.from_wire(
            bytes(raw[len(POISON_MAGIC):]).decode(errors="replace"))


# State-frame verb (statesync/): the frames peer-to-peer live-state
# streaming puts on its dedicated sync mesh (never on the ctrl/data
# meshes, so they can never interleave with protocol frames).  Layout:
#   STATE_MAGIC | u8 kind | u32 meta_len | meta json | payload
# The magic shares the poison frame's property — the leading 0xff byte
# cannot open any legitimate control frame — so a stray state frame on
# a control mesh is rejected at one prefix test, and vice versa.
STATE_MAGIC = b"\xffHVDSTATE\xff"
_STATE_HDR = struct.Struct(">BI")

# Frame kinds of the streaming protocol (stream.py documents the flow).
STATE_HELLO = 1     # joiner -> donor: open round (meta: join id, round)
STATE_META = 2      # donor -> joiner: snapshot stamp + byte total
STATE_REQ = 3       # joiner -> donor: request a byte range
STATE_DATA = 4      # donor -> joiner: one chunk (meta: offset/len/crc)
STATE_END = 5       # donor -> joiner: requested range fully streamed
STATE_BYE = 6       # joiner -> donor: transfer complete, stand down


def pack_state_frame(kind: int, meta: dict, payload=b"") -> bytes:
    """Encode one state frame (statesync wire verb)."""
    import json
    meta_raw = json.dumps(meta, sort_keys=True).encode()
    head = STATE_MAGIC + _STATE_HDR.pack(kind, len(meta_raw)) + meta_raw
    if not payload:
        return head
    return head + bytes(payload)


def unpack_state_frame(raw) -> tuple[int, dict, memoryview]:
    """Decode one state frame; raises ValueError on a non-state frame
    (every read of a statesync channel must go through here — the
    digest/epoch checks downstream only see frames this verb accepted)."""
    import json
    view = memoryview(raw) if not isinstance(raw, memoryview) \
        else raw
    n_magic = len(STATE_MAGIC)
    if bytes(view[:n_magic]) != STATE_MAGIC:
        raise ValueError(
            "not a state frame (bad magic); statesync channels carry "
            "only STATE_MAGIC frames")
    kind, meta_len = _STATE_HDR.unpack_from(view, n_magic)
    meta_start = n_magic + _STATE_HDR.size
    meta = json.loads(bytes(view[meta_start:meta_start + meta_len]))
    return kind, meta, view[meta_start + meta_len:]


def _pack_words(and_word: int, or_word: int) -> bytes:
    a = and_word.to_bytes((max(and_word.bit_length(), 1) + 7) // 8, "big")
    o = or_word.to_bytes((max(or_word.bit_length(), 1) + 7) // 8, "big")
    return _WORDLEN.pack(len(a)) + a + _WORDLEN.pack(len(o)) + o

def _unpack_words(raw: bytes) -> tuple[int, int]:
    (la,) = _WORDLEN.unpack_from(raw, 0)
    a = int.from_bytes(raw[4:4 + la], "big")
    (lo,) = _WORDLEN.unpack_from(raw, 4 + la)
    o = int.from_bytes(raw[8 + la:8 + la + lo], "big")
    return a, o


class TcpTransport(Transport):
    def __init__(self, mesh: PeerMesh) -> None:
        self.mesh = mesh
        self.rank = mesh.rank
        self.size = mesh.size
        # Mesh-negotiated wire schema (HELLO handshake at formation):
        # identical on every rank (min proto / AND of feature bits over
        # the full mesh), so the coordinator's single encoded payload
        # decodes on every peer and optional field groups stay
        # symmetric in a mixed-version world.
        self.features = mesh.negotiated_features
        # Coordinator-side: monotonic arrival time of each rank's last
        # gathered RequestList (telemetry straggler signal; the controller
        # reads it via getattr so LocalTransport needs no counterpart).
        self.last_gather_arrivals: dict[int, float] = {}

    def _mask_unnegotiated(self, request_list: RequestList):
        """The coordinator's own RequestList never crosses the wire, so
        its optional field groups survive even when the world
        negotiated them away — while every peer's decode as zeros.  Mask
        the un-negotiated groups on the local list too, so all ranks
        present the identical (absent) schema."""
        import dataclasses

        from .wire import (FEATURE_FINGERPRINT, FEATURE_SHARDING,
                           FEATURE_TELEMETRY)
        kw = {}
        if not self.features & FEATURE_FINGERPRINT:
            kw.update(fp_seq=0, fp_digest=0, fp_tail_seqs=[],
                      fp_tail_digests=[], fp_tail_descs=[])
        if not self.features & FEATURE_TELEMETRY:
            kw.update(tm_cycles=0, tm_cycle_ms=0.0,
                      tm_sync_wait_ms=0.0, tm_queue_depth=0)
        if not self.features & FEATURE_SHARDING and \
                any(r.sp_spec for r in request_list.requests):
            # sp_spec is per-Request, not list-level: blank each one.
            kw.update(requests=[dataclasses.replace(r, sp_spec="")
                                for r in request_list.requests])
        return dataclasses.replace(request_list, **kw) if kw \
            else request_list

    # -- poison broadcast (resilience/) ----------------------------------
    def broadcast_poison(self, exc: RanksFailedError) -> None:
        """Best-effort abort frame to every surviving peer: whatever
        control recv each is blocked in, its next frame is this one, so
        ALL ranks raise RanksFailedError within one detection window
        instead of deadlocking behind the dead rank."""
        payload = POISON_MAGIC + exc.to_wire().encode()
        for peer in range(self.size):
            if peer == self.rank or peer in exc.failed_ranks:
                continue
            try:
                self.mesh.send(peer, payload)
            except Exception:  # noqa: BLE001 - peer may be gone too
                logger.debug("poison frame to rank %d undeliverable",
                             peer, exc_info=True)

    def _drain_or_poison(self, gen):
        """Run a coordinator-side arrival-order drain; on a detected
        rank failure, poison the survivors BEFORE re-raising so the
        whole world converts the hang into the same structured error."""
        try:
            yield from gen
        except RanksFailedError as exc:
            self.broadcast_poison(exc)
            raise

    # -- clock-offset probes (cross-rank trace stitching) ---------------
    def estimate_clock_offset(self, rounds: int = 5) -> tuple[float, float]:
        """Estimate this rank's monotonic-clock offset against the
        coordinator via NTP-style round-trip probes: the worker stamps
        t0, the coordinator answers with its own monotonic time tc, the
        worker stamps t1; the minimum-RTT round gives
        ``offset = tc - (t0 + t1) / 2`` with error bounded by rtt/2.

        Runs ONCE at init, before the background loop touches the ctrl
        mesh, so the probe frames never interleave with protocol frames.
        The estimate is recorded as trace metadata (Timeline
        ``horovod_clock_sync``), never applied to timestamps.  Returns
        ``(offset_us, rtt_us)``; the coordinator returns ``(0.0, 0.0)``."""
        if self.size == 1:
            return 0.0, 0.0
        if self.rank == 0:
            for _ in range(rounds):
                for peer, _raw in self.mesh.recv_in_arrival_order(
                        range(1, self.size)):
                    self.mesh.send(peer,
                                   struct.pack("<d", time.monotonic()))
            return 0.0, 0.0
        best_rtt = float("inf")
        best_offset = 0.0
        for _ in range(rounds):
            t0 = time.monotonic()
            self.mesh.send(0, b"\x01")
            raw = self.mesh.recv(0)
            t1 = time.monotonic()
            check_poison(raw)
            (tc,) = struct.unpack("<d", bytes(raw))
            rtt = t1 - t0
            if rtt < best_rtt:
                best_rtt = rtt
                best_offset = tc - (t0 + t1) / 2.0
        return best_offset * 1e6, best_rtt * 1e6

    # -- bitvector sync (reference: gloo_controller.cc bitwise ops) ------
    def bitwise_sync(self, and_word: int, or_word: int) -> tuple[int, int]:
        if self.size == 1:
            return and_word, or_word
        if self.rank == 0:
            # Drain peers in ARRIVAL order (selectors), not rank order:
            # AND/OR are commutative, and one slow rank does not stall
            # the reads of every faster rank queued behind it.
            for _, raw in self._drain_or_poison(
                    self.mesh.recv_in_arrival_order(range(1, self.size))):
                a, o = _unpack_words(raw)
                and_word &= a
                or_word |= o
            payload = _pack_words(and_word, or_word)
            for peer in range(1, self.size):
                self.mesh.send(peer, payload)
            return and_word, or_word
        self.mesh.send(0, _pack_words(and_word, or_word))
        raw = self.mesh.recv(0)
        check_poison(raw)
        return _unpack_words(raw)

    # -- RequestList gather (reference: gloo_controller.cc allgatherv) ---
    def gather_requests(self, request_list: RequestList):
        if self.size == 1:
            return [request_list]
        if self.rank == 0:
            # Arrival-order drain; the result stays rank-indexed.
            lists: list[RequestList | None] = [None] * self.size
            lists[0] = self._mask_unnegotiated(request_list)
            arrivals = {0: time.monotonic()}
            for peer, raw in self._drain_or_poison(
                    self.mesh.recv_in_arrival_order(range(1, self.size))):
                arrivals[peer] = time.monotonic()
                lists[peer] = RequestList.from_bytes(raw, self.features)
            self.last_gather_arrivals = arrivals
            return lists
        self.mesh.send(0, request_list.to_bytes(self.features))
        return None

    # -- ResponseList broadcast ------------------------------------------
    def broadcast_responses(self, response_list):
        if self.size == 1:
            return response_list
        if self.rank == 0:
            payload = response_list.to_bytes(self.features)
            failure: RanksFailedError | None = None
            for peer in range(1, self.size):
                try:
                    self.mesh.send(peer, payload)
                except RanksFailedError as exc:
                    # Keep delivering to the SURVIVORS — a peer they can
                    # still hear from must not strand them — then poison.
                    failure = exc
            if failure is not None:
                self.broadcast_poison(failure)
                raise failure
            return response_list
        raw = self.mesh.recv(0)
        check_poison(raw)
        return ResponseList.from_bytes(raw, self.features)

    def barrier(self) -> None:
        if self.size == 1:
            return
        if self.rank == 0:
            for _ in self._drain_or_poison(
                    self.mesh.recv_in_arrival_order(range(1, self.size))):
                pass
            for peer in range(1, self.size):
                self.mesh.send(peer, b"\x01")
        else:
            self.mesh.send(0, b"\x01")
            check_poison(self.mesh.recv(0))
