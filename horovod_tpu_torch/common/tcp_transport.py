"""Controller transport over TCP sockets — the Gloo-controller equivalent.

The port's copy of ``horovod_tpu/common/tcp_transport.py`` (``TcpTransport``
with its clock-offset probe), without the statesync frame verbs and the
poison frames of fault tolerance (ROADMAP queue A item 11):
a dead peer surfaces as the socket's ConnectionError, which ends the
background loop, as in the reference with fault tolerance off.

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
from .message import RequestList, ResponseList
from ..runner.network import PeerMesh

_WORDLEN = struct.Struct(">I")

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
            for _, raw in self.mesh.recv_in_arrival_order(
                    range(1, self.size)):
                a, o = _unpack_words(raw)
                and_word &= a
                or_word |= o
            payload = _pack_words(and_word, or_word)
            for peer in range(1, self.size):
                self.mesh.send(peer, payload)
            return and_word, or_word
        self.mesh.send(0, _pack_words(and_word, or_word))
        return _unpack_words(self.mesh.recv(0))

    # -- RequestList gather (reference: gloo_controller.cc allgatherv) ---
    def gather_requests(self, request_list: RequestList):
        if self.size == 1:
            return [request_list]
        if self.rank == 0:
            # Arrival-order drain; the result stays rank-indexed.
            lists: list[RequestList | None] = [None] * self.size
            lists[0] = self._mask_unnegotiated(request_list)
            arrivals = {0: time.monotonic()}
            for peer, raw in self.mesh.recv_in_arrival_order(
                    range(1, self.size)):
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
            for peer in range(1, self.size):
                self.mesh.send(peer, payload)
            return response_list
        return ResponseList.from_bytes(self.mesh.recv(0), self.features)

    def barrier(self) -> None:
        if self.size == 1:
            return
        if self.rank == 0:
            for _ in self.mesh.recv_in_arrival_order(range(1, self.size)):
                pass
            for peer in range(1, self.size):
                self.mesh.send(peer, b"\x01")
        else:
            self.mesh.send(0, b"\x01")
            self.mesh.recv(0)
