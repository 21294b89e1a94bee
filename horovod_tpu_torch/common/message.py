"""Control-plane message types: Request / RequestList / Response / ResponseList.

The port's copy of ``horovod_tpu/common/message.py``.

TPU-native rebuild of the reference message layer
(reference: horovod/common/message.h:50-251, message.cc, wire/message.fbs).
Semantics preserved:

- a `Request` announces "rank R's tensor named N with dtype/shape S is ready
  for collective op T";
- workers batch them into a `RequestList` gathered by the coordinator;
- the coordinator validates cross-rank consistency and answers with fused
  `Response`s (one response may carry many tensor names = one fused buffer);
- every rank executes the identical `ResponseList` in identical order — the
  deadlock-freedom invariant (reference: SURVEY §5.8).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

from .dtypes import DataType
from .wire import (FEATURE_FINGERPRINT, FEATURE_SHARDING, FEATURE_TELEMETRY,
                   FEATURE_TRACE, FEATURES_ALL, Decoder, Encoder)


class RequestType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6
    REDUCESCATTER = 7


class ResponseType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6
    REDUCESCATTER = 7
    ERROR = 8


@dataclass
class Request:
    request_rank: int = 0
    request_type: RequestType = RequestType.ALLREDUCE
    tensor_type: DataType = DataType.FLOAT32
    tensor_name: str = ""
    root_rank: int = -1
    device: int = -1
    tensor_shape: tuple[int, ...] = ()
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    # Wire-compression codec (compress.CompressionCodec value) + block
    # size for the quantized codecs.  Negotiated like every other request
    # parameter: the coordinator rejects cross-rank mismatches with a
    # structured ERROR (a rank reducing int8 blocks against a peer's raw
    # fp32 would corrupt silently).
    codec: int = 0
    codec_block_size: int = 0
    # Canonical sharding-spec token (analysis/hvdshard/specs.py
    # spec_token): the mesh-axis tuple string this rank believes the
    # tensor is partitioned over, "" = unannotated/replicated.  Part of
    # collective identity (op×name×dtype×dims×spec) folded into the
    # runtime fingerprint, so two ranks disagreeing on *how* a tensor is
    # sharded diverge loudly instead of silently re-replicating.
    sp_spec: str = ""

    def tensor_size_elements(self) -> int:
        n = 1
        for d in self.tensor_shape:
            n *= d
        return n

    def encode(self, enc: Encoder,
               features: int = FEATURES_ALL) -> None:
        (enc.uvarint(self.request_rank)
            .uvarint(int(self.request_type))
            .uvarint(int(self.tensor_type))
            .string(self.tensor_name)
            .svarint(self.root_rank)
            .svarint(self.device)
            .svarint_list(list(self.tensor_shape))
            .f64(self.prescale_factor)
            .f64(self.postscale_factor)
            .uvarint(self.codec)
            .uvarint(self.codec_block_size))
        if features & FEATURE_SHARDING:
            enc.string(self.sp_spec)

    @classmethod
    def decode(cls, dec: Decoder,
               features: int = FEATURES_ALL) -> "Request":
        req = cls(
            request_rank=dec.uvarint(),
            request_type=RequestType(dec.uvarint()),
            tensor_type=DataType(dec.uvarint()),
            tensor_name=dec.string(),
            root_rank=dec.svarint(),
            device=dec.svarint(),
            tensor_shape=tuple(dec.svarint_list()),
            prescale_factor=dec.f64(),
            postscale_factor=dec.f64(),
            codec=dec.uvarint(),
            codec_block_size=dec.uvarint(),
        )
        if features & FEATURE_SHARDING:
            req.sp_spec = dec.string()
        return req


@dataclass
class RequestList:
    requests: list[Request] = field(default_factory=list)
    shutdown: bool = False
    # Collective-fingerprint stream state (analysis/fingerprint.py;
    # HOROVOD_FINGERPRINT).  fp_seq counts ops this rank has folded into
    # its rolling 64-bit digest; the tail lists carry the last
    # HOROVOD_FINGERPRINT_WINDOW (seq, digest-after, descriptor) records
    # so the coordinator can locate the FIRST divergent op, not just the
    # fact of divergence.  Kept as parallel primitive lists so the wire
    # layer stays free of analysis-layer imports.
    fp_seq: int = 0
    fp_digest: int = 0
    fp_tail_seqs: list[int] = field(default_factory=list)
    fp_tail_digests: list[int] = field(default_factory=list)
    fp_tail_descs: list[str] = field(default_factory=list)
    # Bounded telemetry snapshot (telemetry/straggler.py; HOROVOD_METRICS).
    # Four scalars — cycles in the window, summed cycle wall time, summed
    # control-plane sync wait, queue depth at negotiation — ride every
    # gathered RequestList so the coordinator can export per-rank gauges
    # without any extra collective.  All zero when metrics are off.
    tm_cycles: int = 0
    tm_cycle_ms: float = 0.0
    tm_sync_wait_ms: float = 0.0
    tm_queue_depth: int = 0

    def to_bytes(self, features: int = FEATURES_ALL) -> bytes:
        """`features` is the mesh-negotiated wire schema (HELLO
        handshake): every optional field group is gated on its feature
        bit, symmetrically with :meth:`from_bytes`, so mixed-version
        worlds exchange only the min common schema."""
        enc = Encoder()
        enc.bool_(self.shutdown)
        if features & FEATURE_FINGERPRINT:
            enc.uvarint(self.fp_seq)
            enc.uvarint(self.fp_digest)
            enc.uvarint_list(self.fp_tail_seqs)
            enc.uvarint_list(self.fp_tail_digests)
            enc.string_list(self.fp_tail_descs)
        if features & FEATURE_TELEMETRY:
            enc.uvarint(self.tm_cycles)
            enc.f64(self.tm_cycle_ms)
            enc.f64(self.tm_sync_wait_ms)
            enc.uvarint(self.tm_queue_depth)
        enc.uvarint(len(self.requests))
        for r in self.requests:
            r.encode(enc, features)
        return enc.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes,
                   features: int = FEATURES_ALL) -> "RequestList":
        dec = Decoder(raw)
        shutdown = dec.bool_()
        fp_seq = fp_digest = 0
        fp_tail_seqs: list[int] = []
        fp_tail_digests: list[int] = []
        fp_tail_descs: list[str] = []
        tm_cycles = tm_queue_depth = 0
        tm_cycle_ms = tm_sync_wait_ms = 0.0
        if features & FEATURE_FINGERPRINT:
            fp_seq = dec.uvarint()
            fp_digest = dec.uvarint()
            fp_tail_seqs = dec.uvarint_list()
            fp_tail_digests = dec.uvarint_list()
            fp_tail_descs = dec.string_list()
        if features & FEATURE_TELEMETRY:
            tm_cycles = dec.uvarint()
            tm_cycle_ms = dec.f64()
            tm_sync_wait_ms = dec.f64()
            tm_queue_depth = dec.uvarint()
        n = dec.uvarint()
        return cls(requests=[Request.decode(dec, features)
                             for _ in range(n)],
                   shutdown=shutdown, fp_seq=fp_seq, fp_digest=fp_digest,
                   fp_tail_seqs=fp_tail_seqs,
                   fp_tail_digests=fp_tail_digests,
                   fp_tail_descs=fp_tail_descs,
                   tm_cycles=tm_cycles, tm_cycle_ms=tm_cycle_ms,
                   tm_sync_wait_ms=tm_sync_wait_ms,
                   tm_queue_depth=tm_queue_depth)


@dataclass
class Response:
    response_type: ResponseType = ResponseType.ALLREDUCE
    tensor_names: list[str] = field(default_factory=list)
    error_message: str = ""
    devices: list[int] = field(default_factory=list)
    # Allgather/alltoall: per-rank first-dim sizes so every rank can size the
    # output buffer (reference: message.h tensor_sizes()).
    tensor_sizes: list[int] = field(default_factory=list)
    tensor_type: DataType = DataType.FLOAT32
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    # Ranks that have joined (zero-filled stand-ins participate on their
    # behalf; reference: controller.cc:254-308).
    last_joined_rank: int = -1
    root_rank: int = -1          # broadcast root
    grouped: bool = False        # built from an explicit tensor group
    # Negotiated wire-compression codec the data planes must apply
    # (identical on every rank by construction — see Request.codec).
    codec: int = 0
    codec_block_size: int = 0
    # Distributed-trace id (mirrors the fp_* wire-field pattern): the coordinator assigns a monotone
    # (cycle, seq) pair to every negotiated collective so each rank's
    # Timeline spans — and the flight-recorder events — for the SAME
    # collective carry the SAME id and can be stitched into one
    # cross-rank flow.  -1 = unassigned (legacy frames, unit fixtures).
    # Cache-steady-state responses never ride the wire; they are stamped
    # locally from counters that advance in lockstep on every rank (the
    # deadlock-freedom invariant makes the local stamp rank-identical).
    trace_cycle: int = -1
    trace_seq: int = -1
    # Negotiated sharding-spec token the data planes must honour
    # (identical on every rank by construction — see Request.sp_spec;
    # the coordinator rejects cross-rank spec mismatches with a
    # structured ERROR before any response is built).
    sp_spec: str = ""

    def encode(self, enc: Encoder,
               features: int = FEATURES_ALL) -> None:
        (enc.uvarint(int(self.response_type))
            .string_list(self.tensor_names)
            .string(self.error_message)
            .svarint_list(self.devices)
            .svarint_list(self.tensor_sizes)
            .uvarint(int(self.tensor_type))
            .f64(self.prescale_factor)
            .f64(self.postscale_factor)
            .svarint(self.last_joined_rank)
            .svarint(self.root_rank)
            .bool_(self.grouped)
            .uvarint(self.codec)
            .uvarint(self.codec_block_size))
        if features & FEATURE_TRACE:
            enc.svarint(self.trace_cycle)
            enc.svarint(self.trace_seq)
        if features & FEATURE_SHARDING:
            enc.string(self.sp_spec)

    @classmethod
    def decode(cls, dec: Decoder,
               features: int = FEATURES_ALL) -> "Response":
        resp = cls(
            response_type=ResponseType(dec.uvarint()),
            tensor_names=dec.string_list(),
            error_message=dec.string(),
            devices=dec.svarint_list(),
            tensor_sizes=dec.svarint_list(),
            tensor_type=DataType(dec.uvarint()),
            prescale_factor=dec.f64(),
            postscale_factor=dec.f64(),
            last_joined_rank=dec.svarint(),
            root_rank=dec.svarint(),
            grouped=dec.bool_(),
            codec=dec.uvarint(),
            codec_block_size=dec.uvarint(),
        )
        if features & FEATURE_TRACE:
            resp.trace_cycle = dec.svarint()
            resp.trace_seq = dec.svarint()
        if features & FEATURE_SHARDING:
            resp.sp_spec = dec.string()
        return resp

    def trace_id(self) -> str | None:
        """Compact "cycle.seq" form used in Timeline span args and flow
        events, or None while unassigned."""
        if self.trace_cycle < 0 or self.trace_seq < 0:
            return None
        return f"{self.trace_cycle}.{self.trace_seq}"


@dataclass
class ResponseList:
    responses: list[Response] = field(default_factory=list)
    shutdown: bool = False
    # Autotuned parameters broadcast from the coordinator
    # (reference: Controller::SynchronizeParameters, controller.cc:39-53).
    tuned_fusion_threshold: int = -1
    tuned_cycle_time_ms: float = -1.0
    # Autotuned default wire codec (-1 = unchanged): lets the parameter
    # manager flip HOROVOD_COMPRESSION at runtime on every rank in the
    # same cycle.
    tuned_codec: int = -1
    # Autotuned TCP-pipeline knobs (-1 = unchanged): segment granularity
    # for the ring's segmented receive+accumulate, and the number of
    # active dispatch streams (capped by HOROVOD_NUM_STREAMS, whose
    # channel sets were formed at init).  Applied by every rank BEFORE
    # executing this list's responses so stream assignment stays
    # rank-symmetric.
    tuned_segment_bytes: int = -1
    tuned_num_streams: int = -1
    # Autotuned fused-codec-kernel dispatch (-1 = unchanged, else 0/1):
    # flips HOROVOD_FUSED_KERNELS at runtime on every rank in the same
    # cycle (compress/fused.py single-pass legs vs the reference chain).
    tuned_fused: int = -1
    # Autotuned allreduce algorithm (-1 = unchanged, else an index into
    # common/topology.ALGO_NAMES) and tree/ring crossover threshold in
    # bytes (-1 = unchanged).  Broadcast like every other tuned field and
    # applied by all ranks BEFORE dispatch, so algorithm choice can never
    # diverge across ranks (the deadlock-freedom invariant).
    tuned_algo: int = -1
    tuned_tree_threshold: int = -1

    def to_bytes(self, features: int = FEATURES_ALL) -> bytes:
        enc = Encoder()
        enc.bool_(self.shutdown)
        enc.svarint(self.tuned_fusion_threshold)
        enc.f64(self.tuned_cycle_time_ms)
        enc.svarint(self.tuned_codec)
        enc.svarint(self.tuned_segment_bytes)
        enc.svarint(self.tuned_num_streams)
        enc.svarint(self.tuned_fused)
        enc.svarint(self.tuned_algo)
        enc.svarint(self.tuned_tree_threshold)
        enc.uvarint(len(self.responses))
        for r in self.responses:
            r.encode(enc, features)
        return enc.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes,
                   features: int = FEATURES_ALL) -> "ResponseList":
        dec = Decoder(raw)
        shutdown = dec.bool_()
        threshold = dec.svarint()
        cycle = dec.f64()
        codec = dec.svarint()
        segment = dec.svarint()
        streams = dec.svarint()
        fused = dec.svarint()
        algo = dec.svarint()
        tree_threshold = dec.svarint()
        n = dec.uvarint()
        return cls(responses=[Response.decode(dec, features)
                              for _ in range(n)],
                   shutdown=shutdown,
                   tuned_fusion_threshold=threshold,
                   tuned_cycle_time_ms=cycle,
                   tuned_codec=codec,
                   tuned_segment_bytes=segment,
                   tuned_num_streams=streams,
                   tuned_fused=fused,
                   tuned_algo=algo,
                   tuned_tree_threshold=tree_threshold)
