"""LRU response cache + bitvector coordination state.

The port's copy of ``horovod_tpu/common/response_cache.py``.

Reference: horovod/common/response_cache.{cc,h}:45-169 and its use in
controller.cc:81-237.  Purpose: in steady state every step submits the same
tensors, so instead of re-gathering full RequestLists each cycle, ranks sync
two fixed-size bitvectors (hits AND, invalid/flags OR) and execute the cached
fused Responses directly — collapsing the control plane to two small
allreduces per cycle.

Cache entries occupy stable bit positions so the bitvectors mean the same
thing on every rank; eviction invalidates the position everywhere via the
"invalid" bitvector on the next sync.
"""
from __future__ import annotations

import enum
from collections import OrderedDict
from dataclasses import dataclass, replace

from .dtypes import DataType
from .message import Request, Response, ResponseType


class CacheState(enum.IntEnum):
    MISS = 0
    HIT = 1
    INVALID = 2


@dataclass(frozen=True)
class _Params:
    """Per-tensor parameters that must match for a cache hit."""
    response_type: ResponseType
    tensor_type: DataType
    shape: tuple[int, ...]
    root_rank: int
    device: int
    prescale_factor: float
    postscale_factor: float
    last_joined_rank: int
    codec: int
    codec_block_size: int


def _params_of(request: Request, joined_size: int) -> _Params:
    from .message import RequestType
    rt = {
        RequestType.ALLREDUCE: ResponseType.ALLREDUCE,
        RequestType.ALLGATHER: ResponseType.ALLGATHER,
        RequestType.BROADCAST: ResponseType.BROADCAST,
        RequestType.ALLTOALL: ResponseType.ALLTOALL,
        RequestType.ADASUM: ResponseType.ADASUM,
        RequestType.REDUCESCATTER: ResponseType.REDUCESCATTER,
        RequestType.BARRIER: ResponseType.BARRIER,
    }[request.request_type]
    return _Params(rt, request.tensor_type, tuple(request.tensor_shape),
                   request.root_rank, request.device,
                   request.prescale_factor, request.postscale_factor,
                   joined_size, request.codec, request.codec_block_size)


class ResponseCache:
    def __init__(self, capacity: int = 0) -> None:
        self._capacity = capacity
        # name -> (bit position, Response, params); ordered LRU (front = LRU)
        self._entries: OrderedDict[str, tuple[int, Response, _Params]] = OrderedDict()
        self._free_positions: list[int] = list(range(capacity - 1, -1, -1))
        self._by_position: dict[int, str] = {}
        self.printed_caching_warning = False

    @property
    def capacity(self) -> int:
        return self._capacity

    def enabled(self) -> bool:
        return self._capacity > 0

    def cached(self, request: Request, joined_size: int = 0) -> CacheState:
        ent = self._entries.get(request.tensor_name)
        if ent is None:
            return CacheState.MISS
        _, _, params = ent
        if params == _params_of(request, joined_size):
            return CacheState.HIT
        return CacheState.INVALID

    def put(self, response: Response, request: Request, joined_size: int = 0) -> None:
        """Cache a single-tensor response (fusion happens after lookup)."""
        if not self.enabled():
            return
        name = request.tensor_name
        if name in self._entries:
            pos, _, _ = self._entries.pop(name)
        else:
            if not self._free_positions:
                # Evict LRU entry; its position is recycled and will be
                # broadcast as invalid on the next coordination cycle.
                old_name, (pos, _, _) = self._entries.popitem(last=False)
                self._by_position.pop(pos, None)
            else:
                pos = self._free_positions.pop()
        # Store a private copy — the caller's object flows on into fusion
        # and execution and may be mutated there.  The trace id is reset:
        # it names ONE negotiated instance, and every later cache hit is
        # a new collective that gets a fresh id at assembly
        # (controller._stamp_trace_ids) — a stale id would alias two
        # different steps in the merged cross-rank trace.
        stored = replace(response, tensor_names=list(response.tensor_names),
                         tensor_sizes=list(response.tensor_sizes),
                         devices=list(response.devices),
                         trace_cycle=-1, trace_seq=-1)
        self._entries[name] = (pos, stored, _params_of(request, joined_size))
        self._by_position[pos] = name

    def peek_cache_position(self, name: str) -> int:
        return self._entries[name][0]

    def get_response_by_position(self, position: int) -> Response:
        name = self._by_position[position]
        pos, resp, params = self._entries.pop(name)
        self._entries[name] = (pos, resp, params)   # refresh LRU
        # Return a copy: downstream fusion mutates tensor_names/sizes in
        # place and must never corrupt the cached entry.
        return replace(resp, tensor_names=list(resp.tensor_names),
                       tensor_sizes=list(resp.tensor_sizes),
                       devices=list(resp.devices))

    def response_type_by_position(self, position: int):
        """Type of the cached response, without the defensive copy (and
        LRU refresh) get_response_by_position pays — for per-cycle scans
        like the joined-rank bit loop that only need the type."""
        return self._entries[self._by_position[position]][1].response_type

    def erase_by_position(self, position: int) -> None:
        name = self._by_position.pop(position, None)
        if name is not None:
            self._entries.pop(name, None)
            self._free_positions.append(position)

    def erase(self, name: str) -> None:
        ent = self._entries.pop(name, None)
        if ent is not None:
            pos = ent[0]
            self._by_position.pop(pos, None)
            self._free_positions.append(pos)

    def positions(self) -> list[int]:
        return [pos for pos, _, _ in self._entries.values()]

    def num_active_bits(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self._by_position.clear()
        self._free_positions = list(range(self._capacity - 1, -1, -1))


class CacheCoordinator:
    """Per-cycle bitvector state synced across ranks.

    Reference: response_cache.h CacheCoordinator + controller.cc
    CoordinateCacheAndState (751-776): one bitwise-AND allreduce over
    [hit bits] and one bitwise-OR allreduce over [invalid bits | flags].
    """

    FLAG_SHUTDOWN = 0
    FLAG_UNCACHED_IN_QUEUE = 1
    FLAG_SHOULD_SYNC = 2
    NUM_FLAGS = 3

    def __init__(self, num_bits: int) -> None:
        self.num_bits = num_bits
        self.hit_bits: set[int] = set()
        self.invalid_bits: set[int] = set()
        self.shutdown = False
        self.uncached_in_queue = False
        self.should_sync = False   # another sync round needed after this one

    def record_hit(self, position: int) -> None:
        self.hit_bits.add(position)

    def record_invalid(self, position: int) -> None:
        self.invalid_bits.add(position)

    def pack(self) -> tuple[int, int]:
        """Return (and_word, or_word) integer bitsets.

        and_word: bit i set ⇔ tensor at cache position i is hit locally.
        or_word: low flag bits then invalid bits (offset by NUM_FLAGS).
        """
        and_word = 0
        for b in self.hit_bits:
            and_word |= 1 << b
        or_word = 0
        if self.shutdown:
            or_word |= 1 << self.FLAG_SHUTDOWN
        if self.uncached_in_queue:
            or_word |= 1 << self.FLAG_UNCACHED_IN_QUEUE
        if self.should_sync:
            or_word |= 1 << self.FLAG_SHOULD_SYNC
        for b in self.invalid_bits:
            or_word |= 1 << (b + self.NUM_FLAGS)
        return and_word, or_word

    def unpack(self, and_word: int, or_word: int) -> None:
        """Apply globally reduced words back onto this coordinator."""
        self.shutdown = bool(or_word & (1 << self.FLAG_SHUTDOWN))
        self.uncached_in_queue = bool(or_word & (1 << self.FLAG_UNCACHED_IN_QUEUE))
        self.should_sync = bool(or_word & (1 << self.FLAG_SHOULD_SYNC))
        invalid = set()
        hits = set()
        word = or_word >> self.NUM_FLAGS
        pos = 0
        while word:
            if word & 1:
                invalid.add(pos)
            word >>= 1
            pos += 1
        word = and_word
        pos = 0
        while word:
            if word & 1 and pos not in invalid:
                hits.add(pos)
            word >>= 1
            pos += 1
        self.invalid_bits = invalid
        self.hit_bits = hits
