"""Paged KV-block pool: free-list allocation, refcounted prefix
sharing, copy-on-write and LRU eviction (the vLLM discipline on the
serving replica; a copy of ``horovod_tpu/serving/kvpool.py``, with the
same chain hashes).

The dense layout reserves ``max_batch x max_seq`` KV tokens per
replica whether or not any sequence is that long, so max concurrent
sequences is pinned to the batch shape.  Here the same memory is cut
into fixed-size **blocks** (``HOROVOD_SERVE_BLOCK_TOKENS`` tokens each)
and every live sequence holds exactly the blocks its resident tokens
need, so the pool — token residency — is the concurrency bound, not the
batch shape.

This module is pure bookkeeping: block *ids*, refcounts, hashes and the
LRU.  The actual KV tensors live in the model's paged cache
(models/transformer.py) indexed by these ids; the replica
(serving/replica.py) is the only writer and performs the array copy
half of a COW.

Sharing model:

- **Prefix cache.**  Prompt blocks are content-addressed by an FNV-1a
  *chain* hash (the statesync digest family): each block's key folds
  its parent block's key with its own token ids, so a hit at block *k*
  certifies the whole prefix, not just one block.  ``lookup`` verifies
  the stored token ids before trusting a hash (a collision is a miss,
  never silent corruption).
- **Refcounts.**  A resident block is held by every sequence whose
  table points at it.  ``deref`` to zero parks a *published* (hashed)
  block on the LRU instead of freeing it — that is the prompt cache —
  and frees an unpublished one immediately.
- **Copy-on-write.**  Published blocks are immutable (their hash
  certifies their contents) and shared blocks are not exclusively
  owned, so a sequence about to write into either gets a private copy
  first (``cow``); the first divergent write is the COW point.
- **Eviction.**  ``alloc`` under pressure evicts LRU refcount-0 cached
  blocks (oldest hit first) before reporting exhaustion; exhaustion is
  back-pressure to the batcher, never an error mid-decode (admission
  reserves worst-case blocks up front).
"""
from __future__ import annotations

from collections import OrderedDict, deque

from ..common import config
from ..telemetry.registry import MetricsRegistry

__all__ = ["FNV_SEED", "KVBlockPool", "chain_hash"]

# FNV-1a, the same family the statesync digests and the collective
# fingerprints fold with.
_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_FNV_MASK = (1 << 64) - 1

FNV_SEED = _FNV_OFFSET


def chain_hash(parent: int, tokens) -> int:
    """Fold one block's token ids into its parent's chain key: the
    block's identity is (everything before it, its own tokens)."""
    h = parent & _FNV_MASK
    for t in tokens:
        v = int(t) & 0xffffffff
        for _ in range(4):
            h = ((h ^ (v & 0xff)) * _FNV_PRIME) & _FNV_MASK
            v >>= 8
    return h


class KVBlockPool:
    """Per-replica paged KV block bookkeeping (ids only — see module
    docstring for the tensor half)."""

    def __init__(self, num_blocks: int | None = None,
                 block_tokens: int | None = None, registry=None) -> None:
        self.block_tokens = config.SERVE_BLOCK_TOKENS.get() \
            if block_tokens is None else int(block_tokens)
        self.num_blocks = config.SERVE_POOL_BLOCKS.get() \
            if num_blocks is None else int(num_blocks)
        if self.num_blocks <= 0 or self.block_tokens <= 0:
            raise ValueError(
                f"KVBlockPool needs positive sizes, got "
                f"{self.num_blocks} blocks x {self.block_tokens} tokens")
        self._free: deque[int] = deque(range(self.num_blocks))
        self._ref = [0] * self.num_blocks
        # Published (content-addressed) blocks: hash -> block id, plus
        # the reverse map and the token ids backing collision checks.
        self._by_hash: dict[int, int] = {}
        self._hash_of: dict[int, int] = {}
        self._tokens_of: dict[int, tuple] = {}
        # Refcount-0 published blocks, LRU order (oldest first).
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._closed = False
        if registry is None:
            # The pool is control state, not just observability: its
            # gauges and counters back kv_stats() and the leak census
            # (the AdmissionController convention).
            registry = MetricsRegistry(0)
        self._m_blocks = {
            state: registry.gauge(
                "horovod_serve_kv_blocks",
                "Paged KV blocks by state (free = allocatable, active "
                "= referenced by a live sequence, cached = refcount-0 "
                "prefix blocks parked on the LRU)",
                labels={"state": state})
            for state in ("free", "active", "cached")}
        self._m_hits = registry.counter(
            "horovod_serve_prefix_hits_total",
            "Prompt blocks served from the prefix cache (refcount bump "
            "instead of a re-prefill)")
        self._m_misses = registry.counter(
            "horovod_serve_prefix_misses_total",
            "Prompt blocks that had to be prefilled (no resident "
            "content-addressed match)")
        self._m_evicted = registry.counter(
            "horovod_serve_kv_evictions_total",
            "Cached prefix blocks evicted (LRU) to satisfy allocation")
        self._m_cow = registry.counter(
            "horovod_serve_kv_cow_total",
            "Copy-on-write block copies (first divergent write into a "
            "shared or published block)")
        self._update_gauges()

    # -- occupancy views --------------------------------------------------
    def free_count(self) -> int:
        return len(self._free)

    def cached_count(self) -> int:
        return len(self._lru)

    def active_count(self) -> int:
        """Blocks referenced by at least one live sequence — the leak
        census number: zero once every admitted request completed."""
        return self.num_blocks - len(self._free) - len(self._lru)

    def available(self) -> int:
        """Blocks allocatable right now (free + evictable cached)."""
        return len(self._free) + len(self._lru)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def is_shared(self, block: int) -> bool:
        """True when a write into ``block`` needs a COW first: another
        sequence holds it too, or its published hash certifies its
        current contents."""
        return self._ref[block] > 1 or block in self._hash_of

    def _update_gauges(self) -> None:
        self._m_blocks["free"].set(len(self._free))
        self._m_blocks["cached"].set(len(self._lru))
        self._m_blocks["active"].set(self.active_count())

    # -- allocation -------------------------------------------------------
    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` blocks (refcount 1 each), evicting LRU cached
        blocks as needed; None when even eviction cannot cover it (the
        caller defers the admission — back-pressure, not an error)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.available():
            return None
        out = []
        for _ in range(n):
            if not self._free:
                self._evict_one()
            b = self._free.popleft()
            self._ref[b] = 1
            out.append(b)
        self._update_gauges()
        return out

    def _evict_one(self) -> None:
        b, _ = self._lru.popitem(last=False)       # oldest hit first
        self._unpublish(b)
        self._free.append(b)
        self._m_evicted.inc()

    def _unpublish(self, block: int) -> None:
        h = self._hash_of.pop(block, None)
        if h is not None and self._by_hash.get(h) == block:
            del self._by_hash[h]
        self._tokens_of.pop(block, None)

    # -- refcounting ------------------------------------------------------
    def ref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise ValueError(f"ref of unowned block {block}")
        self._ref[block] += 1

    def deref(self, block: int) -> None:
        """Drop one hold.  At zero, a published block parks on the LRU
        (the prompt cache); an unpublished one frees immediately."""
        if self._ref[block] <= 0:
            raise ValueError(f"deref of unowned block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            if block in self._hash_of:
                self._lru[block] = None
                self._lru.move_to_end(block)
            else:
                self._free.append(block)
        self._update_gauges()

    # -- the prefix cache -------------------------------------------------
    def publish(self, block: int, parent: int, tokens) -> int:
        """Content-address a prompt block (full blocks and the partial
        tail both; the token count is part of the key via the tuple).
        Returns the block's chain key for the next link.  A block whose
        key is already resident keeps the incumbent (dedup favors the
        older, warmer copy); publishing makes the block immutable —
        any later write COWs."""
        key = chain_hash(parent, tokens)
        if key not in self._by_hash:
            self._by_hash[key] = block
            self._hash_of[block] = key
            self._tokens_of[block] = tuple(int(t) for t in tokens)
        return key

    def lookup(self, parent: int, tokens) -> int | None:
        """Prefix-cache probe for one block: a resident block whose
        chain key AND stored token ids match (hash collision = miss).
        A hit bumps the refcount (and lifts the block off the LRU if it
        was parked); the caller points its table at it instead of
        prefilling."""
        key = chain_hash(parent, tokens)
        b = self._by_hash.get(key)
        if b is None or \
                self._tokens_of.get(b) != tuple(int(t) for t in tokens):
            self._m_misses.inc()
            return None
        if self._ref[b] == 0:
            self._lru.pop(b, None)
        self._ref[b] += 1
        self._m_hits.inc()
        self._update_gauges()
        return b

    # -- copy-on-write ----------------------------------------------------
    def cow(self, block: int) -> tuple[int, bool]:
        """Make ``block`` privately writable for the calling sequence.
        Not shared: returned as-is.  Shared or published: allocate a
        fresh block (the caller copies the KV rows old -> new and
        repoints its table), drop this sequence's hold on the old one.
        Returns (writable block id, copied?)."""
        if not self.is_shared(block):
            return block, False
        fresh = self.alloc(1)
        if fresh is None:
            raise RuntimeError(
                "KV pool exhausted during copy-on-write — admission "
                "must reserve COW headroom (one block per sequence)")
        self.deref(block)
        self._m_cow.inc()
        self._update_gauges()
        return fresh[0], True

    # -- teardown ---------------------------------------------------------
    def release_all(self) -> None:
        """Drop every hold and every cached block (elastic reinit /
        executor teardown): the pool returns to fully free."""
        for b in range(self.num_blocks):
            self._ref[b] = 0
            self._unpublish(b)
        self._lru.clear()
        self._free = deque(range(self.num_blocks))
        self._update_gauges()

    def close(self) -> None:
        """Release verb: the pool's blocks index regions of the model
        cache, and an executor releases them when it closes."""
        if self._closed:
            return
        self.release_all()
        self._closed = True
