"""Replica executor: the serve loop every rank runs (the counterpart of
``horovod_tpu/serving/replica.py``).

- The **front end** (rank 0 of the serving world) owns the ingress queue,
  the continuous batcher and admission control.  Every serve step it
  assembles one :class:`~.batcher.BatchPlan` and broadcasts it; every
  rank executes the same plan sequence, so replicas never diverge on a
  collective.
- Each **replica group** (``HOROVOD_SERVE_GROUP_SIZE`` ranks; 1 = pure
  data-parallel) prefills newly assigned requests into free KV-cache
  slots and advances every in-flight slot by one greedy token a step.
- **Paged KV** (``HOROVOD_SERVE_PAGED``): slot KV state lives in blocks
  of a per-replica :class:`~.kvpool.KVBlockPool`, so the pool, not the
  batch shape, bounds concurrency; prompt blocks are content-addressed,
  a resident prefix is shared instead of prefilled again, a shared block
  is copied before its first divergent write, and cached blocks are
  evicted LRU-first.
- **Disaggregated prefill/decode** (``HOROVOD_SERVE_PREFILL_RANKS``,
  paged only): the highest N ranks prefill only and stream each prompt's
  finished KV blocks to its decode replica over a dedicated kvstream
  mesh (``kvstream.py``), so a long prompt overlaps decode steps instead
  of stalling them; a decode slot waits, skipping decode, until its
  blocks land, and prefills locally if they do not come in time.
- Completions ride back on an all-gather each step, so the front end
  frees slots and records latencies without a side channel.

The serving world is the eager core's: ``hvd.init()`` comes before the
executor, which takes its rank and size from ``hvd``.  The plan and the
completions move through ``hvd.broadcast_object`` and
``hvd.allgather_object`` under the reference's names
(``serve.plan.g<gen>.<step>``, ``serve.done.g<gen>.<step>``; the names
feed the collective fingerprints), in a world of one too, and each runs
under ``deadline_scope`` of the earliest in-flight request's deadline:
under ``HOROVOD_FAULT_TOLERANCE`` a dead peer converts at once into
``RanksFailedError``, and a wedged one at that deadline while the
exchange's op runs (a wait in the negotiation before it, which no
request deadline bounds, converts at ``HOROVOD_FAULT_TIMEOUT``, as in
the reference).

Elastic membership:

- **Shrink**: when an exchange raises ``RanksFailedError``, every
  survivor converges on the heartbeat-confirmed dead set
  (``resilience.converge_confirmed_dead``), renumbers itself, rebuilds
  the world one rank smaller under a fresh rendezvous epoch, moves to
  the next generation ``<gen>``, and resyncs the in-flight map from
  ground truth: the requests that were on dead replicas are counted
  lost, nothing on a survivor is touched (its KV cache is process-local).
  Suspicion alone (a wedged peer nobody confirmed dead) re-raises.
- **Grow** (``attach_statesync``): every serve step ends with a
  statesync boundary; a replica joining through
  :func:`join_serving_world` streams the incumbents' parameters
  peer-to-peer, enters at a step boundary, and every rank realigns its
  step, generation and batcher (``serve.growsync.<join>``).

The model runs on the card unless ``device="cpu"``.  Every call that
writes the KV cache runs under ``torch.inference_mode()``.  Token, block
table and cursor arrays live on the host as numpy, as in the reference:
a decode step copies each to the device once and reads the step's argmax
back once.

Under ``HOROVOD_METRICS=on`` each decode step folds its accepted tokens
into the serve gauges (``_note_perf``): tokens/s (an EMA), FLOPs a token
at the step's mean KV context, and their product over the peak of the
replica's card (serve MFU).

Not ported (ROADMAP queue A item 12): fleet weight swaps
(``attach_fleet`` raises ``NotImplementedError``).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from ..common import config
from ..common.device import resolve_device
from ..common.exceptions import RanksFailedError
from ..models import transformer as tfm
from .admission import AdmissionController
from .batcher import Assignment, BatchPlan, ContinuousBatcher
from .kvpool import FNV_SEED, KVBlockPool, chain_hash
from .queue import RequestQueue

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs (env defaults: the HOROVOD_SERVE_* family)."""
    max_batch: int = 8
    token_budget: int = 256
    max_seq: int = 256
    group_size: int = 1
    slo_ms: float = 30000.0
    queue_depth: int = 1024
    eos_id: int = -1                   # -1 disables EOS stopping
    seed: int = 0
    model_cfg: object | None = None    # TransformerConfig; None = tiny LM
    # Paged KV cache: blocks of block_tokens from a pool_blocks pool; 0 =
    # auto (max_batch x ceil(max_seq/bt), the dense layout's token
    # memory).  paged_slots (0 = auto: 2 x max_batch) is the decode batch
    # width — the pool, not the batch shape, bounds concurrency.
    paged: bool = False
    block_tokens: int = 16
    pool_blocks: int = 0
    paged_slots: int = 0
    # Disaggregated prefill/decode: highest N ranks prefill-only
    # (requires paged; clamped so at least one decode rank remains).
    prefill_ranks: int = 0
    # Prefill shapes run once at startup, so that the first requests
    # find the card's libraries loaded and the allocator warm.
    warmup_buckets: tuple = (8, 16)

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        base = dict(
            max_batch=config.SERVE_MAX_BATCH.get(),
            token_budget=config.SERVE_TOKEN_BUDGET.get(),
            max_seq=config.SERVE_MAX_SEQ.get(),
            group_size=config.SERVE_GROUP_SIZE.get(),
            slo_ms=config.SERVE_SLO_MS.get(),
            queue_depth=config.SERVE_QUEUE_DEPTH.get(),
            paged=config.SERVE_PAGED.get(),
            block_tokens=config.SERVE_BLOCK_TOKENS.get(),
            pool_blocks=config.SERVE_POOL_BLOCKS.get(),
            paged_slots=config.SERVE_PAGED_SLOTS.get(),
            prefill_ranks=config.SERVE_PREFILL_RANKS.get())
        base.update(overrides)
        return cls(**base)

    @property
    def slots(self) -> int:
        """Decode slots per replica: the dense batch, or the (wider)
        paged slot count backed by the shared pool."""
        if not self.paged:
            return self.max_batch
        return self.paged_slots if self.paged_slots > 0 \
            else 2 * self.max_batch

    @property
    def table_width(self) -> int:
        return -(-self.max_seq // self.block_tokens)

    @property
    def resolved_pool_blocks(self) -> int:
        """Pool size; the auto default reserves exactly the dense
        layout's token memory (max_batch x max_seq tokens)."""
        if self.pool_blocks > 0:
            return self.pool_blocks
        return self.max_batch * self.table_width


@dataclasses.dataclass
class _Slot:
    """One in-flight sequence in this replica's decode batch."""
    rid: int
    remaining: int                     # decode tokens still to produce
    deadline: float                    # absolute local monotonic
    assigned_at: float
    age_ms: float                      # ingress age when assigned
    slo_ms: float
    generated: list[int]
    # Paged mode: physical block ids in logical order (each held once
    # by this slot) and the sequence write cursor.
    blocks: list = dataclasses.field(default_factory=list)
    seq_len: int = 0
    # Disaggregated mode: the original assignment while the streamed
    # prefill is still in flight (the slot skips decode until it lands or
    # the fallback prefills locally), and when it went pending.
    pending: Assignment | None = None
    pending_since: float = 0.0


class ReplicaExecutor:
    """One rank's half of the data-parallel serving world.

    ``params`` is a state dict of the port's ``TransformerLM``; without
    one the weights are drawn from ``cfg.seed`` with a
    ``torch.Generator``, the same on every rank of one device type.  The
    rank and world size are ``hvd``'s, so ``hvd.init()`` comes first."""

    def __init__(self, serve_cfg: ServeConfig | None = None,
                 params: dict | None = None, *,
                 device: str | torch.device | None = None) -> None:
        from .. import eager as hvd
        self.cfg = serve_cfg or ServeConfig.from_env()
        self.device = resolve_device(device)
        self.hvd = hvd
        self.rank = hvd.rank()
        self.size = hvd.size()
        self.front = 0
        self._gen = 0                  # shrink/grow generation (name tag)
        self._step = 0
        self._stop_requested = False
        self._configure_groups()

        model_cfg = _serving_model_cfg(self.cfg)
        if self.cfg.paged:
            model_cfg = dataclasses.replace(
                model_cfg, paged=True,
                kv_pool_blocks=self.cfg.resolved_pool_blocks,
                kv_block_tokens=self.cfg.block_tokens)
        self.model = tfm.TransformerLM(model_cfg, device=self.device,
                                       seed=self.cfg.seed)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.requires_grad_(False)

        self.slots: list[_Slot | None] = [None] * self.cfg.slots
        self._last_tokens = np.zeros(self.cfg.slots, np.int32)
        self.completed: dict[int, dict] = {}
        self.prefilled: set[int] = set()
        # Completions not yet acknowledged by an exchange.
        self._unreported: list[dict] = []
        # The serve gauges (telemetry/perfmodel.py): smoothed accepted
        # tokens/s and the card's peak for the serve MFU.
        self._perf_tps = 0.0
        self._peak_flops: float | None = None
        self.stats = {"offered": 0, "expired": 0, "served": 0,
                      "served_slo": 0, "lost": 0,
                      "latencies_ms": [], "completed_at": [],
                      "shrinks": [], "grows": [],
                      "prefill_streams": 0, "prefill_fallbacks": 0,
                      "prefill_skipped": 0, "weight_swaps": []}
        # Elastic grow mid-serve: attach_statesync wires a membership
        # service in; None adds no collective.
        self.statesync = None

        self.queue = RequestQueue(maxsize=self.cfg.queue_depth,
                                  default_slo_ms=self.cfg.slo_ms)
        self.admission = AdmissionController(
            queue_depth_limit=self.cfg.queue_depth)
        self.batcher = self._make_batcher()

        # Paged state: the block pool (id bookkeeping), the per-slot
        # block tables/cursors (the model's addressing arguments) and
        # the paged cache (the pools themselves).
        self.pool: KVBlockPool | None = None
        if self.cfg.paged:
            self.pool = KVBlockPool(self.cfg.resolved_pool_blocks,
                                    self.cfg.block_tokens)
            self._sink = self.cfg.resolved_pool_blocks
            self._tables = np.full((self.cfg.slots,
                                    self.cfg.table_width),
                                   self._sink, np.int32)
            self._cursors = np.zeros(self.cfg.slots, np.int32)
        self._kvstream = None
        self._init_cache()
        self._warmup()
        if self.prefill_rank_list:
            self._rebuild_kvstream()

    # -- topology --------------------------------------------------------
    def _configure_groups(self) -> None:
        n_pref = 0
        if self.cfg.prefill_ranks > 0:
            if not self.cfg.paged:
                logger.warning(
                    "serving: HOROVOD_SERVE_PREFILL_RANKS needs "
                    "HOROVOD_SERVE_PAGED (block streaming); ignoring")
            else:
                n_pref = min(self.cfg.prefill_ranks, self.size - 1)
        self.decode_size = self.size - n_pref
        self.prefill_rank_list = list(range(self.decode_size, self.size))
        self.is_prefill = self.rank >= self.decode_size
        gs = self.cfg.group_size
        if gs <= 0 or self.decode_size % gs:
            if gs > 1:
                logger.warning(
                    "serving: group size %d does not divide decode size "
                    "%d; falling back to per-rank replicas", gs,
                    self.decode_size)
            gs = 1
        self.group_size = gs
        self.group = self.rank // gs if not self.is_prefill else -1
        self.num_groups = self.decode_size // gs
        self.group_leader = (not self.is_prefill
                             and self.rank % gs == 0)

    def _make_batcher(self) -> ContinuousBatcher:
        return ContinuousBatcher(
            self.num_groups, slots_per_replica=self.cfg.slots,
            token_budget=self.cfg.token_budget,
            block_capacity=self.cfg.resolved_pool_blocks
            if self.cfg.paged else 0,
            block_tokens=self.cfg.block_tokens)

    def _rebuild_kvstream(self) -> None:
        """(Re)form the dedicated prefill-stream mesh — collectively,
        every serving rank, epoch- and generation-scoped so a post-shrink
        mesh never collides with the dying one's sockets."""
        from ..statesync.service import _kv_client
        from .kvstream import KVStreamMesh, kvstream_scope

        if self._kvstream is not None:
            self._kvstream.close()
            self._kvstream = None
        base = os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0")
        self._kvstream = KVStreamMesh(
            _kv_client(), kvstream_scope(base, self._gen), self.rank,
            self.size, self.prefill_rank_list)

    # -- model plumbing --------------------------------------------------
    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array, device=self.device)

    def _decode_impl(self, cache, tokens):
        logits, cache = tfm.decode_step(self.model, cache, tokens)
        # argmax, not topk: both it and jnp.argmax return the first of
        # tied maxima, which bf16 logits over a 50k vocab often have.
        return torch.argmax(logits[:, -1, :], dim=-1), cache

    def _prefill_impl(self, tokens, n: int):
        logits, cache = tfm.prefill(self.model, tokens, lengths=n)
        return torch.argmax(logits[0, n - 1, :]), cache

    def _paged_impl(self, cache, tokens, tables, cursors):
        """One paged decode step for the whole slot array: free slots'
        tables point at the pool's sink row, so their writes land in
        garbage space and their outputs are ignored."""
        logits, cache = tfm.paged_apply(self.model, cache, tokens, tables,
                                        cursors)
        return torch.argmax(logits[:, -1, :], dim=-1), cache

    def _paged_prefill_impl(self, cache, tokens, table, cursor, n: int):
        """Paged prefill of ONE request (B=1) straight into the shared
        pool through the slot's block table; ``cursor`` > 0 resumes
        past prefix-cache hits and ``n`` masks the padded tail."""
        logits, cache = tfm.paged_apply(
            self.model, cache, tokens, table, cursor,
            lengths=np.array([n], np.int32))
        return torch.argmax(logits[0, n - 1, :]), cache

    @torch.inference_mode()
    def _init_cache(self) -> None:
        """A zeroed cache.  The reference builds its cache by one apply,
        which also writes token 0's K/V at position 0 (dense) or into the
        sink (paged) before the cursor is reset; no live position ever
        reads those values, so the port starts from zeros."""
        if self.cfg.paged:
            self._cache = tfm.PagedKVCache.zeros(self.model.cfg,
                                                 self.device)
        else:
            self._cache = tfm.KVCache.zeros(self.model.cfg, self.cfg.slots,
                                            self.device)

    @torch.inference_mode()
    def _warmup(self) -> None:
        """Run each warm-up bucket's prefill and one decode step, then
        start again from a clean cache."""
        buckets = [b for b in self.cfg.warmup_buckets
                   if b <= self.cfg.max_seq]
        if self.cfg.paged:
            table1 = self._to_device(np.full((1, self.cfg.table_width),
                                             self._sink, np.int32))
            for bucket in buckets:
                tok, _ = self._paged_prefill_impl(
                    self._cache, self._to_device(np.zeros((1, bucket),
                                                          np.int32)),
                    table1, self._to_device(np.zeros(1, np.int32)), 1)
                int(tok)
            nxt, _ = self._paged_impl(
                self._cache, self._to_device(self._last_tokens[:, None]),
                self._to_device(self._tables),
                self._to_device(self._cursors))
        else:
            for bucket in buckets:
                tok, _ = self._prefill_impl(
                    self._to_device(np.zeros((1, bucket), np.int32)), 1)
                int(tok)
            nxt, _ = self._decode_impl(
                self._cache, self._to_device(self._last_tokens[:, None]))
        nxt.cpu()
        self._init_cache()             # discard the warm-up's writes

    @staticmethod
    def _bucket(n: int) -> int:
        return max(8, 1 << max(0, (n - 1)).bit_length())

    # -- per-step halves -------------------------------------------------
    def _assemble(self) -> BatchPlan:
        stop = (self._stop_requested and self.queue.depth() == 0
                and self.batcher.inflight_count() == 0)
        plan, expired = self.batcher.assemble(
            self._step, self.queue, self.admission, stop=stop,
            prefill_ranks=self.prefill_rank_list)
        for _ in expired:
            # Expired while queued: shed at admission, never executed.
            self.admission.count("expired")
            self.stats["expired"] += 1
        return plan

    def _inflight_deadline(self) -> float | None:
        """The earliest in-flight request's deadline: it bounds this
        step's exchanges (``deadline_scope``)."""
        deadlines = [s.deadline for s in self.slots if s is not None]
        return min(deadlines) if deadlines else None

    def _exchange_plan(self, plan: BatchPlan | None) -> BatchPlan:
        """The front's plan on every rank: the broadcast is the
        schedule."""
        from ..resilience import deadline_scope
        with deadline_scope(self._inflight_deadline()):
            return self.hvd.broadcast_object(
                plan, root_rank=self.front,
                name=f"serve.plan.g{self._gen}.{self._step}")

    def _apply_plan(self, plan: BatchPlan) -> None:
        now = time.monotonic()
        for a in plan.assign:
            if self.is_prefill:
                if a.prefill == self.rank:
                    self._prefill_and_stream(a)
                continue
            if a.replica != self.group:
                continue
            slot = next(i for i, s in enumerate(self.slots) if s is None)
            if a.prefill >= 0:
                self._admit_disaggregated(slot, a, now)
            elif self.cfg.paged:
                self._prefill_slot_paged(slot, a, now)
            else:
                self._prefill_slot(slot, a, now)

    # -- dense prefill ---------------------------------------------------
    @torch.inference_mode()
    def _prefill_slot(self, slot: int, a: Assignment, now: float) -> None:
        toks = self._clamped_tokens(a)
        bucket = min(self._bucket(len(toks)), self.cfg.max_seq)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(toks)] = toks
        first, cache1 = self._prefill_impl(self._to_device(padded),
                                           len(toks))
        for big, small in zip(
                self._cache.key + self._cache.value + self._cache.index,
                cache1.key + cache1.value + cache1.index):
            big[slot] = small[0]
        self._activate_slot(slot, a, now, int(first))

    def _activate_slot(self, slot: int, a: Assignment, now: float,
                       first: int, blocks: list | None = None,
                       seq_len: int = 0) -> None:
        self._last_tokens[slot] = first
        self.slots[slot] = _Slot(
            rid=a.rid, remaining=a.max_new_tokens - 1,
            deadline=now + a.deadline_rel_ms / 1e3, assigned_at=now,
            age_ms=a.age_ms, slo_ms=a.slo_ms, generated=[first],
            blocks=blocks or [], seq_len=seq_len)
        self.prefilled.add(a.rid)

    # -- paged prefill + prefix cache ------------------------------------
    def _clamped_tokens(self, a: Assignment) -> list[int]:
        """Clamp so prompt + generation always fits the KV cache."""
        limit = self.cfg.max_seq - a.max_new_tokens
        return a.tokens[:max(1, limit)]

    def _lookup_prefix(self, toks: list[int]) -> tuple[list, int]:
        """Walk the prompt's block chain through the prefix cache:
        returns (hit block ids — refcounts already bumped, tokens
        covered)."""
        bt = self.cfg.block_tokens
        parent = FNV_SEED
        hits: list[int] = []
        pos = 0
        while pos < len(toks):
            seg = toks[pos:pos + bt]
            blk = self.pool.lookup(parent, seg)
            if blk is None:
                break
            hits.append(blk)
            parent = chain_hash(parent, seg)
            pos += len(seg)
        return hits, pos

    def _publish_prompt(self, toks: list[int], blocks: list) -> None:
        """Content-address every prompt block (full blocks and the
        partial tail) so later identical prefixes hit instead of
        re-prefilling.  Publishing makes a block immutable — the next
        write into the tail copies it first (the first divergent
        write)."""
        bt = self.cfg.block_tokens
        parent = FNV_SEED
        for i in range(0, len(toks), bt):
            parent = self.pool.publish(blocks[i // bt], parent,
                                       toks[i:i + bt])

    @torch.inference_mode()
    def _ensure_writable(self, slot_blocks: list, j: int) -> bool:
        """Copy-on-write guard before writing into logical block ``j``:
        a shared or published block gets a private copy (pool ids and
        tensor rows) and the slot's list repoints.  Returns True when a
        copy happened."""
        old = slot_blocks[j]
        new, copied = self.pool.cow(old)
        if copied:
            self._cache = tfm.paged_copy_block(self._cache, old, new)
            slot_blocks[j] = new
        return copied

    @torch.inference_mode()
    def _prefill_slot_paged(self, slot: int, a: Assignment,
                            now: float) -> None:
        bt = self.cfg.block_tokens
        toks = self._clamped_tokens(a)
        hits, pos = self._lookup_prefix(toks)
        if pos >= len(toks):
            # Whole prompt resident: no prefill at all — re-run just the
            # last prompt token (its K/V rewrite is value-identical; the
            # copy-on-write below keeps shared blocks untouched) to get
            # the next-token logits.
            pos = len(toks) - 1
            self.stats["prefill_skipped"] += 1
        total = -(-(len(toks) + a.max_new_tokens) // bt)
        fresh = self.pool.alloc(total - len(hits))
        if fresh is None:
            # The front end reserves worst-case blocks per admission, so
            # this is unreachable unless accounting drifted; fail loud.
            for b in hits:
                self.pool.deref(b)
            raise RuntimeError(
                f"KV pool exhausted admitting rid {a.rid}: "
                f"{self.pool.free_count()} free of {self.pool.num_blocks}")
        blocks = hits + fresh
        self._ensure_writable(blocks, pos // bt)
        rem = toks[pos:]
        bucket = min(self._bucket(len(rem)), self.cfg.max_seq)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(rem)] = rem
        row = np.full(self.cfg.table_width, self._sink, np.int32)
        row[:total] = blocks
        first, self._cache = self._paged_prefill_impl(
            self._cache, self._to_device(padded),
            self._to_device(row[None]),
            self._to_device(np.array([pos], np.int32)), len(rem))
        self._publish_prompt(toks, blocks)
        self._tables[slot] = row
        self._activate_slot(slot, a, now, int(first), blocks=blocks,
                            seq_len=len(toks))

    # -- disaggregated prefill/decode ------------------------------------
    def _admit_disaggregated(self, slot: int, a: Assignment,
                             now: float) -> None:
        """Decode-rank admission of a prefill-rank-assigned request: a
        full local prefix hit admits at once (the stream, when it lands,
        is discarded); otherwise the slot parks pending — it skips decode
        until the streamed blocks arrive (or the fallback prefills
        locally), so the long prompt never stalls a step."""
        toks = self._clamped_tokens(a)
        hits, pos = self._lookup_prefix(toks)
        for b in hits:          # _prefill_slot_paged looks up again
            self.pool.deref(b)
        if pos >= len(toks):
            self._prefill_slot_paged(slot, a, now)
            if self._kvstream is not None:
                self._kvstream.discard(a.rid)
            return
        self.slots[slot] = _Slot(
            rid=a.rid, remaining=a.max_new_tokens,
            deadline=now + a.deadline_rel_ms / 1e3, assigned_at=now,
            age_ms=a.age_ms, slo_ms=a.slo_ms, generated=[],
            pending=a, pending_since=now)
        self.prefilled.add(a.rid)

    @torch.inference_mode()
    def _prefill_and_stream(self, a: Assignment) -> None:
        """Prefill-rank half: compute the prompt's KV blocks in the local
        scratch pool (identity table) and stream them to every rank of
        the decode replica group."""
        bt = self.cfg.block_tokens
        toks = self._clamped_tokens(a)
        nblk = -(-len(toks) // bt)
        row = np.full(self.cfg.table_width, self._sink, np.int32)
        row[:nblk] = np.arange(nblk)
        bucket = min(self._bucket(len(toks)), self.cfg.max_seq)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(toks)] = toks
        first, self._cache = self._paged_prefill_impl(
            self._cache, self._to_device(padded),
            self._to_device(row[None]),
            self._to_device(np.zeros(1, np.int32)), len(toks))
        image = self._extract_blocks(nblk)
        raw = image.view(torch.uint8).reshape(-1).numpy()
        dests = list(range(a.replica * self.group_size,
                           (a.replica + 1) * self.group_size))
        from ..resilience import deadline_scope

        # The stream is bounded twice over: the request's SLO deadline
        # scopes the step, and the KVStreamGuard silence timeout aborts
        # a send wedged on a dead decode peer (the decode side then
        # prefills locally — degradation, never a stall).
        try:
            with deadline_scope(time.monotonic()
                                + a.deadline_rel_ms / 1e3):
                self._kvstream.send_image(
                    a.rid, dests, raw, first=int(first), plen=len(toks),
                    cursor=len(toks),
                    shape=tuple(image.shape),
                    dtype=str(image.dtype).removeprefix("torch."))
        except (ConnectionError, OSError) as exc:
            logger.warning("serving: prefill stream for rid %d failed: "
                           "%s", a.rid, exc)
            return
        self.stats["prefill_streams"] += 1

    def _cache_pool_leaves(self) -> list[torch.Tensor]:
        """The per-layer key and value pools in one order on sender and
        receiver (the same model, the same cache): layer by layer, its
        key pool, then its value pool."""
        return [pool for pair in zip(self._cache.key_pool,
                                     self._cache.value_pool)
                for pool in pair]

    def _extract_blocks(self, nblk: int) -> torch.Tensor:
        """``[2L, nblk, bt, H, D]`` on the host: the prompt's pool rows of
        every layer, one device-to-host copy a pool."""
        leaves = self._cache_pool_leaves()
        out = torch.empty((len(leaves), nblk, *leaves[0].shape[1:]),
                          dtype=leaves[0].dtype)
        for i, leaf in enumerate(leaves):
            out[i].copy_(leaf[:nblk])
        return out

    @torch.inference_mode()
    def _insert_blocks(self, ids: list, image: torch.Tensor) -> None:
        idx = self._to_device(np.asarray(ids, np.int64))
        for i, leaf in enumerate(self._cache_pool_leaves()):
            leaf.index_copy_(0, idx, image[i].to(self.device))

    def _integrate_prefills(self) -> None:
        """Decode-rank step hook: land fully streamed transfers into
        pending slots (non-blocking — a transfer still in flight keeps
        its slot pending), prefill locally when a transfer outlived its
        patience (prefill rank died, stream lost), and drop orphaned
        images."""
        now = time.monotonic()
        pending_rids = set()
        for i, s in enumerate(self.slots):
            if s is None or s.pending is None:
                continue
            pending_rids.add(s.rid)
            img = self._kvstream.pop_ready(s.rid) \
                if self._kvstream is not None else None
            if img is not None:
                self._land_streamed(i, img)
                continue
            patience = max(1.0, s.slo_ms / 4e3)
            if now - s.pending_since > patience:
                a = s.pending
                self.slots[i] = None
                self._prefill_slot_paged(i, a, now)
                self.stats["prefill_fallbacks"] += 1
                if self._kvstream is not None:
                    self._kvstream.discard(a.rid)
        if self._kvstream is not None:
            for rid in self._kvstream.ready_rids():
                if rid not in pending_rids:
                    self._kvstream.discard(rid)

    def _land_streamed(self, slot: int, img) -> None:
        """Insert a streamed prefill into the pool and activate the slot:
        allocate the sequence's full block run, write the prompt rows,
        publish them for prefix reuse."""
        a = self.slots[slot].pending
        bt = self.cfg.block_tokens
        toks = self._clamped_tokens(a)
        total = -(-(len(toks) + a.max_new_tokens) // bt)
        blocks = self.pool.alloc(total)
        if blocks is None:
            raise RuntimeError(
                f"KV pool exhausted landing streamed rid {a.rid}")
        image = torch.frombuffer(img.data, dtype=torch.uint8).view(
            getattr(torch, img.dtype)).reshape(img.shape)
        self._insert_blocks(blocks[:image.shape[1]], image)
        self._publish_prompt(toks, blocks)
        row = np.full(self.cfg.table_width, self._sink, np.int32)
        row[:total] = blocks
        self._tables[slot] = row
        remaining = self.slots[slot].remaining
        self._last_tokens[slot] = img.first
        self.slots[slot] = dataclasses.replace(
            self.slots[slot], remaining=remaining - 1,
            generated=[img.first], blocks=blocks, seq_len=img.cursor,
            pending=None, pending_since=0.0)

    # -- decode ----------------------------------------------------------
    @torch.inference_mode()
    def _decode_once(self) -> None:
        """One greedy token for every active slot.  The whole slot array
        goes through the model: in the dense layout a free slot's cursor
        keeps advancing (past S, where the write clamps as in JAX), in the
        paged one its table points at the sink."""
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.pending is None
                  and s.remaining > 0]
        if not active:
            return
        tokens = self._to_device(self._last_tokens[:, None])
        if self.cfg.paged:
            bt = self.cfg.block_tokens
            for i in active:
                s = self.slots[i]
                # The write position may sit in a published tail (the
                # first divergent write of a shared prefix).
                if self._ensure_writable(s.blocks, s.seq_len // bt):
                    self._tables[i][s.seq_len // bt] = \
                        s.blocks[s.seq_len // bt]
                self._cursors[i] = s.seq_len
            nxt, self._cache = self._paged_impl(
                self._cache, tokens, self._to_device(self._tables),
                self._to_device(self._cursors))
        else:
            nxt, self._cache = self._decode_impl(self._cache, tokens)
        nxt = nxt.cpu().numpy()
        for i in active:
            s = self.slots[i]
            tok = int(nxt[i])
            s.generated.append(tok)
            s.remaining -= 1
            s.seq_len += 1
            self._last_tokens[i] = tok
            if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                s.remaining = 0

    def _collect_completions(self) -> None:
        now = time.monotonic()
        for i, s in enumerate(self.slots):
            if s is None or s.pending is not None or s.remaining > 0:
                continue
            rec = {"rid": s.rid, "replica": self.group,
                   "latency_ms": s.age_ms + (now - s.assigned_at) * 1e3,
                   "tokens": len(s.generated),
                   "slo_met": now <= s.deadline}
            self.completed[s.rid] = rec
            if self.group_leader:
                # Every group member frees slots identically; only the
                # leader reports, so completions appear exactly once.
                self._unreported.append(rec)
            self._release_slot(i)

    def _release_slot(self, i: int) -> None:
        s = self.slots[i]
        if self.cfg.paged and s is not None:
            for b in s.blocks:
                self.pool.deref(b)
            self._tables[i] = self._sink
            self._cursors[i] = 0
            if self._kvstream is not None:
                self._kvstream.discard(s.rid)
        self.slots[i] = None

    def _exchange_completions(self) -> list[dict]:
        """Every rank's new completions, on every rank."""
        from ..resilience import deadline_scope
        mine = {"done": list(self._unreported)}
        with deadline_scope(self._inflight_deadline()):
            per_rank = self.hvd.allgather_object(
                mine, name=f"serve.done.g{self._gen}.{self._step}")
        self._unreported.clear()       # acknowledged by the exchange
        return [rec for p in per_rank for rec in p["done"]]

    def _account(self, completions: list[dict]) -> None:
        if self.rank != self.front:
            return
        now = time.monotonic()
        for rec in completions:
            if rec["rid"] not in self.batcher.inflight:
                continue   # duplicate re-send after a failed exchange
            self.batcher.note_done(rec["rid"])
            self.admission.count("served")
            self.admission.observe_latency_ms(rec["latency_ms"])
            self.stats["served"] += 1
            self.stats["served_slo"] += bool(rec["slo_met"])
            self.stats["latencies_ms"].append(rec["latency_ms"])
            self.stats["completed_at"].append(now)

    # -- elastic grow mid-serve (statesync/) -----------------------------
    def attach_statesync(self, service) -> None:
        """Wire a statesync membership service in: every serve step ends
        with its boundary check, so a joining replica is admitted at a
        step boundary and enters after its streamed params verify."""
        self.statesync = service

    def state_tree(self) -> dict[str, torch.Tensor]:
        """The streamed state of serving: the parameters, the only
        cross-replica state (KV caches are per request), which never
        change between steps (the service runs with ``static_state``,
        so the bulk image is the joiner's entry state).  Each is
        ``params/<name>`` in the flax leaf order, viewed in flax's shape
        and element order, so the image is the reference's for the same
        weights."""
        return _params_tree(self.model)

    def _statesync_boundary(self) -> None:
        change = self.statesync.step_boundary()
        if change is not None and change.kind == "grow":
            self._grow_resync(change.join_id, change.rank, change.size)

    def _grow_resync(self, join_id: int, new_rank: int,
                     new_size: int) -> None:
        """Realign the serving world after a grow: every rank (the joiner
        included — this is its first collective) exchanges (step, gen,
        resident rids), adopts the maxima, and rebuilds the batcher with
        the new replica group present but empty.  Nothing in flight is
        touched: incumbents' KV caches are process-local."""
        old_size = self.size
        self.rank, self.size = new_rank, new_size
        self.front = 0
        self._configure_groups()
        mine = {"step": self._step, "gen": self._gen,
                "rids": (sorted(s.rid for s in self.slots
                                if s is not None)
                         if self.group_leader else [])}
        per_rank = self.hvd.allgather_object(
            mine, name=f"serve.growsync.{join_id}")
        self._step = max(p["step"] for p in per_rank)
        # A fresh generation: post-grow exchange names never collide
        # with a pre-grow step another rank might still have cached.
        self._gen = max(p["gen"] for p in per_rank) + 1
        per_group = [per_rank[g * self.group_size]["rids"]
                     for g in range(self.num_groups)]
        self.batcher.rebuild(per_group)
        if self.prefill_rank_list:
            self._rebuild_kvstream()
        windows = getattr(self.statesync, "grow_windows", [])
        self.stats["grows"].append(
            {"join": join_id, "from": old_size, "to": new_size,
             "step": self._step, "at": time.monotonic(),
             "window_s": windows[-1][1] - windows[-1][0]
             if windows else 0.0})
        logger.warning("serving: grow %d->%d (join %d) at step %d",
                       old_size, new_size, join_id, self._step)

    # -- not ported ------------------------------------------------------
    def attach_fleet(self, kv, *, interval_s: float | None = None):
        raise NotImplementedError(
            "fleet weight deployment (attach_fleet) is ROADMAP queue A "
            "item 12")

    def _note_perf(self, tokens: int, ctx_sum: int, dt_s: float) -> None:
        """Fold one decode step into the serve gauges: accepted tokens/s,
        FLOPs a token at the step's mean KV context, and their product
        over the card's peak (serve MFU)."""
        from ..telemetry import metrics as telemetry_metrics
        tm = telemetry_metrics()
        if not tm.enabled or tokens <= 0 or dt_s <= 0.0:
            return
        from ..telemetry import perfmodel
        if self._peak_flops is None:
            self._peak_flops = perfmodel.peak_flops(
                perfmodel.device_kind(self.device))
        tps = tokens / dt_s
        # An EMA over steps: a serve step is milliseconds, and the raw
        # rate of one step swings with the batch's occupancy.
        self._perf_tps = tps if self._perf_tps <= 0.0 \
            else 0.8 * self._perf_tps + 0.2 * tps
        flops_per_token = perfmodel.transformer_decode_flops(
            self.model.cfg, ctx_sum / tokens)
        tm.gauge("horovod_serve_tokens_per_sec").set(self._perf_tps)
        tm.gauge("horovod_serve_flops_per_token").set(flops_per_token)
        tm.gauge("horovod_serve_mfu").set(
            self._perf_tps * flops_per_token / self._peak_flops)

    # -- the loop --------------------------------------------------------
    def _serve_step(self) -> bool:
        t0 = time.monotonic()
        plan = self._assemble() if self.rank == self.front else None
        plan = self._exchange_plan(plan)
        self._step += 1
        if plan.stop:
            return False
        self._apply_plan(plan)
        decoded = ctx_sum = 0
        if not self.is_prefill:
            if self.cfg.paged and self.prefill_rank_list:
                self._integrate_prefills()
            self._decode_once()
            for s in self.slots:
                if s is not None and s.pending is None:
                    decoded += 1
                    ctx_sum += s.seq_len
            self._collect_completions()
        self._account(self._exchange_completions())
        if self.statesync is not None:
            self._statesync_boundary()
        dt = time.monotonic() - t0
        self.admission.observe_step_ms(dt * 1e3)
        self._note_perf(decoded, ctx_sum, dt)
        return True

    def serve_loop(self, *, stop_when=None, max_steps: int | None = None,
                   idle_sleep: float = 0.002) -> None:
        """Run serve steps until the front end declares the system
        drained (``stop_when()`` true on the front end AND queue and
        in-flight empty), riding elastic shrinks across rank failures.
        ``max_steps`` is a safety bound for tests."""
        while max_steps is None or self._step < max_steps:
            if self.rank == self.front:
                if stop_when is not None and stop_when():
                    self._stop_requested = True
                if (not self._stop_requested
                        and self.queue.depth() == 0
                        and self.batcher.inflight_count() == 0):
                    time.sleep(idle_sleep)   # don't hot-spin empty plans
            try:
                if not self._serve_step():
                    return
            except RanksFailedError as exc:
                self._shrink_and_resume(exc)

    # -- elastic shrink --------------------------------------------------
    def _shrink_and_resume(self, exc: RanksFailedError) -> None:
        from .. import core
        from ..resilience import converge_confirmed_dead

        # Converge on the heartbeat-CONFIRMED dead set (shared with the
        # statesync failure-shrink path, resilience/policy.py): every
        # survivor computes the same membership, and suspicion alone (a
        # slow peer) re-raises instead of shrinking.
        dead = converge_confirmed_dead(exc)
        survivors = [r for r in range(self.size) if r not in dead]
        new_rank = survivors.index(self.rank)
        new_size = len(survivors)
        from ..telemetry import flight

        rec = flight.recorder()
        if rec.enabled:
            rec.record("shrink", f"dead {sorted(dead)}",
                       detail=f"serving {self.size}->{new_size} at "
                              f"step {self._step}")
        logger.warning(
            "serving: shrink %d->%d (dead=%s); this rank %d -> %d",
            self.size, new_size, sorted(dead), self.rank, new_rank)
        base = os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0")
        self._gen += 1
        tag = "_".join(str(r) for r in sorted(dead))
        core.reinit_world(
            rank=new_rank, size=new_size,
            epoch=f"{base.split('~', 1)[0]}~sv{self._gen}x{tag}")
        old = (self.rank, self.size)
        self.rank, self.size = new_rank, new_size
        self.front = 0
        self._configure_groups()
        if self.statesync is not None:
            self.statesync.notify_world_changed()
        self._resync()
        if self.prefill_rank_list:
            self._rebuild_kvstream()
        if not self.is_prefill:
            self._repair_pending()
        self.stats["shrinks"].append(
            {"dead": sorted(dead), "from": old[1], "to": new_size,
             "step": self._step})

    def _repair_pending(self) -> None:
        """After a world rebuild, any still-pending streamed prefill may
        have died with its prefill rank: prefill locally right away (the
        plan already committed these admissions — they are never
        dropped)."""
        now = time.monotonic()
        for i, s in enumerate(self.slots):
            if s is None or s.pending is None:
                continue
            a = s.pending
            self.slots[i] = None
            self._prefill_slot_paged(i, a, now)
            self.stats["prefill_fallbacks"] += 1

    def _resync(self) -> None:
        """Rebuild shared state from ground truth after a world rebuild.

        - Survivors may have caught the failure at DIFFERENT steps (a
          per-rank data-plane error can abort rank A's plan broadcast
          while rank B fails one exchange later), so the step counter
          realigns to the maximum — exchange names must match again.
        - Each group leader reports its resident rids (plus completions
          awaiting re-send); requests that vanished with dead replicas
          are counted lost.  Nothing on a surviving replica is ever
          dropped.
        """
        rids = sorted(s.rid for s in self.slots if s is not None)
        rids += [rec["rid"] for rec in self._unreported]
        mine = {"step": self._step,
                "rids": rids if self.group_leader else []}
        per_rank = self.hvd.allgather_object(
            mine, name=f"serve.resync.g{self._gen}")
        self._step = max(p["step"] for p in per_rank)
        per_group = [per_rank[g * self.group_size]["rids"]
                     for g in range(self.num_groups)]
        lost = self.batcher.rebuild(per_group)
        if self.rank == self.front:
            for _ in lost:
                self.admission.count("lost")
            self.stats["lost"] += len(lost)

    # -- introspection / teardown ----------------------------------------
    def inflight_rids(self) -> list[int]:
        return sorted(s.rid for s in self.slots if s is not None)

    def request_stop(self) -> None:
        self._stop_requested = True

    def kv_stats(self) -> dict | None:
        """The paged pool's residency/reuse numbers for reports and the
        leak census (None in dense mode)."""
        if self.pool is None:
            return None
        return {"pool_blocks": self.pool.num_blocks,
                "block_tokens": self.pool.block_tokens,
                "free": self.pool.free_count(),
                "active": self.pool.active_count(),
                "cached": self.pool.cached_count(),
                "prefix_hits": self.pool._m_hits.value,
                "prefix_misses": self.pool._m_misses.value,
                "evictions": self.pool._m_evicted.value,
                "cow_copies": self.pool._m_cow.value,
                "max_concurrent_seqs": self.batcher.max_concurrent,
                "prefill_streams": self.stats["prefill_streams"],
                "prefill_fallbacks": self.stats["prefill_fallbacks"],
                "prefill_skipped": self.stats["prefill_skipped"]}

    def close(self) -> None:
        """Release the serving resources this executor owns: the kvstream
        mesh (drain threads and sockets) and the KV block pool."""
        if self._kvstream is not None:
            self._kvstream.close()
            self._kvstream = None
        if self.pool is not None:
            self.pool.close()


def _params_tree(model: tfm.TransformerLM) -> dict[str, torch.Tensor]:
    """``params/<name>`` -> the parameter viewed in flax's shape and
    element order, in the flax leaf order."""
    from ..convert import flax_layouts
    from ..training import _leaf_order
    layouts = flax_layouts(model)
    params = dict(model.named_parameters())
    return {f"params/{n}": layouts[n][0](params[n].detach())
            for n in _leaf_order(model)}


def _serving_model_cfg(cfg: ServeConfig):
    """The decode model of ``cfg`` (gpt_tiny in fp32 when it names none),
    its positions sized to ``cfg.max_seq``."""
    model_cfg = cfg.model_cfg
    if model_cfg is None:
        model_cfg = tfm.gpt_tiny(dtype=torch.float32)
    return dataclasses.replace(model_cfg, decode=True,
                               max_seq_len=cfg.max_seq)


def serving_params_template(cfg: ServeConfig) -> dict[str, torch.Tensor]:
    """The state tree a serving joiner offers to ``join_world``: the
    leaves of :meth:`ReplicaExecutor.state_tree` of a model of ``cfg``
    built on the CPU from ``cfg.seed`` (their shapes and dtypes matter;
    the streamed image replaces the values)."""
    return _params_tree(tfm.TransformerLM(_serving_model_cfg(cfg),
                                          device="cpu", seed=cfg.seed))


def join_serving_world(serve_cfg: ServeConfig | None = None, *,
                       device: str | torch.device | None = None
                       ) -> ReplicaExecutor:
    """Join a live serving world as a fresh replica (statesync grow):
    stream the incumbents' params peer-to-peer, enter as rank N, and
    return a ReplicaExecutor on ``device`` (the card unless "cpu")
    already realigned (step, generation, batcher) and ready for
    ``serve_loop``.  The incumbents' only stall is this rank's executor
    construction between the world rebuild and the first realign
    exchange — the bulk params transfer happened before they rebuilt
    anything."""
    from .. import statesync
    from ..convert import flax_layouts

    cfg = serve_cfg or ServeConfig.from_env()
    model = tfm.TransformerLM(_serving_model_cfg(cfg), device="cpu",
                              seed=cfg.seed)
    tree, info = statesync.join_world(_params_tree(model))
    layouts = flax_layouts(model)
    del model
    params = {}
    for key, t in tree.items():
        name = key[len("params/"):]
        params[name] = layouts[name][1](t)
    ex = ReplicaExecutor(cfg, params=params, device=device)
    service = statesync.StateSyncService(state_provider=ex.state_tree,
                                         static_state=True)
    ex.attach_statesync(service)
    # First collective on the new world: adopt the incumbents' step and
    # generation, and announce this (empty) replica group.
    ex._grow_resync(info.join_id, info.rank, info.size)
    return ex
