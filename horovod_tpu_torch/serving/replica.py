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
- Completions ride back on an all-gather each step, so the front end
  frees slots and records latencies without a side channel.

The serving world is the eager core's: ``hvd.init()`` comes before the
executor, which takes its rank and size from ``hvd``.  The plan and the
completions move through ``hvd.broadcast_object`` and
``hvd.allgather_object`` under the reference's names
(``serve.plan.g0.<step>``, ``serve.done.g0.<step>``; the names feed the
collective fingerprints), in a world of one too, and each runs under
``deadline_scope`` of the earliest in-flight request's deadline: under
``HOROVOD_FAULT_TOLERANCE`` a dead peer converts at once into
``RanksFailedError``, and a wedged one at that deadline while the
exchange's op runs (a wait in the negotiation before it, which no
request deadline bounds, converts at ``HOROVOD_FAULT_TIMEOUT``, as in
the reference).

The model runs on the card unless ``device="cpu"``.  Every call that
writes the KV cache runs under ``torch.inference_mode()``.  Token, block
table and cursor arrays live on the host as numpy, as in the reference:
a decode step copies each to the device once and reads the step's argmax
back once.

Not ported; each raises ``NotImplementedError`` naming its ROADMAP item:
disaggregated prefill (``prefill_ranks > 0``, the kvstream mesh; items 8
and 11), fleet weight swaps (``attach_fleet``) and
``join_serving_world`` (items 11 and 12), the statesync grow
(``attach_statesync``, item 11).  Also not ported: the elastic shrink on
``RanksFailedError`` (item 11).  Where the reference's survivors converge
on the confirmed-dead set, re-form the world without it and resume, the
port's ``serve_loop`` lets the ``RanksFailedError`` propagate, and so
the exchange names keep generation 0.  The serve MFU gauges
(``_note_perf``) are item 12.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..common import config
from ..common.device import resolve_device
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
    # Disaggregated prefill/decode (not ported: > 0 raises).
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
        if self.cfg.prefill_ranks > 0:
            raise NotImplementedError(
                "disaggregated prefill (prefill_ranks > 0, the kvstream "
                "mesh) is ROADMAP queue A items 8 and 11")
        self.device = resolve_device(device)
        self.hvd = hvd
        self.rank = hvd.rank()
        self.size = hvd.size()
        self.front = 0
        self._step = 0
        self._stop_requested = False
        self._configure_groups()

        model_cfg = self.cfg.model_cfg
        if model_cfg is None:
            model_cfg = tfm.gpt_tiny(dtype=torch.float32)
        model_cfg = dataclasses.replace(model_cfg, decode=True,
                                        max_seq_len=self.cfg.max_seq)
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
        self.stats = {"offered": 0, "expired": 0, "served": 0,
                      "served_slo": 0, "lost": 0,
                      "latencies_ms": [], "completed_at": [],
                      "shrinks": [], "grows": [],
                      "prefill_streams": 0, "prefill_fallbacks": 0,
                      "prefill_skipped": 0, "weight_swaps": []}

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
        self._init_cache()
        self._warmup()

    # -- topology --------------------------------------------------------
    def _configure_groups(self) -> None:
        gs = self.cfg.group_size
        if gs <= 0 or self.size % gs:
            if gs > 1:
                logger.warning(
                    "serving: group size %d does not divide the world "
                    "size %d; falling back to per-rank replicas", gs,
                    self.size)
            gs = 1
        self.group_size = gs
        self.group = self.rank // gs
        self.num_groups = self.size // gs
        self.group_leader = self.rank % gs == 0

    def _make_batcher(self) -> ContinuousBatcher:
        return ContinuousBatcher(
            self.num_groups, slots_per_replica=self.cfg.slots,
            token_budget=self.cfg.token_budget,
            block_capacity=self.cfg.resolved_pool_blocks
            if self.cfg.paged else 0,
            block_tokens=self.cfg.block_tokens)

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
            self._step, self.queue, self.admission, stop=stop)
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
                name=f"serve.plan.g0.{self._step}")

    def _apply_plan(self, plan: BatchPlan) -> None:
        now = time.monotonic()
        for a in plan.assign:
            if a.replica != self.group:
                continue
            slot = next(i for i, s in enumerate(self.slots) if s is None)
            if self.cfg.paged:
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

    # -- decode ----------------------------------------------------------
    @torch.inference_mode()
    def _decode_once(self) -> None:
        """One greedy token for every active slot.  The whole slot array
        goes through the model: in the dense layout a free slot's cursor
        keeps advancing (past S, where the write clamps as in JAX), in the
        paged one its table points at the sink."""
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.remaining > 0]
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
            if s is None or s.remaining > 0:
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
        self.slots[i] = None

    def _exchange_completions(self) -> list[dict]:
        """Every rank's new completions, on every rank."""
        from ..resilience import deadline_scope
        mine = {"done": list(self._unreported)}
        with deadline_scope(self._inflight_deadline()):
            per_rank = self.hvd.allgather_object(
                mine, name=f"serve.done.g0.{self._step}")
        self._unreported.clear()       # acknowledged by the exchange
        return [rec for p in per_rank for rec in p["done"]]

    def _account(self, completions: list[dict]) -> None:
        if self.rank != self.front:
            return
        now = time.monotonic()
        for rec in completions:
            if rec["rid"] not in self.batcher.inflight:
                continue
            self.batcher.note_done(rec["rid"])
            self.admission.count("served")
            self.admission.observe_latency_ms(rec["latency_ms"])
            self.stats["served"] += 1
            self.stats["served_slo"] += bool(rec["slo_met"])
            self.stats["latencies_ms"].append(rec["latency_ms"])
            self.stats["completed_at"].append(now)

    # -- not ported ------------------------------------------------------
    def attach_statesync(self, service) -> None:
        raise NotImplementedError(
            "elastic grow mid-serve (statesync) is ROADMAP queue A item 11")

    def attach_fleet(self, kv, *, interval_s: float | None = None):
        raise NotImplementedError(
            "fleet weight deployment (attach_fleet) is ROADMAP queue A "
            "items 11 and 12")

    # -- the loop --------------------------------------------------------
    def _serve_step(self) -> bool:
        t0 = time.monotonic()
        plan = self._assemble() if self.rank == self.front else None
        plan = self._exchange_plan(plan)
        self._step += 1
        if plan.stop:
            return False
        self._apply_plan(plan)
        self._decode_once()
        self._collect_completions()
        self._account(self._exchange_completions())
        self.admission.observe_step_ms((time.monotonic() - t0) * 1e3)
        return True

    def serve_loop(self, *, stop_when=None, max_steps: int | None = None,
                   idle_sleep: float = 0.002) -> None:
        """Run serve steps until the front end declares the system
        drained (``stop_when()`` true on the front end AND queue and
        in-flight empty).  ``max_steps`` is a safety bound for tests."""
        while max_steps is None or self._step < max_steps:
            if self.rank == self.front:
                if stop_when is not None and stop_when():
                    self._stop_requested = True
                if (not self._stop_requested
                        and self.queue.depth() == 0
                        and self.batcher.inflight_count() == 0):
                    time.sleep(idle_sleep)   # don't hot-spin empty plans
            if not self._serve_step():
                return

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
        """Release the serving resources this executor owns: the KV
        block pool."""
        if self.pool is not None:
            self.pool.close()


def join_serving_world(serve_cfg: ServeConfig | None = None
                       ) -> ReplicaExecutor:
    """Join a live serving world as a fresh replica: not ported."""
    raise NotImplementedError(
        "joining a live serving world (statesync grow, fleet) is ROADMAP "
        "queue A items 11 and 12")
