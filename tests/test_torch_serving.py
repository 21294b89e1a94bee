"""Serving of the port against the JAX package, on the CPU.

- The pieces: the same scripted submissions, clock and steps go through
  both packages' ``RequestQueue``, ``AdmissionController``,
  ``ContinuousBatcher`` and ``KVBlockPool``; plans, verdicts, chain hashes
  and pool states must be equal.
- The replica: the JAX ``ReplicaExecutor`` in a solo ``hvd`` world and the
  port's ``ReplicaExecutor(device="cpu")`` with the same weights and
  prompts, dense and paged, give the same token streams up to the first
  token whose logits (the JAX model's full forward) have a top-2 margin
  below 1e-3; the test reports any such cut.  The paged census holds.
- Two ranks of the port's eager core (``hvd.init()`` against the port's
  rendezvous server; the plan and completions ride ``hvd.broadcast_object``
  and ``hvd.allgather_object``): the plan broadcast keeps both in step,
  the front serves every request, and each rank's streams match a
  one-rank run.  Under fault tolerance a chaos SIGKILL of rank 1
  mid-serve makes rank 0 shrink to a world of one and serve on under
  generation 1, the requests lost with rank 1 counted.

The port's executor takes its rank and size from ``hvd``, so every port
executor here is built after ``hvd.init()`` (a world of one in-process).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from horovod_tpu.models import transformer as jtr
from horovod_tpu.serving import admission as j_admission
from horovod_tpu.serving import batcher as j_batcher
from horovod_tpu.serving import kvpool as j_kvpool
from horovod_tpu.serving import queue as j_queue
from horovod_tpu.telemetry import registry as j_registry
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.serving import admission as t_admission
from horovod_tpu_torch.serving import batcher as t_batcher
from horovod_tpu_torch.serving import kvpool as t_kvpool
from horovod_tpu_torch.serving import queue as t_queue
from horovod_tpu_torch.telemetry import registry as t_registry
from torch_sigterm import restore_sigterm  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_serve_worker.py"
NEAR_TIE = 1e-3

JAX_SIDE = SimpleNamespace(queue=j_queue, admission=j_admission,
                           batcher=j_batcher, kvpool=j_kvpool,
                           registry=j_registry)
PORT_SIDE = SimpleNamespace(queue=t_queue, admission=t_admission,
                            batcher=t_batcher, kvpool=t_kvpool,
                            registry=t_registry)


# --- the pieces, driven by one script on both sides -------------------------
class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _fake_clock(monkeypatch) -> _Clock:
    """The pieces' ``time.monotonic`` on both sides, and nowhere else
    in the process."""
    clock = _Clock()
    fake = SimpleNamespace(monotonic=clock)
    for side in (JAX_SIDE, PORT_SIDE):
        for mod in (side.queue, side.batcher, side.admission):
            monkeypatch.setattr(mod, "time", fake)
    return clock


# Each script: constructor arguments, then events.  ("submit", n_tokens,
# max_new, slo_ms); ("tick", seconds); ("step",) assembles a plan;
# ("done", index of an admitted request); ("observe", step ms).
SCRIPTS = {
    "budget_and_least_loaded": dict(
        replicas=2, slots=2, budget=8, queue=64, shed=0.9, seed_ms=5.0,
        events=[("submit", 3, 4, 1000.0)] * 5
        + [("step",), ("tick", 0.01), ("step",), ("done", 0),
           ("tick", 0.01), ("step",), ("submit", 8, 2, 1000.0),
           ("submit", 8, 2, 1000.0), ("done", 1), ("done", 2),
           ("step",), ("step",)]),
    "urgent_after_deferrals": dict(
        replicas=1, slots=2, budget=10, queue=256, shed=0.9, seed_ms=1.0,
        deferrals=3,
        events=[("submit", 40, 4, 60000.0)]
        + [ev for i in range(8) for ev in (
            ("submit", 3, 2, 60000.0), ("submit", 3, 2, 60000.0),
            ("step",), ("tick", 0.002), ("done_all",))]),
    "block_capacity": dict(
        replicas=1, slots=8, budget=1000, queue=64, shed=0.9, seed_ms=5.0,
        block_capacity=10, block_tokens=16,
        events=[("submit", 16, 16, 1000.0)] * 4
        + [("step",), ("done", 0), ("step",), ("submit", 40, 8, 1000.0),
           ("done", 1), ("done", 2), ("step",)]),
    "admission_verdicts": dict(
        replicas=1, slots=4, budget=64, queue=10, shed=0.5, seed_ms=10.0,
        events=[("submit", 2, 4, 5.0), ("submit", 2, 100, 50.0),
                ("tick", 0.02), ("submit", 2, 4, 10000.0), ("step",)]
        + [("observe", 40.0)] * 10
        + [("submit", 2, 30, 1000.0), ("submit", 2, 9, 1000.0),
           ("step",)] + [("submit", 2, 2, 10000.0)] * 7 + [("step",)]),
}


def _drive(side, script, clock):
    reg = side.registry.MetricsRegistry(0)
    q = side.queue.RequestQueue(maxsize=script["queue"],
                                default_slo_ms=1000.0, registry=reg)
    adm = side.admission.AdmissionController(
        registry=reg, queue_depth_limit=script["queue"],
        shed_fraction=script["shed"], step_ms_seed=script["seed_ms"])
    b = side.batcher.ContinuousBatcher(
        script["replicas"], slots_per_replica=script["slots"],
        token_budget=script["budget"], max_prompt_tokens=256,
        block_capacity=script.get("block_capacity", 0),
        block_tokens=script.get("block_tokens", 16),
        max_deferrals=script.get("deferrals", 8))
    record, admitted, step = [], [], 0
    rng = random.Random(3)
    for event in script["events"]:
        kind = event[0]
        if kind == "submit":
            toks = [rng.randrange(2, 256) for _ in range(event[1])]
            record.append(("rid", q.submit(toks, event[2], event[3])))
        elif kind == "tick":
            clock.now += event[1]
        elif kind == "observe":
            adm.observe_step_ms(event[1])
        elif kind == "done":
            b.note_done(admitted[event[1]])
        elif kind == "done_all":
            for rid in list(b.inflight):
                b.note_done(rid)
        else:
            plan, expired = b.assemble(step, q, adm)
            step += 1
            admitted += [a.rid for a in plan.assign]
            record.append(("plan", [dataclasses.asdict(a)
                                    for a in plan.assign],
                           [r.rid for r in expired], q.depth(),
                           list(b._active), list(b._blocks),
                           dict(b.inflight), b.max_concurrent))
    outcomes = {k: c.value for k, c in adm._m_outcome.items()}
    record.append(("end", outcomes, adm.step_ms(),
                   [r.deferrals for r in q._items]))
    return record


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_queue_admission_batcher_match_reference(name, monkeypatch):
    clock = _fake_clock(monkeypatch)
    records = []
    for side in (JAX_SIDE, PORT_SIDE):
        clock.now = 1000.0
        records.append(_drive(side, SCRIPTS[name], clock))
    assert records[1] == records[0]
    assert any(r[0] == "plan" and r[1] for r in records[0])


@pytest.mark.parametrize("side", [JAX_SIDE, PORT_SIDE],
                         ids=["reference", "port"])
def test_admission_verdicts_direct(side, monkeypatch):
    """The four verdicts on requests built by hand, on both packages."""
    clock = _fake_clock(monkeypatch)
    adm = side.admission.AdmissionController(
        registry=side.registry.MetricsRegistry(0), queue_depth_limit=10,
        shed_fraction=0.5, step_ms_seed=10.0)

    def req(max_new, slo_ms, age_s=0.0):
        now = clock.now
        return side.queue.ServeRequest(
            rid=0, tokens=[1, 2, 3], max_new_tokens=max_new,
            arrival=now - age_s, deadline=now - age_s + slo_ms / 1e3,
            slo_ms=slo_ms)
    assert adm.admit(req(4, 1.0, 1.0), 0) == (False, "expired")
    assert adm.admit(req(4, 10000.0), 9) == (False, "shed")
    assert adm.admit(req(100, 50.0), 0) == (False, "shed")
    assert adm.admit(req(4, 10000.0), 0) == (True, "admitted")
    assert adm.outcome_totals() == {"admitted": 1, "expired": 1,
                                    "shed": 2, "served": 0, "lost": 0}


def test_chain_hash_matches_reference():
    rng = np.random.default_rng(5)
    assert t_kvpool.FNV_SEED == j_kvpool.FNV_SEED
    parent = j_kvpool.FNV_SEED
    for n in (0, 1, 7, 16, 33):
        toks = rng.integers(0, 2 ** 31, n).tolist() + [-1, 2 ** 40]
        got = t_kvpool.chain_hash(parent, toks)
        assert got == j_kvpool.chain_hash(parent, toks)
        parent = got


def _pool_state(p):
    return (list(p._free), list(p._ref), dict(p._by_hash),
            dict(p._hash_of), dict(p._tokens_of), list(p._lru),
            p._m_hits.value, p._m_misses.value, p._m_evicted.value,
            p._m_cow.value, p.free_count(), p.active_count(),
            p.cached_count())


def _pool_script(side):
    """Alloc, publish, lookup, copy-on-write, deref to the LRU, and
    eviction under pressure; the state after each phase."""
    p = side.kvpool.KVBlockPool(8, 4,
                                registry=side.registry.MetricsRegistry(0))
    states = []
    a = p.alloc(3)
    k0 = p.publish(a[0], side.kvpool.FNV_SEED, [1, 2, 3, 4])
    k1 = p.publish(a[1], k0, [5, 6, 7, 8])
    p.publish(a[2], k1, [9])
    states.append(_pool_state(p))
    hits = [p.lookup(side.kvpool.FNV_SEED, [1, 2, 3, 4]),
            p.lookup(k0, [5, 6, 7, 8]), p.lookup(k1, [9, 9])]
    states.append((hits, _pool_state(p)))
    new, copied = p.cow(hits[1])
    states.append((new, copied, p.cow(new), _pool_state(p)))
    for blk in a + [hits[0], new]:
        p.deref(blk)
    states.append(_pool_state(p))
    got = p.alloc(7)                     # evicts the oldest cached
    states.append((got, p.alloc(2), _pool_state(p)))
    p.close()
    states.append(_pool_state(p))
    return states


def test_kv_block_pool_matches_reference():
    assert _pool_script(PORT_SIDE) == _pool_script(JAX_SIDE)


# --- the replica, against the JAX replica -----------------------------------
def _solo_world():
    import horovod_tpu as hvd
    hvd.shutdown()
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        os.environ.pop(var, None)
    hvd.init()
    return hvd


def _record_streams(ex):
    """rid -> generated tokens, captured as each slot completes."""
    streams = {}
    orig = ex._collect_completions

    def wrapped():
        for s in ex.slots:
            if s is not None and getattr(s, "pending", None) is None \
                    and s.remaining == 0:
                streams[s.rid] = list(s.generated)
        orig()
    ex._collect_completions = wrapped
    return streams


def _cfg_kwargs(**kw):
    return dict(dict(max_batch=2, token_budget=64, max_seq=64,
                     slo_ms=60000.0, block_tokens=8), **kw)


def _prompts(seed, n=4, lo=2, hi=12):
    rng = random.Random(seed)
    return [[rng.randrange(2, 256) for _ in range(rng.randint(lo, hi))]
            for _ in range(n)]


def _submit(ex, prompts, n, max_new=6):
    rids = {}
    for i in range(n):
        ex.stats["offered"] += 1
        rid = ex.queue.submit(prompts[i % len(prompts)], max_new)
        assert rid is not None
        rids[rid] = prompts[i % len(prompts)]
    return rids


def _near_tie_cut(params, prompt, stream):
    """Index of the first generated token whose logits under the JAX
    model's full forward have a top-2 margin below NEAR_TIE (len(stream)
    when none has)."""
    model = jtr.TransformerLM(jtr.gpt_tiny(dtype=jnp.float32))
    seq = jnp.asarray([list(prompt) + list(stream)], jnp.int32)
    logits = np.asarray(model.apply({"params": params}, seq))[0]
    for j in range(len(stream)):
        top2 = np.sort(logits[len(prompt) - 1 + j])[-2:]
        if top2[1] - top2[0] < NEAR_TIE:
            return j
    return len(stream)


def _assert_streams_agree(got, want, rid_prompt, params, label):
    assert sorted(got) == sorted(want), label
    cuts = {}
    for rid, ref in want.items():
        cut = _near_tie_cut(params, rid_prompt[rid], ref)
        assert got[rid][:cut] == ref[:cut], (label, rid, got[rid], ref)
        if cut < len(ref):
            cuts[rid] = cut
    if cuts:
        print(f"{label}: streams compared up to a near tie: {cuts}")
    return cuts


@pytest.fixture(scope="module")
def jax_replica_runs():
    """The JAX replica's streams and pool census, dense and paged, on
    the parity test's config, with its weights."""
    from horovod_tpu.serving import ReplicaExecutor, ServeConfig
    runs = {}
    for paged in (False, True):
        hvd = _solo_world()
        try:
            ex = ReplicaExecutor(ServeConfig.from_env(
                **_cfg_kwargs(paged=paged)))
            streams = _record_streams(ex)
            rids = _submit(ex, _prompts(7), 12)
            ex.serve_loop(stop_when=lambda: True)
            runs[paged] = dict(streams=streams, rids=rids,
                               served=ex.stats["served"],
                               kv=ex.kv_stats(), params=ex.params)
            ex.close()
        finally:
            hvd.shutdown()
    return runs


@pytest.fixture(autouse=True)
def _port_world_down():
    """The port's world of one, if a test started it, ends with it."""
    yield
    import horovod_tpu_torch as thvd
    thvd.shutdown()


def _port_executor(params=None, **kw):
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    thvd.init(rank=0, size=1)
    state = None if params is None else convert.params_from_flax(
        params, ttr.gpt_tiny())
    return ReplicaExecutor(ServeConfig.from_env(**_cfg_kwargs(**kw)),
                           params=state, device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_replica_streams_match_jax_replica(jax_replica_runs, paged):
    ref = jax_replica_runs[paged]
    ex = _port_executor(ref["params"], paged=paged)
    streams = _record_streams(ex)
    rids = _submit(ex, _prompts(7), 12)
    assert rids == ref["rids"]
    ex.serve_loop(stop_when=lambda: True)
    assert ex.stats["served"] == ref["served"] == 12
    _assert_streams_agree(streams, ref["streams"], rids, ref["params"],
                          "paged" if paged else "dense")
    if paged:
        # The same plans, so the same pool traffic.
        assert ex.kv_stats() == ref["kv"]
    ex.close()


def test_paged_serve_parity_prefix_hits_and_refcount_census():
    """The port's copy of the reference's census test: paged decode gives
    the dense streams token for token, repeated prompts hit the prefix
    cache (COW on the first divergent write, full hits skip prefill),
    and after the drain no block is active."""
    streams = {}
    for paged in (False, True):
        ex = _port_executor(paged=paged)
        rec = _record_streams(ex)
        _submit(ex, _prompts(7), 12)
        ex.serve_loop(stop_when=lambda: True)
        assert ex.stats["served"] == 12
        if paged:
            kv = ex.kv_stats()
            assert kv["active"] == 0, kv          # refcount census
            assert kv["prefix_hits"] > 0, kv      # repeated prompts hit
            assert kv["cow_copies"] > 0, kv       # shared tails copied
            assert kv["prefill_skipped"] > 0, kv  # full hits skip prefill
            assert kv["max_concurrent_seqs"] > ex.cfg.max_batch
        streams[paged] = dict(rec)
        ex.close()
    assert streams[False] == streams[True]


def test_paged_eviction_then_readmission_stays_correct():
    """Cached prefix blocks evicted under pool pressure change nothing: a
    re-admitted prompt misses, prefills afresh and reproduces its first
    generation exactly."""
    ex = _port_executor(paged=True, paged_slots=2, pool_blocks=8)
    rec = _record_streams(ex)
    prompts = _prompts(11, lo=9, hi=9)
    rid_prompt = {}
    for _ in (0, 1):
        rid_prompt.update(_submit(ex, prompts, 4))
        ex._stop_requested = False
        ex.serve_loop(stop_when=lambda: True)
    kv = ex.kv_stats()
    assert ex.stats["served"] == 8
    assert kv["evictions"] > 0, kv
    assert kv["active"] == 0, kv
    by_prompt = {}
    for rid, stream in sorted(rec.items()):
        by_prompt.setdefault(tuple(rid_prompt[rid]), []).append(stream)
    for p, gens in by_prompt.items():
        assert len(gens) == 2 and gens[0] == gens[1], p
    ex.close()


def test_unported_parts_raise():
    """Fleet weight swaps are what is left unported (item 12).  The
    elastic pieces no longer raise: a prefill rank is clamped away in a
    world of one (one decode rank must remain), and a statesync service
    attaches."""
    ex = _port_executor(prefill_ranks=1, paged=True)
    assert ex.prefill_rank_list == [] and ex.decode_size == 1
    assert not ex.is_prefill
    ex.attach_statesync(None)
    assert ex.statesync is None
    with pytest.raises(NotImplementedError, match="item 12"):
        ex.attach_fleet(None)
    ex.close()


def test_loadgen_report_schema_matches_reference(tmp_path):
    from horovod_tpu.serving import loadgen as jloadgen
    from horovod_tpu_torch.serving import loadgen
    out = tmp_path / "SERVE_r{rank}.json"
    assert loadgen.main(["--requests", "6", "--duration", "3", "--rate",
                         "50", "--max-new-tokens", "4", "--prompt-tokens",
                         "6", "--prompt-pool", "2", "--device", "cpu",
                         "--output", str(out)]) == 0
    report = json.loads((tmp_path / "SERVE_r0.json").read_text())
    assert loadgen.SCHEMA == jloadgen.SCHEMA == report["schema"]
    assert report["offered"] == 6 == report["served"]
    assert report["tokens_generated"] == 6 * 4
    assert report["step_ms"]["count"] > 0 and report["step_metrics_present"]
    assert report["latency_ms"]["p99"] >= report["latency_ms"]["p50"] > 0
    assert report["weights"]["ported"] is False
    # The reference's report keys, every one.
    ref_keys = {"schema", "rank", "world", "goodput_phases", "config",
                "offered", "served", "served_within_slo", "expired",
                "lost_on_failure", "shed", "shed_rate", "latency_ms",
                "step_ms", "goodput_rps", "offered_rps",
                "tokens_generated", "local_completed", "wall_s", "steps",
                "step_metrics_present", "kv", "max_concurrent_seqs",
                "weights"}
    assert set(report) == ref_keys


# --- two ranks of the eager core ---------------------------------------------
GLOO_N, GLOO_MAX_NEW = 10, 5
KILL_FAULT_TIMEOUT = 3.0


def _serve_world(tmp_path, spec: dict, expected_rcs=None) -> list[dict]:
    """Two ``torch_serve_worker.py`` ranks against one of the port's
    rendezvous servers; each rank's exit code (0 unless ``expected_rcs``
    says otherwise) and its OUT.json, where it wrote one."""
    from horovod_tpu_torch.runner.network import RendezvousServer
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    server = RendezvousServer()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["HOROVOD_FLIGHT_FILE"] = str(tmp_path / "flight.json")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", str(port),
         str(tmp_path / "spec.json"), str(tmp_path / f"out{r}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == (expected_rcs or {}).get(r, 0), log
    return [json.loads((tmp_path / f"out{r}.json").read_text())
            if (tmp_path / f"out{r}.json").exists() else None
            for r in range(2)]


def test_two_rank_gloo_serving(tmp_path):
    """Two ranks of the eager core serve in step (the name is from when
    the exchanges rode a gloo process group)."""
    prompts = _prompts(13, n=5)
    outs = _serve_world(tmp_path, dict(
        prompts=prompts, n=GLOO_N, max_new=GLOO_MAX_NEW,
        cfg=_cfg_kwargs(group_size=1), epoch="serve2"))
    assert outs[0]["failure"] is None and outs[1]["failure"] is None
    # In step: the same plans and step count on both ranks.
    assert outs[0]["plans"] == outs[1]["plans"]
    assert outs[0]["steps"] == outs[1]["steps"]
    # The front served everything offered; each rank served its group's.
    assert outs[0]["served"] == outs[0]["offered"] == GLOO_N
    replicas = {a[0]: a[1] for plan in outs[0]["plans"] for a in plan}
    assert sorted(replicas) == list(range(GLOO_N))
    assert set(replicas.values()) == {0, 1}
    for r in range(2):
        mine = {int(k) for k in outs[r]["streams"]}
        assert mine == {rid for rid, g in replicas.items() if g == r}
    # Each rank's streams are a one-rank run's.
    solo = _port_executor(group_size=1)
    want = _record_streams(solo)
    rids = _submit(solo, prompts, GLOO_N, GLOO_MAX_NEW)
    solo.serve_loop(stop_when=lambda: True)
    params = convert.params_to_flax(solo.model.state_dict(), ttr.gpt_tiny())
    got = {int(k): v for out in outs for k, v in out["streams"].items()}
    _assert_streams_agree(got, want, rids, params, "gloo")
    solo.close()


def test_two_rank_serving_chaos_kill(tmp_path):
    """Fault tolerance on, chaos SIGKILLs rank 1 at collective 11 (the
    completions exchange's data allgather of serve step 2, four
    collectives a step) with requests in flight: rank 0 converges on the
    confirmed-dead set {1}, shrinks to a world of one and serves on under
    generation 1.  The requests that were on rank 1 are counted lost,
    every other one is served, and the survivor's streams are a one-rank
    run's."""
    prompts = _prompts(13, n=5)
    outs = _serve_world(tmp_path, dict(
        prompts=prompts, n=GLOO_N, max_new=GLOO_MAX_NEW,
        cfg=_cfg_kwargs(group_size=1), epoch="servekill",
        env={"HOROVOD_FAULT_TOLERANCE": "1",
             "HOROVOD_FAULT_TIMEOUT": str(KILL_FAULT_TIMEOUT),
             "HOROVOD_CHAOS": "kill:rank=1,op=11,sig=9"}),
        expected_rcs={1: -signal.SIGKILL})
    out = outs[0]
    assert out["failure"] is None, out
    assert [(s["dead"], s["from"], s["to"]) for s in out["shrinks"]] == \
        [([1], 2, 1)], out["shrinks"]
    assert out["gen"] == 1
    gens = out["plan_gens"]
    assert gens[0] == 0 and gens[-1] == 1 and gens == sorted(gens), gens
    assert out["lost"] > 0, out
    assert out["expired"] == 0, out
    assert out["served"] + out["lost"] == out["offered"] == GLOO_N, out
    assert outs[1] is None                      # killed before its report
    # The survivor's requests: every token a one-rank run's.
    solo = _port_executor(group_size=1)
    want = _record_streams(solo)
    rids = _submit(solo, prompts, GLOO_N, GLOO_MAX_NEW)
    solo.serve_loop(stop_when=lambda: True)
    params = convert.params_to_flax(solo.model.state_dict(), ttr.gpt_tiny())
    got = {int(k): v for k, v in out["streams"].items()}
    assert len(got) == out["served"]
    _assert_streams_agree(got, {r: want[r] for r in got}, rids, params,
                          "survivor")
    solo.close()


# Both packages' bf16 runs under 6 pytest-xdist workers took 40 s
# (dense) and 54 s (paged) for what takes 1.3 s alone (each worker's torch
# runs 8 threads on the same 8 cores): the 60 s SLO of ``_cfg_kwargs``
# then expired the last paged request and it left the streams.  What the
# test compares are streams, so neither package's requests may expire.
NO_DEADLINE_MS = 24 * 3600 * 1000.0


def _dense_paged_agreement(run) -> tuple[int, int]:
    """(requests whose dense and paged streams are equal, requests), from
    ``run(paged)`` -> rid -> stream."""
    dense, paged = run(False), run(True)
    assert sorted(dense) == sorted(paged)
    return sum(dense[r] == paged[r] for r in dense), len(dense)


def test_bf16_dense_and_paged_agree_as_often_as_in_the_reference():
    """bf16 gpt_tiny, the same weights and prompts through both packages:
    the port's dense and paged streams agree on at least as many requests
    as the JAX package's do.  In bf16 the paged gather and the dense
    cache round alike but sum attention in another order, so a stream
    may part at a near tie in either package."""
    from horovod_tpu.serving import ReplicaExecutor, ServeConfig
    prompts = _prompts(13, n=8, lo=20, hi=40)
    params = {}

    def run_jax(paged):
        hvd = _solo_world()
        try:
            ex = ReplicaExecutor(ServeConfig.from_env(**_cfg_kwargs(
                paged=paged, model_cfg=jtr.gpt_tiny(),
                slo_ms=NO_DEADLINE_MS)), params=params.get("p"))
            params["p"] = ex.params
            streams = _record_streams(ex)
            _submit(ex, prompts, 16, max_new=24)
            ex.serve_loop(stop_when=lambda: True)
            ex.close()
            return dict(streams)
        finally:
            hvd.shutdown()

    def run_port(paged):
        ex = _port_executor(params["p"], paged=paged,
                            model_cfg=ttr.gpt_tiny(), slo_ms=NO_DEADLINE_MS)
        streams = _record_streams(ex)
        _submit(ex, prompts, 16, max_new=24)
        ex.serve_loop(stop_when=lambda: True)
        ex.close()
        return dict(streams)

    jax_agree, n = _dense_paged_agreement(run_jax)
    port_agree, n_port = _dense_paged_agreement(run_port)
    print(f"bf16 dense == paged: JAX {jax_agree}/{n}, port "
          f"{port_agree}/{n_port}")
    assert n == n_port == 16
    assert port_agree >= jax_agree
