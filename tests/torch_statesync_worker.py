"""One rank of a port world running an elastic-membership battery:

    python torch_statesync_worker.py BATTERY RANK SIZE PORT OUTDIR

The batteries are the reference's (``tests/mp_worker.py``
``battery_statesync_grow``, ``_joiner``, ``_preempt``, ``_serve``,
``_serve_joiner`` and ``battery_serving_disagg``) on ``horovod_tpu_torch``
and CPU torch tensors, with the reference's environment (``ENV``) and
in-battery assertions.  The grow world is 3 -> 2 -> 3 (the reference's
is 4 -> 3 -> 4).  A joiner (``joiner``, ``serve_joiner``) is started by
the world's rank 0 with RANK and SIZE ignored: it enters the world
itself through ``join_world``.

``grow-sharded`` and ``grow-plain`` have no reference battery: a narrow
fp32 Transformer trained by ``Trainer`` at fsdp=2 (``grow-sharded``
with the FSDP rule table, ``grow-plain`` with none) grows to fsdp=3 by a
joiner (``joiner-sharded``, ``joiner-plain``), whose SIGTERM then
shrinks it back to fsdp=2.  Every rank records each step's size, loss
and the digest of its gathered state; the test holds the two batteries
to each other bit for bit.  Each world forms its gloo process group
over the rendezvous KV after every transition.

Each rank prints its verdict line and writes ``OUTDIR/<battery>.<launch
rank>.json``: the kinds and names of its flight ring's events in order
(``flight``) and the battery's record.  An assertion fails the rank's
exit code.  It imports torch, numpy and the port only.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

COMMON = {"HOROVOD_SHM_OPERATIONS": "0",
          "HOROVOD_FLIGHT_FILE": "{outdir}/flight.json",
          "HOROVOD_FLIGHT_EVENTS": "4096",
          "HOROVOD_STATESYNC_TIMEOUT_SECONDS": "45",
          "HOROVOD_FAULT_TOLERANCE": "1",
          "HOROVOD_GLOO_TIMEOUT_SECONDS": "90"}
ENV = {
    # A real SIGKILL of rank 2 mid-training: each step is the train
    # allreduce plus the membership allgather's two collectives.
    "grow": {"HOROVOD_FAULT_TIMEOUT": "5",
             "HOROVOD_CHAOS": "kill:rank=2,op=13,sig=9"},
    "joiner": {"HOROVOD_FAULT_TIMEOUT": "5"},
    # Grace must beat the heartbeat: a generous fault timeout, SIGTERM
    # at collective 6, 20 s to reach the next step boundary.
    "preempt": {"HOROVOD_FAULT_TIMEOUT": "30",
                "HOROVOD_PREEMPT_GRACE_S": "20",
                "HOROVOD_CHAOS": "preempt:rank=1,op=6"},
    # The sharded grow: the joiner sends itself SIGTERM after its third
    # step in the grown world, inside the grace window.
    "grow-sharded": {"HOROVOD_FAULT_TIMEOUT": "30",
                     "HOROVOD_PREEMPT_GRACE_S": "30"},
    "grow-plain": {"HOROVOD_FAULT_TIMEOUT": "30",
                   "HOROVOD_PREEMPT_GRACE_S": "30"},
    "joiner-sharded": {"HOROVOD_FAULT_TIMEOUT": "30",
                       "HOROVOD_PREEMPT_GRACE_S": "30"},
    "joiner-plain": {"HOROVOD_FAULT_TIMEOUT": "30",
                     "HOROVOD_PREEMPT_GRACE_S": "30"},
    "serve": {"HOROVOD_FAULT_TIMEOUT": "10"},
    "serve_joiner": {"HOROVOD_FAULT_TIMEOUT": "10"},
    # The split-role loop under the strict fingerprint: a rank-divergent
    # collective anywhere in it would end the battery with an error.
    "disagg": {"HOROVOD_FINGERPRINT": "strict",
               "HOROVOD_METRICS": "on",
               "HOROVOD_FAULT_TOLERANCE": "0"},
}
JOINERS = {"grow": "joiner", "serve": "serve_joiner",
           "grow-sharded": "joiner-sharded", "grow-plain": "joiner-plain"}
# The sharded grow's model (every dim the FSDP table cuts divides by 2
# and by 3), its table, the global batch of each step (12 rows: 6 a rank
# at fsdp=2, 4 at fsdp=3) and the steps of each world size.
SHARDED_MODEL = dict(vocab_size=384, d_model=96, num_heads=6, num_layers=2)
SHARDED_RULES = ((r"embedding|kernel", ("fsdp",)),)
SHARDED_ROWS, SHARDED_SEQ = 12, 16
SHARDED_BEFORE, SHARDED_GROWN, SHARDED_AFTER = 2, 3, 3
SERVE_GROW_CFG = dict(max_batch=4, token_budget=64, max_seq=64,
                      slo_ms=120000.0)
DISAGG_CFG = dict(max_batch=4, token_budget=256, max_seq=64,
                  slo_ms=120000.0, paged=True, block_tokens=8)
DISAGG_REQUESTS, DISAGG_MAX_NEW = 12, 8


def disagg_prompts(vocab: int) -> list[list[int]]:
    """The reference battery's long prompts (3-5 blocks of 8)."""
    rng = random.Random(5)
    return [[rng.randrange(2, vocab) for _ in range(rng.randint(24, 40))]
            for _ in range(DISAGG_REQUESTS)]


def _flight_events() -> list[list[str]]:
    from horovod_tpu_torch.telemetry import flight
    return [[ev["kind"], ev.get("name", "")]
            for ev in flight.recorder().snapshot()]


def _write(outdir: str, battery: str, launch_rank, record: dict) -> None:
    record = dict(record, flight=_flight_events())
    with open(os.path.join(outdir, f"{battery}.{launch_rank}.json"),
              "w") as f:
        json.dump(record, f)


def _spawn_joiner(battery: str, outdir: str) -> subprocess.Popen:
    env = dict(os.environ)
    for k in ("HOROVOD_CHAOS", "HOROVOD_RANK", "HOROVOD_SIZE"):
        env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), JOINERS[battery], "0",
         "0", os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"], outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _reap_joiner(proc: subprocess.Popen, expect: str) -> None:
    out, _ = proc.communicate(timeout=90.0)
    text = out.decode(errors="replace")
    print("--- joiner output ---\n" + text)
    assert proc.returncode == 0, \
        f"joiner failed rc={proc.returncode}:\n{text}"
    assert expect in text, text


# --- training state ---------------------------------------------------------
def _state(n: int = 1 << 18) -> dict:
    """Replicated training state: params and opt evolve by the (equal on
    every rank) allreduce output, so donors' snapshots are coherent and
    digests comparable."""
    return {"params": torch.zeros(n), "opt": torch.zeros(n),
            "step": torch.zeros((), dtype=torch.int64)}


def _train_step(hvd, state: dict) -> torch.Tensor:
    n = state["params"].numel()
    mine = torch.full((n,), float(hvd.rank() + 1))
    out = hvd.allreduce(mine, op=hvd.Sum,
                        name=f"sst.train.{int(state['step'])}")
    expected = hvd.size() * (hvd.size() + 1) / 2.0
    assert torch.equal(out[:8], torch.full((8,), expected)), out[:8]
    state["params"] += 0.01 * out
    state["opt"] += out * out
    state["step"] += 1
    return out


def _digest_check(hvd, state: dict) -> int:
    """Every rank's state must be bit-identical after a grow."""
    from horovod_tpu_torch import statesync
    digest = statesync.state_digest(statesync.flatten_state(state))
    views = hvd.allgather_object(digest,
                                 name=f"sst.digest.{int(state['step'])}")
    assert len(set(views)) == 1, f"post-grow state divergence: {views}"
    return digest


def battery_grow(hvd, rank: int, size: int, outdir: str) -> None:
    """The chaos kill of rank 2 mid-training; the survivors shrink with
    zero failed steps after the conversion, then rank 0 starts a
    replacement process that joins by peer state streaming — the
    incumbents never fail a step while it catches up, and after the grow
    every rank's state is bit-identical."""
    from horovod_tpu_torch import statesync
    state = _state()
    svc = statesync.StateSyncService(lambda: state)
    shrunk = grown = False
    stop_at = None
    joiner = None
    deadline = time.monotonic() + 150.0
    while time.monotonic() < deadline:
        try:
            _train_step(hvd, state)
            change = svc.step_boundary()
        except hvd.RanksFailedError as exc:
            assert not shrunk, f"step failed AFTER the shrink: {exc}"
            change = svc.shrink_on_failure(exc)
        if change is not None and change.kind == "shrink":
            shrunk = True
            assert hvd.size() == size - 1, hvd.size()
            assert 2 in change.dead, change
            # Survivors may have caught the kill on different steps: the
            # most advanced one is the authority.
            state = statesync.resync_replicated(state, int(state["step"]))
            if hvd.rank() == 0:
                joiner = _spawn_joiner("grow", outdir)
        elif change is not None and change.kind == "grow":
            grown = True
            assert shrunk, "grew before the shrink?"
            assert hvd.size() == size, hvd.size()
            stop_at = int(state["step"]) + 3
        if stop_at is not None and int(state["step"]) >= stop_at:
            break
    assert shrunk and grown, (shrunk, grown)
    digest = _digest_check(hvd, state)
    svc.close()
    if joiner is not None:
        _reap_joiner(joiner, "joiner: catch-up")
    _write(outdir, "grow", rank, {"digest": digest,
                                  "step": int(state["step"])})
    print(f"launch rank {rank}: rode {size}->{size - 1}->{size} to step "
          f"{int(state['step'])} with zero failed post-shrink steps")


def battery_joiner(outdir: str) -> int:
    """The replacement rank of the grow battery: before any hvd.init,
    join_world streams state from the live donors, verifies it and
    enters the world; then it trains in step with the incumbents."""
    from horovod_tpu_torch import statesync
    t0 = time.monotonic()
    tree, info = statesync.join_world(_state())
    import horovod_tpu_torch as hvd
    assert hvd.is_initialized() and hvd.rank() == info.rank
    # The assembled state's digest against the unanimous stamp (the
    # independent check; pull_round verified it once).
    image = statesync.flatten_state(tree)
    assert statesync.state_digest(image) == info.stamp.digest
    # Bounded catch-up: the bulk transfer from N donors in parallel
    # costs no more than about one donor's own streaming time.
    max_donor_s = max((w for _, w in info.donor_stats.values()),
                      default=0.0)
    bulk_s = info.catch_up_ms / 1e3
    assert bulk_s < 2.0 * max_donor_s + 10.0, \
        (bulk_s, max_donor_s, info.donor_stats)
    state = tree
    svc = statesync.StateSyncService(lambda: state)
    stop_at = int(state["step"]) + 3
    while int(state["step"]) < stop_at:
        _train_step(hvd, state)
        svc.step_boundary()
    digest = _digest_check(hvd, state)
    svc.close()
    _write(outdir, "joiner", "J", {"digest": digest,
                                   "step": int(state["step"]),
                                   "donors": len(info.donor_stats),
                                   "bulk_bytes": info.bulk_bytes})
    print(f"joiner: catch-up {info.catch_up_ms:.0f} ms for "
          f"{info.bulk_bytes} bytes from {len(info.donor_stats)} donors; "
          f"entered as rank {info.rank}/{info.size} at step "
          f"{stop_at - 3}; total wall {time.monotonic() - t0:.1f}s")
    hvd.shutdown()
    return 0


def battery_preempt(hvd, rank: int, size: int, outdir: str) -> None:
    """Chaos delivers SIGTERM to rank 1 mid-training.  The preempted rank
    finishes its step, announces departure through the boundary check,
    fast-donates its opt state, writes bye| and exits 0; the survivors
    shrink proactively at the same boundary — no RanksFailedError is
    raised anywhere, and the heartbeat never declares rank 1 failed."""
    from horovod_tpu_torch import resilience, statesync
    from horovod_tpu_torch.runner.network import RendezvousClient
    state = _state(n=1 << 12)
    svc = statesync.StateSyncService(
        lambda: state, donate_provider=lambda: {"shard": state["opt"]})
    kv = RendezvousClient("127.0.0.1",
                          int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"]),
                          20.0)
    shrunk_at = None
    pre_epoch = os.environ["HOROVOD_RENDEZVOUS_EPOCH"]
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        prev_epoch = os.environ["HOROVOD_RENDEZVOUS_EPOCH"]
        # No try/except: ANY RanksFailedError here fails the battery.
        _train_step(hvd, state)
        change = svc.step_boundary()
        if change is not None and change.kind == "departed":
            assert rank == 1, rank
            raw = kv.get("hb", f"{prev_epoch}:1")
            assert raw is not None and raw.startswith(b"bye|"), raw
            _write(outdir, "preempt", rank, {"departed": True})
            print("preempted rank: departed with bye| stamp inside the "
                  "grace window")
            return
        if change is not None and change.kind == "shrink":
            assert change.dead == (1,), change
            assert hvd.size() == size - 1
            shrunk_at = int(state["step"])
            donated = statesync.fetch_donation(
                prev_epoch, 1, {"shard": torch.zeros_like(state["opt"])},
                kv=kv)
            assert donated is not None
            state = statesync.resync_replicated(state, int(state["step"]))
        if shrunk_at is not None and int(state["step"]) >= shrunk_at + 3:
            break
    assert shrunk_at is not None, "the preemption never happened"
    st = resilience.active_state()
    assert st is None or not st.failed_ranks(), \
        f"proactive shrink must beat the heartbeat: {st.failed_ranks()}"
    assert os.environ["HOROVOD_RENDEZVOUS_EPOCH"] != pre_epoch
    svc.close()
    _write(outdir, "preempt", rank, {"shrunk_at": shrunk_at})
    print(f"survivor {rank}: proactive shrink at step {shrunk_at}, no "
          f"RanksFailedError anywhere")


# --- the sharded grow -------------------------------------------------------
class ShardedRun:
    """One rank's Trainer of the sharded grow (``grow-sharded``: the
    FSDP table; ``grow-plain``: no rules), rebuilt on a mesh of the
    current world after every transition from the whole state tree."""

    def __init__(self, battery: str):
        self.sharded = battery.endswith("sharded")
        port = int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"])
        from horovod_tpu_torch.runner.network import RendezvousClient
        self.kv = RendezvousClient("127.0.0.1", port, 60.0)
        self.trainer = self.state = None
        self.records: list[dict] = []

    @staticmethod
    def fresh():
        """A fresh unsharded state of the model and optimizer."""
        from horovod_tpu_torch import TransformerLM, gpt_tiny
        from horovod_tpu_torch.training import TrainState
        model = TransformerLM(gpt_tiny(dtype=torch.float32,
                                       **SHARDED_MODEL),
                              device="cpu", seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                weight_decay=1e-4)
        return TrainState(step=0, model=model, optimizer=opt)

    def build(self, tree) -> None:
        """The old Trainer and its group released, the current world's
        gloo group formed, then a Trainer on a mesh of fsdp = size over a
        fresh model, and ``tree`` (whole) cut into it."""
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import Trainer, build_mesh
        from horovod_tpu_torch.checkpoint import load_train_state
        from horovod_tpu_torch.parallel import multihost
        from horovod_tpu_torch.parallel.sharding import ShardingRules
        self.trainer = self.state = None
        multihost.shutdown()
        multihost.init_process_group(hvd.rank(), hvd.size(), self.kv,
                                     backend="gloo")
        fresh = self.fresh()
        mesh = build_mesh(fsdp=hvd.size(), device="cpu")
        self.trainer = Trainer(
            fresh.model, fresh.optimizer, mesh,
            param_rules=ShardingRules(list(SHARDED_RULES))
            if self.sharded else None)
        self.state = load_train_state(tree, self.trainer.init())

    def tree(self):
        from horovod_tpu_torch.checkpoint import train_state_tree
        return train_state_tree(self.state, gather=self.sharded)

    def digest(self) -> int:
        from horovod_tpu_torch import statesync
        return statesync.state_digest(statesync.flatten_state(self.tree()))

    def step(self) -> None:
        """One step on this rank's rows of the step's global batch, then
        the gathered state's digest (collective for a sharded state)."""
        import horovod_tpu_torch as hvd
        rank, size = hvd.rank(), hvd.size()
        step = self.state.step
        tokens = np.random.default_rng(1000 + step).integers(
            0, SHARDED_MODEL["vocab_size"], (SHARDED_ROWS, SHARDED_SEQ + 1))
        rows = SHARDED_ROWS // size
        part = torch.from_numpy(tokens[rank * rows:(rank + 1) * rows])
        self.state, metrics = self.trainer.step(
            self.state, {"input": part[:, :-1], "label": part[:, 1:]})
        self.records.append({"step": self.state.step, "size": size,
                             "loss": float(metrics["loss"]).hex(),
                             "digest": self.digest(),
                             "elements": sum(p.numel() for p in
                                             self.state.model.parameters())})

    def chunks(self) -> dict:
        return {n: p.detach().numpy().copy()
                for n, p in self.state.model.named_parameters()}


def battery_grow_sharded(hvd, rank: int, size: int, outdir: str,
                         battery: str = "grow-sharded") -> None:
    """fsdp=2 -> 3 -> 2 without a restart: the incumbents train, rank 0
    starts the joiner, the incumbents wait at the boundary (so that both
    batteries change size at the same step) until it is admitted, train
    the grown world until the joiner departs on its SIGTERM, and train
    the shrunk world.  After each transition every rank re-cuts the
    whole tree of the ``WorldChange`` on the new mesh."""
    from horovod_tpu_torch import statesync
    from horovod_tpu_torch.checkpoint import train_state_tree
    run = ShardedRun(battery)
    run.build(train_state_tree(run.fresh()))
    svc = statesync.StateSyncService(run.tree, sharded=run.sharded)
    joiner = None
    for _ in range(SHARDED_BEFORE):
        run.step()
        assert svc.step_boundary() is None
    if rank == 0:
        joiner = _spawn_joiner(battery, outdir)
    deadline = time.monotonic() + 120.0
    while (change := svc.step_boundary()) is None:
        assert time.monotonic() < deadline, "the joiner was never admitted"
        time.sleep(0.05)
    assert change.kind == "grow" and hvd.size() == size + 1, change
    assert (change.tree is not None) == run.sharded
    run.build(change.tree if run.sharded else run.tree())
    entered = run.digest()
    for i in range(SHARDED_GROWN):
        run.step()
        change = svc.step_boundary()
        if i < SHARDED_GROWN - 1:
            assert change is None, change
    assert change is not None and change.kind == "shrink", change
    assert change.dead == (size,) and hvd.size() == size, change
    run.build(change.tree if run.sharded else run.tree())
    for _ in range(SHARDED_AFTER):
        run.step()
        assert svc.step_boundary() is None
    final = run.tree()
    svc.close()
    if joiner is not None:
        _reap_joiner(joiner, "sharded joiner: departed")
    np.savez(os.path.join(outdir, f"{battery}.{rank}.chunks.npz"),
             **run.chunks())
    if rank == 0:
        np.savez(os.path.join(outdir, f"{battery}.whole.npz"),
                 **{k: v.numpy() for k, v in final.items()
                    if k.startswith("params/")})
    _write(outdir, battery, rank, {"steps": run.records,
                                   "entered_digest": entered})
    print(f"launch rank {rank}: rode fsdp {size}->{size + 1}->{size} to "
          f"step {run.state.step}")


def battery_grow_plain(hvd, rank: int, size: int, outdir: str) -> None:
    """``grow-sharded`` with no rules: the bitwise reference."""
    battery_grow_sharded(hvd, rank, size, outdir, battery="grow-plain")


def _battery_sharded_joiner(outdir: str, battery: str) -> int:
    """The joiner of the sharded grow: its template is a fresh unsharded
    state's whole tree; once admitted it forms the group, builds the
    Trainer with the rules and loads the tree, trains the grown world,
    and departs on its own SIGTERM."""
    import signal

    from horovod_tpu_torch import statesync
    from horovod_tpu_torch.checkpoint import whole_tree_template
    run = ShardedRun(battery)
    tree, info = statesync.join_world(whole_tree_template(run.fresh()))
    import horovod_tpu_torch as hvd
    run.build(tree)
    entered = run.digest()
    assert entered == info.stamp.digest, (entered, info.stamp)
    svc = statesync.StateSyncService(run.tree, sharded=run.sharded)
    for i in range(SHARDED_GROWN):
        run.step()
        if i == SHARDED_GROWN - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        change = svc.step_boundary()
    assert change is not None and change.kind == "departed", change
    svc.close()
    from horovod_tpu_torch.parallel import multihost
    multihost.shutdown()
    _write(outdir, battery.replace("grow", "joiner"), "J",
           {"steps": run.records, "entered_digest": entered,
            "stamp_digest": info.stamp.digest, "rank": info.rank,
            "size": info.size})
    print(f"sharded joiner: departed after {SHARDED_GROWN} steps as rank "
          f"{info.rank}/{info.size}")
    return 0


# --- serving ----------------------------------------------------------------
def _serve_grow_submit(ex, seed: int, count: int) -> None:
    rng = random.Random(seed)
    for _ in range(count):
        toks = [rng.randrange(2, ex.model.cfg.vocab_size)
                for _ in range(rng.randint(2, 10))]
        ex.stats["offered"] += 1
        assert ex.queue.submit(toks, 10) is not None


def battery_serve(hvd, rank: int, size: int, outdir: str) -> None:
    """Serving grow mid-serve (2 -> 3): a joiner replica enters by param
    streaming while requests are in flight (the incumbents' params are
    moved off the seed's, so the stream is the only way to match them),
    then a second wave is served by the grown world."""
    from horovod_tpu_torch import statesync
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    from horovod_tpu_torch.serving.loadgen import _goodput_phases
    cfg = ServeConfig.from_env(**SERVE_GROW_CFG)
    ex = ReplicaExecutor(cfg, device="cpu")
    with torch.no_grad():
        for p in ex.model.parameters():
            p.add_(0.25)
    service = statesync.StateSyncService(state_provider=ex.state_tree,
                                         static_state=True)
    ex.attach_statesync(service)
    joiner = None
    if rank == 0:
        _serve_grow_submit(ex, 11, 24)
        joiner = _spawn_joiner("serve", outdir)
    # Phase 1: serve the first wave until the joiner has entered (the
    # front keeps assembling plans while it streams) and it drained.
    ex.serve_loop(stop_when=lambda: bool(ex.stats["grows"]))
    assert ex.stats["grows"], "the joiner never entered"
    assert ex.size == size + 1, ex.size
    assert not ex.stats["shrinks"]
    # Phase 2: a post-grow wave, served by the grown world.
    ex._stop_requested = False
    if ex.rank == ex.front:
        _serve_grow_submit(ex, 13, 12)
    ex.serve_loop(stop_when=lambda: True)
    record = {"gen": ex._gen}
    if rank == 0:
        st = ex.stats
        assert st["served"] == st["offered"] == 36, st
        assert st["lost"] == 0 and st["expired"] == 0, st
        phases = _goodput_phases(ex, 1.0)
        assert phases is not None and phases["after_rps"] > 0.0, phases
        g = st["grows"][0]
        assert g["from"] == size and g["to"] == size + 1, g
        _reap_joiner(joiner, "streamed params verified")
        record.update(served=st["served"], grows=st["grows"],
                      goodput_phases=phases)
        print(f"serving grow: {st['served']} served across "
              f"{size}->{size + 1}; goodput phases {phases}")
    service.close()
    ex.close()
    _write(outdir, "serve", rank, record)


def battery_serve_joiner(outdir: str) -> int:
    """The serving joiner: streams the incumbents' moved params, enters
    mid-serve, and serves both phases until the front drains."""
    from horovod_tpu_torch.serving import ServeConfig
    from horovod_tpu_torch.serving.replica import (join_serving_world,
                                                   serving_params_template)
    cfg = ServeConfig.from_env(**SERVE_GROW_CFG)
    ex = join_serving_world(cfg, device="cpu")
    # The streamed params are the incumbents' (the seed's plus 0.25),
    # nothing derivable locally.
    seed = serving_params_template(cfg)
    for name, t in ex.state_tree().items():
        torch.testing.assert_close(t, seed[name] + 0.25, rtol=0,
                                   atol=1e-6)
    print("serve joiner: streamed params verified (seed + 0.25)")
    import horovod_tpu_torch as hvd
    ex.serve_loop()                    # phase 1: exits on plan.stop
    ex._stop_requested = False
    ex.serve_loop()                    # phase 2
    print(f"serve joiner: entered as rank {ex.rank}/{ex.size}, served "
          f"group {ex.group}, completed {len(ex.completed)} locally")
    _write(outdir, "serve_joiner", "J", {"rank": ex.rank, "size": ex.size,
                                         "completed": len(ex.completed)})
    ex.statesync.close()
    ex.close()
    hvd.shutdown()
    return 0


def battery_disagg(hvd, rank: int, size: int, outdir: str) -> None:
    """Disaggregated prefill/decode at 2 ranks under the strict
    fingerprint: rank 1 prefills only and streams finished KV blocks to
    the rank-0 decode replica.  Every prompt is prefilled off the decode
    rank (zero local fallbacks) and everything offered is served."""
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.serving import ReplicaExecutor, ServeConfig
    ex = ReplicaExecutor(ServeConfig.from_env(**DISAGG_CFG,
                                              prefill_ranks=1),
                         device="cpu")
    assert ex.decode_size == 1 and ex.prefill_rank_list == [1]
    assert ex.is_prefill == (rank == 1)
    streams, rid_prompt = {}, {}
    collect = ex._collect_completions

    def record():
        for s in ex.slots:
            if s is not None and s.pending is None and s.remaining == 0:
                streams[s.rid] = list(s.generated)
        collect()
    ex._collect_completions = record
    if rank == 0:
        for toks in disagg_prompts(ex.model.cfg.vocab_size):
            ex.stats["offered"] += 1
            rid = ex.queue.submit(toks, DISAGG_MAX_NEW)
            assert rid is not None
            rid_prompt[rid] = toks
    ex.serve_loop(stop_when=lambda: True)
    out = {"streams": {str(k): v for k, v in streams.items()},
           "prompts": {str(k): v for k, v in rid_prompt.items()}}
    if rank == 0:
        st, kv = ex.stats, ex.kv_stats()
        assert st["served"] == DISAGG_REQUESTS, st
        assert kv["prefill_fallbacks"] == 0, kv
        assert kv["active"] == 0, kv
        assert ex.batcher.inflight == {}, ex.batcher.inflight
        out["kv"] = kv
        print(f"serving_disagg: {st['served']}/{DISAGG_REQUESTS} served "
              f"via streamed prefill, zero local fallbacks")
    else:
        assert ex.stats["prefill_streams"] == DISAGG_REQUESTS, ex.stats
        sent = telemetry.metrics().counter(
            "horovod_serve_prefill_stream_bytes_total",
            labels={"role": "sent"}).value
        assert sent > 0, "prefill rank streamed no bytes"
        out["sent_bytes"] = sent
        print(f"serving_disagg: rank 1 streamed "
              f"{ex.stats['prefill_streams']} prefills ({sent:g} payload "
              f"bytes)")
    ex.close()
    hvd.barrier()
    _write(outdir, "disagg", rank, out)


BATTERIES = {"grow": battery_grow, "preempt": battery_preempt,
             "serve": battery_serve, "disagg": battery_disagg,
             "grow-sharded": battery_grow_sharded,
             "grow-plain": battery_grow_plain}
PREINIT = {"joiner": battery_joiner, "serve_joiner": battery_serve_joiner,
           "joiner-sharded": lambda outdir: _battery_sharded_joiner(
               outdir, "grow-sharded"),
           "joiner-plain": lambda outdir: _battery_sharded_joiner(
               outdir, "grow-plain")}


def main(battery: str, rank: int, size: int, port: int,
         outdir: str) -> int:
    torch.set_num_threads(1)
    env = {**COMMON, **ENV[battery]}
    os.environ.update({k: v.format(outdir=outdir) for k, v in env.items()})
    os.environ.update(HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port))
    os.environ.setdefault("HOROVOD_RENDEZVOUS_EPOCH", f"ss{battery}")
    if battery in PREINIT:
        try:
            return PREINIT[battery](outdir)
        except BaseException:
            traceback.print_exc()
            return 1
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size))
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        assert hvd.rank() == rank and hvd.size() == size
        BATTERIES[battery](hvd, rank, size, outdir)
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  int(sys.argv[4]), sys.argv[5]))
