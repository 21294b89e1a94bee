"""The port's fault tolerance (``horovod_tpu_torch/resilience``, the poison
frame, the deadline-bounded socket waits) against the JAX package's, on
the CPU.

- Parity units run both packages on the same inputs: the chaos grammar
  (the reference's cases, the malformed ones too), the response and send
  counters and the seeded ``prob`` matcher, the ``RanksFailedError`` wire
  form and the poison frame byte for byte, ``_retry_epoch``,
  ``ResilienceState.check`` on a fake monitor, ``HeartbeatMonitor``'s
  staleness, dead and suspect marks and "bye" over each package's
  loopback KV, and ``run_with_recovery``'s raise, retry, give-up and
  confirmed-dead paths.
- The port's own: the knobs' defaults against the reference registry,
  ``shrink``'s re-raise, what still raises (``coordkill``/
  ``coordpause``), and the
  bounded waits of a two-rank ``PeerMesh`` in threads.
- Process batteries (``tests/torch_resilience_worker.py``), one world at
  a time with one compute thread a rank: a chaos SIGKILL at 4 ranks, the
  retry at 4, a freeze at 2 and the off mode at 2, asserting what the
  reference's batteries assert (the reference's own run in
  ``tests/test_resilience.py``).

Every test runs under the same hard SIGALRM guard as the reference's, so
a wait that lost its deadline fails fast.
"""
from __future__ import annotations

import os
import signal
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from horovod_tpu.common import config as jconfig
from horovod_tpu.common.exceptions import RanksFailedError as JRanksFailed
from horovod_tpu.common import tcp_transport as jtransport
from horovod_tpu.resilience import chaos as jchaos
from horovod_tpu.resilience import context as jcontext
from horovod_tpu.resilience import heartbeat as jheartbeat
from horovod_tpu.resilience import policy as jpolicy
from horovod_tpu_torch.common import config as tconfig
from horovod_tpu_torch.common import tcp_transport as ttransport
from horovod_tpu_torch.common.exceptions import RanksFailedError
from horovod_tpu_torch.resilience import chaos as tchaos
from horovod_tpu_torch.resilience import context as tcontext
from horovod_tpu_torch.resilience import heartbeat as theartbeat
from horovod_tpu_torch.resilience import policy as tpolicy
from torch_sigterm import restore_sigterm  # noqa: F401
from torch_world_lock import world_locked

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_resilience_worker.py"
HARD_GUARD_SECONDS = 300

SIDES = {"jax": (jchaos, jcontext, jheartbeat, jpolicy, JRanksFailed),
         "port": (tchaos, tcontext, theartbeat, tpolicy, RanksFailedError)}


@pytest.fixture(autouse=True)
def hard_timeout_guard():
    """A re-introduced deadlock fails this test in bounded time instead
    of stalling the run until the outer timeout."""
    def _expired(signum, frame):
        raise TimeoutError(
            f"resilience test exceeded the {HARD_GUARD_SECONDS}s hard "
            f"guard — a blocking wait has lost its deadline")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(HARD_GUARD_SECONDS)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _kv(side: str):
    if side == "jax":
        from horovod_tpu.runner.network import (RendezvousClient,
                                                RendezvousServer)
    else:
        from horovod_tpu_torch.runner.network import (RendezvousClient,
                                                      RendezvousServer)
    server = RendezvousServer()
    port = server.start()
    return server, RendezvousClient("127.0.0.1", port, 10.0)


@pytest.fixture(params=["jax", "port"])
def side_kv(request):
    server, kv = _kv(request.param)
    yield request.param, kv
    server.stop()


class FakeMonitor:
    """Deterministic monitor for ResilienceState units."""

    def __init__(self) -> None:
        self.failed: set[int] = set()
        self.confirmed: set[int] = set()
        self.marks: list[tuple[int, str, bool]] = []

    def failed_ranks(self):
        return frozenset(self.failed)

    def confirmed_failed_ranks(self):
        return frozenset(self.confirmed)

    def mark_failed(self, r, reason, confirmed=True):
        self.marks.append((r, reason, confirmed))
        self.failed.add(r)
        if confirmed:
            self.confirmed.add(r)

    def poll_once(self):
        pass

    def stop(self):
        pass


# ---------------------------------------------------------------------------
# The knobs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [
    "FAULT_TOLERANCE", "FAULT_TIMEOUT", "ON_FAILURE", "FAULT_RETRIES",
    "FAULT_BACKOFF_SECONDS", "CHAOS", "SHM_BARRIER_TIMEOUT_SECONDS"])
def test_knobs_match_the_reference(name):
    ours, ref = getattr(tconfig, name), getattr(jconfig, name)
    assert ours.name == ref.name
    assert ours.default == ref.default
    assert type(ours.default) is type(ref.default)


# ---------------------------------------------------------------------------
# Chaos grammar, counters and the seeded matcher
# ---------------------------------------------------------------------------
_FIELDS = ("kind", "rank", "op", "name", "peer", "send", "mesh", "ms",
           "exit_code", "sig", "count", "prob")


def _parsed(mod, spec):
    try:
        return [tuple(getattr(a, f) for f in _FIELDS)
                for a in mod.parse_spec(spec)]
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("spec", [
    "kill:rank=2,op=5,sig=9; freeze:rank=1,op=3,ms=4000;"
    "fail:op=7,count=2;delay:rank=1,peer=0,send=3,ms=250,count=1;"
    "drop:peer=2,send=0;dup:peer=1,send=4,mesh=data",
    "kill:rank=2,op=3,sig=9",
    "freeze:rank=1,op=1,ms=12000",
    "delay:rank=1,mesh=data,peer=2,send=0,ms=9000,count=1",
    "fail:name=grad.,count=2",
    "preempt:rank=1,op=6",
    "drop:peer=0,prob=0.5,seed=7,count=-1",
    "kill:rank=*,op=2,exit=7",
    "coordkill:at=5",
    "coordpause:at=5,ms=800,rank=1",
    " ; fail:op=1 ; ",
    # Malformed (the reference's cases).
    "nonsense:op=1", "kill:rank=2", "delay:rank=1,ms=5",
    "kill:rank2,op=3", "freeze", "fail:op",
])
def test_chaos_grammar_matches_the_reference(spec):
    assert _parsed(tchaos, spec) == _parsed(jchaos, spec)


def _drive(mod, spec, rank, script):
    eng = mod.ChaosEngine(spec, rank=rank)
    out = []
    for step in script:
        if step[0] == "resp":
            out.append(eng.on_response(step[1]))
        else:
            out.append(eng.on_send(step[1], step[2]))
    return out, [(a.count, a.fired) for a in eng.actions]


_SCRIPT = ([("resp", ["a"]), ("resp", ["grad.3", "grad.4"]),
            ("send", "data0", 1), ("send", "data0", 2),
            ("send", "ctrl0", 1), ("send", "data0", 1),
            ("resp", ["grad.5"]), ("send", "data0", 1),
            ("resp", ["loss"]), ("resp", ["grad.6"])] * 3)


@pytest.mark.parametrize("spec,rank", [
    ("fail:op=1,count=2", 3),
    ("fail:name=grad.,count=2", 0),
    ("drop:rank=0,peer=1,send=1,mesh=data", 0),
    ("dup:peer=1,send=0;drop:peer=2,send=1,mesh=data", 1),
    ("fail:op=4,rank=1;fail:op=6", 2),
    ("drop:peer=1,prob=0.5,seed=7,count=-1", 0),
    ("dup:peer=1,prob=0.3,seed=11,count=4", 0),
])
def test_chaos_counters_match_the_reference(spec, rank):
    assert _drive(tchaos, spec, rank, _SCRIPT) == \
        _drive(jchaos, spec, rank, _SCRIPT)


def test_chaos_prob_matcher_is_seed_deterministic():
    def fired(mod, seed):
        eng = mod.ChaosEngine(
            f"drop:peer=0,prob=0.5,seed={seed},count=-1", rank=0)
        return [eng.on_send("m", 0) == "drop" for _ in range(64)]
    assert fired(tchaos, 7) == fired(jchaos, 7)
    assert fired(tchaos, 7) != fired(tchaos, 8)
    assert any(fired(tchaos, 7)) and not all(fired(tchaos, 7))


@pytest.mark.parametrize("spec", ["coordkill:at=5",
                                  "coordpause:at=5,ms=800",
                                  "fail:op=1;coordkill:at=2,rank=0"])
def test_coordinator_actions_arm_as_the_reference(spec, monkeypatch):
    """An engine armed with a coordinator action fires as the
    reference's does: with no rendezvous to find a primary through, each
    coordinator action is spent and skipped at its collective, and the
    other actions fire as before (the signals themselves are
    ``tests/test_torch_controlplane.py``'s)."""
    monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", raising=False)
    assert [a.kind for a in tchaos.parse_spec(spec)] == \
        [a.kind for a in jchaos.parse_spec(spec)]
    assert _drive(tchaos, spec, 0, _SCRIPT) == \
        _drive(jchaos, spec, 0, _SCRIPT)
    assert _drive(tchaos, spec, 1, _SCRIPT) == \
        _drive(jchaos, spec, 1, _SCRIPT)
    monkeypatch.setenv("HOROVOD_CHAOS", spec)
    try:
        eng = tchaos.configure(0)
        assert [a.kind for a in eng.actions] == \
            [a.kind for a in jchaos.parse_spec(spec)]
    finally:
        monkeypatch.setenv("HOROVOD_CHAOS", "")
        tchaos.configure(0)


def test_chaos_engine_survives_reconfigure_with_same_spec(monkeypatch):
    monkeypatch.setenv("HOROVOD_CHAOS", "fail:op=0,count=1")
    eng = tchaos.configure(0)
    assert eng.on_response(["x"]) == "fail"
    assert tchaos.configure(0) is eng        # a retry's re-init
    assert eng.on_response(["x"]) is None
    monkeypatch.setenv("HOROVOD_CHAOS", "")
    assert tchaos.configure(0) is None


# ---------------------------------------------------------------------------
# RanksFailedError wire form and the poison frame
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ranks,op,phase,message", [
    ({3, 1}, "allreduce(grad.0…)", "recv", "rank 3 went away"),
    ({2}, "broadcast(serve.plan.g0.7.data)", "shm_barrier", ""),
    (set(), "", "", "bare"),
    ({0, 5, 11}, "allgather(serve.done.g0.3.size)", "gather", ""),
])
def test_ranks_failed_wire_and_poison_frame_match(ranks, op, phase,
                                                  message):
    ours = RanksFailedError(ranks, op=op, phase=phase, message=message)
    ref = JRanksFailed(ranks, op=op, phase=phase, message=message)
    assert ours.to_wire() == ref.to_wire()
    assert RanksFailedError.matches(ours.to_wire())
    back = RanksFailedError.from_wire(ref.to_wire())
    jback = JRanksFailed.from_wire(ours.to_wire())
    assert (back.failed_ranks, back.op, back.phase, str(back)) == \
        (jback.failed_ranks, jback.op, jback.phase, str(jback))
    assert ttransport.POISON_MAGIC == jtransport.POISON_MAGIC
    frame = ttransport.POISON_MAGIC + ours.to_wire().encode()
    assert frame == jtransport.POISON_MAGIC + ref.to_wire().encode()
    for check, exc in ((ttransport.check_poison, RanksFailedError),
                       (jtransport.check_poison, JRanksFailed)):
        with pytest.raises(exc) as info:
            check(frame)
        assert info.value.failed_ranks == frozenset(ranks)
        assert info.value.op == op
        check(b"\x00\x00\x00\x02ok")          # ordinary frames pass
        check(bytearray(b"\x01plain"))


def test_status_reraises_ranks_failed():
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.common.status import Status
    status = Status.unknown_error(RanksFailedError({2}, op="bc",
                                                   phase="send").to_wire())
    with pytest.raises(RanksFailedError) as info:
        status.raise_if_error()
    assert info.value.failed_ranks == frozenset({2})
    assert isinstance(info.value, HorovodInternalError)
    assert isinstance(info.value, ConnectionError)


# ---------------------------------------------------------------------------
# ResilienceState, op and deadline scopes, the retry epoch
# ---------------------------------------------------------------------------
def _check_outcome(side, fault_timeout, marks, peer, waited, phase,
                   op=None, deadline=None):
    _, context, _, _, exc_type = SIDES[side]
    fake = FakeMonitor()
    for r, confirmed in marks:
        fake.mark_failed(r, "x", confirmed=confirmed)
    fake.marks.clear()
    st = context.ResilienceState(0, 4, fake, fault_timeout=fault_timeout)
    try:
        if op is None:
            st.check(peer, waited=waited, phase=phase)
        else:
            with context.op_scope(op, deadline=deadline):
                st.check(peer, waited=waited, phase=phase)
    except exc_type as e:
        return ("raised", sorted(e.failed_ranks), e.op, e.phase, e.detail,
                [(r, c) for r, _, c in fake.marks], st.poll_interval)
    return ("quiet", [(r, c) for r, _, c in fake.marks], st.poll_interval)


@pytest.mark.parametrize("case", [
    dict(fault_timeout=1.0, marks=[], peer=3, waited=0.1, phase="recv"),
    dict(fault_timeout=1.0, marks=[(2, True)], peer=3, waited=0.1,
         phase="recv"),
    dict(fault_timeout=0.5, marks=[], peer=3, waited=0.6, phase="send"),
    dict(fault_timeout=0.1, marks=[], peer=1, waited=1.0, phase="recv",
         op="allreduce(x)"),
    dict(fault_timeout=30.0, marks=[(1, False)], peer=2, waited=0.2,
         phase="gather", op="allgather(y)"),
    dict(fault_timeout=30.0, marks=[], peer=1, waited=0.6, phase="recv",
         op="broadcast(serve.plan.g0.1.data)", deadline=0.0),
])
def test_state_check_matches_the_reference(case):
    assert _check_outcome("port", **case) == _check_outcome("jax", **case)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_op_timeout_tightens_to_the_request_deadline(side):
    _, context, _, _, _ = SIDES[side]
    st = context.ResilienceState(0, 2, FakeMonitor(), fault_timeout=30.0)
    assert st.op_timeout() == 30.0
    with context.op_scope("x", deadline=time.monotonic() + 5.0):
        assert 4.0 < st.op_timeout() <= 5.0
    with context.op_scope("x", deadline=time.monotonic() - 5.0):
        assert st.op_timeout() == 2.0 * st.poll_interval
    assert context.current_op() == "" and context.pending_deadline() is None
    with context.deadline_scope(123.0):
        assert context.pending_deadline() == 123.0
        with context.deadline_scope(None):
            assert context.pending_deadline() is None
        assert context.pending_deadline() == 123.0
    assert context.pending_deadline() is None


@pytest.mark.parametrize("base,attempt", [
    ("abc", 1), ("abc~r1", 2), ("abc~r2", 3), ("0", 1), ("x~ry~r4", 5),
    ("retry4", 1)])
def test_retry_epoch_matches_the_reference(base, attempt):
    assert tpolicy._retry_epoch(base, attempt) == \
        jpolicy._retry_epoch(base, attempt)


def test_configure_off_and_at_one_rank(monkeypatch):
    server, kv = _kv("port")
    try:
        monkeypatch.delenv("HOROVOD_FAULT_TOLERANCE", raising=False)
        assert tcontext.configure(0, 4, kv, "e") is None
        monkeypatch.setenv("HOROVOD_FAULT_TOLERANCE", "1")
        assert tcontext.configure(0, 1, kv, "e") is None
        assert tcontext.configure(0, 4, None, "e") is None
        st = tcontext.configure(0, 2, kv, "e")
        try:
            assert st is tcontext.active_state()
            assert any(t.name == "hvd-heartbeat"
                       for t in threading.enumerate())
        finally:
            tcontext.shutdown()
        assert tcontext.active_state() is None
        time.sleep(0.05)
        assert not any(t.name == "hvd-heartbeat"
                       for t in threading.enumerate())
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# HeartbeatMonitor over each package's loopback KV
# ---------------------------------------------------------------------------
def _monitors(side, kv, size, epoch, **kw):
    hb = SIDES[side][2]
    return [hb.HeartbeatMonitor(r, size, kv, epoch, **kw)
            for r in range(size)]


def test_heartbeat_staleness_declares_failure(side_kv):
    side, kv = side_kv
    a, b = _monitors(side, kv, 2, "hb-t1", fault_timeout=0.4,
                     interval=0.1)
    a._publish()
    b._publish()
    a._started_at = b._started_at = time.monotonic()
    a.poll_once()
    assert a.failed_ranks() == frozenset()
    time.sleep(0.6)               # b stops beating
    a.poll_once()
    assert a.failed_ranks() == frozenset({1})
    assert a.confirmed_failed_ranks() == frozenset({1})
    assert "silent" in a.failure_reason(1)


def test_heartbeat_progress_prevents_failure(side_kv):
    side, kv = side_kv
    a, b = _monitors(side, kv, 2, "hb-t2", fault_timeout=0.4,
                     interval=0.1)
    a._started_at = time.monotonic() - 10.0   # grace long over
    deadline = time.monotonic() + 0.9
    while time.monotonic() < deadline:
        b._publish()
        a.poll_once()
        time.sleep(0.1)
    assert a.failed_ranks() == frozenset()


def test_dead_and_suspect_marks_propagate(side_kv):
    side, kv = side_kv
    a, b, _ = _monitors(side, kv, 3, "hb-t3", fault_timeout=30.0,
                        interval=0.1)
    for m in (a, b):
        m._publish()
    a.mark_failed(2, "deadline expiry", confirmed=False)
    b.poll_once()
    assert b.failed_ranks() == frozenset({2})
    assert b.confirmed_failed_ranks() == frozenset()
    # Later confirmed evidence upgrades the suspect.
    a.mark_failed(2, "pid gone", confirmed=True)
    b.poll_once()
    assert b.confirmed_failed_ranks() == frozenset({2})
    assert kv.get("dead", "hb-t3:2").decode().startswith("confirmed|by 0")


def test_orderly_departure_bye_is_not_death(side_kv):
    side, kv = side_kv
    a, b = _monitors(side, kv, 2, "hb-bye", fault_timeout=0.3,
                     interval=0.05)
    for m in (a, b):
        m._publish()
    a._started_at = time.monotonic() - 10.0
    a.poll_once()
    b.stop()   # publishes the bye stamp
    time.sleep(0.5)
    a.poll_once()
    assert a.failed_ranks() == frozenset()
    assert "bye|" in (kv.get("hb", "hb-bye:1") or b"").decode()


def test_kv_outage_pauses_the_staleness_clock(side_kv):
    side, kv = side_kv
    a, b = _monitors(side, kv, 2, "hb-kv", fault_timeout=0.3,
                     interval=0.05)
    b._publish()
    a._started_at = time.monotonic() - 10.0
    a.poll_once()

    class Down:
        def get(self, *args):
            raise OSError("KV unreachable")

        def put(self, *args):
            raise OSError("KV unreachable")

    a.kv = Down()
    time.sleep(0.5)
    a.poll_once()                 # outage: the window restarts
    assert a._kv_outage and a.failed_ranks() == frozenset()
    a.kv = kv
    a.poll_once()                 # back: b's value unchanged, clock fresh
    assert not a._kv_outage and a.failed_ranks() == frozenset()


# ---------------------------------------------------------------------------
# run_with_recovery
# ---------------------------------------------------------------------------
@pytest.fixture(params=["jax", "port"])
def policy_side(request):
    return request.param, SIDES[request.param][3], SIDES[request.param][4]


def test_recovery_raise_propagates(policy_side):
    _, pol, exc_type = policy_side
    calls = []

    def fn():
        calls.append(1)
        raise exc_type({1})

    with pytest.raises(exc_type):
        pol.run_with_recovery(fn, policy="raise")
    assert len(calls) == 1 and pol.last_attempts == 1
    with pytest.raises(ValueError):
        pol.run_with_recovery(lambda: None, policy="panic")


def test_recovery_retries_with_backoff(policy_side, monkeypatch):
    _, pol, exc_type = policy_side
    rebuilds, attempts = [], []
    monkeypatch.setattr(pol, "rebuild_world",
                        lambda attempt: rebuilds.append(attempt))

    def fn():
        attempts.append(1)
        if len(attempts) < 3:
            raise exc_type({1}, op="ar", phase="recv")
        return "ok"

    t0 = time.monotonic()
    assert pol.run_with_recovery(fn, policy="retry", max_retries=5,
                                 base_backoff=0.05) == "ok"
    assert rebuilds == [1, 2] and pol.last_attempts == 3
    assert time.monotonic() - t0 >= 0.05 + 0.10   # 0.05, then 0.10


def test_recovery_gives_up_after_max_retries(policy_side, monkeypatch):
    _, pol, exc_type = policy_side
    monkeypatch.setattr(pol, "rebuild_world", lambda attempt: None)

    def fn():
        raise exc_type({1})

    with pytest.raises(exc_type):
        pol.run_with_recovery(fn, policy="retry", max_retries=2,
                              base_backoff=0.01)
    assert pol.last_attempts == 3   # initial + 2 retries


def test_recovery_refuses_confirmed_dead(policy_side, monkeypatch):
    side, pol, exc_type = policy_side
    context = SIDES[side][1]
    fake = FakeMonitor()
    fake.mark_failed(2, "pid gone", confirmed=True)
    monkeypatch.setattr(context, "_state", context.ResilienceState(
        0, 4, fake, fault_timeout=1.0))
    monkeypatch.setattr(pol, "rebuild_world",
                        lambda attempt: pytest.fail("must not rebuild"))

    def fn():
        raise exc_type({2})

    with pytest.raises(exc_type):
        pol.run_with_recovery(fn, policy="retry", max_retries=5,
                              base_backoff=0.01)
    # The confirmed set converges at once; a suspect alone re-raises.
    assert pol.converge_confirmed_dead(exc_type({2})) == frozenset({2})


def test_shrink_policy_names_its_item():
    """``shrink`` is ported (it was refused naming ROADMAP item 11): as
    in the reference, it runs ``fn`` and re-raises a failure for the
    surrounding ``hvd.elastic.run``, and never rebuilds the world."""
    assert tpolicy.run_with_recovery(lambda: 5, policy="shrink") == 5
    for pol, exc_type in ((jpolicy, JRanksFailed),
                          (tpolicy, RanksFailedError)):
        calls = []

        def fn():
            calls.append(1)
            raise exc_type({2})

        with pytest.raises(exc_type) as info:
            pol.run_with_recovery(fn, policy="shrink", max_retries=5,
                                  base_backoff=0.01)
        assert info.value.failed_ranks == frozenset({2})
        assert calls == [1] and pol.last_attempts == 1


# ---------------------------------------------------------------------------
# Deadline-bounded PeerMesh waits (two ranks in threads)
# ---------------------------------------------------------------------------
def _state(rank, fault_timeout):
    return tcontext.ResilienceState(rank, 2, FakeMonitor(),
                                    fault_timeout=fault_timeout)


def _mesh_pair(kv, scope, states):
    from horovod_tpu_torch.runner.network import PeerMesh
    meshes: list = [None, None]
    errs: list = []

    def form(r):
        try:
            meshes[r] = PeerMesh(r, 2, kv, scope=scope, timeout=10.0,
                                 resilience=states[r])
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=form, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20.0)
    assert not errs, errs
    return meshes


@pytest.fixture
def port_kv():
    server, kv = _kv("port")
    yield kv
    server.stop()


def test_recv_deadline_raises_ranks_failed(port_kv):
    states = [_state(r, 0.8) for r in range(2)]
    m0, m1 = _mesh_pair(port_kv, "dl1", states)
    try:
        t0 = time.monotonic()
        with pytest.raises(RanksFailedError) as info:
            m0.recv(1)   # rank 1 never sends
        elapsed = time.monotonic() - t0
        assert info.value.failed_ranks == frozenset({1})
        assert info.value.phase == "recv"
        assert 0.5 < elapsed < 5.0, elapsed
        assert states[0].monitor.marks[-1][2] is False   # suspect
        assert m0._channels[1].sock.gettimeout() == states[0].poll_interval
    finally:
        for m in (m0, m1):
            m.close()


def test_closed_socket_is_a_suspect_failure(port_kv):
    states = [_state(r, 5.0) for r in range(2)]
    m0, m1 = _mesh_pair(port_kv, "dl2", states)
    try:
        m1.close()
        with pytest.raises(RanksFailedError) as info:
            m0.recv(1)
        assert 1 in info.value.failed_ranks
        assert states[0].monitor.failed == {1}
        assert states[0].monitor.confirmed == set()
    finally:
        m0.close()


def test_monitor_verdict_converts_a_blocked_drain(port_kv):
    states = [_state(r, 30.0) for r in range(2)]
    m0, m1 = _mesh_pair(port_kv, "dl3", states)
    try:
        def declare():
            time.sleep(0.3)
            states[0].monitor.failed.add(1)
        threading.Thread(target=declare, daemon=True).start()
        t0 = time.monotonic()
        with pytest.raises(RanksFailedError) as info:
            list(m0.recv_in_arrival_order([1]))
        assert info.value.phase == "gather"
        assert time.monotonic() - t0 < 5.0
    finally:
        for m in (m0, m1):
            m.close()


def test_progress_resets_the_recv_deadline(port_kv):
    """The deadline bounds SILENCE, not transfer time."""
    states = [_state(r, 0.6) for r in range(2)]
    m0, m1 = _mesh_pair(port_kv, "dl4", states)
    try:
        payload = bytes(range(64))

        def trickle():
            raw = struct.pack(">I", len(payload)) + payload
            for i in range(0, len(raw), 8):
                m1._socks[0].sendall(raw[i:i + 8])
                time.sleep(0.2)
        th = threading.Thread(target=trickle, daemon=True)
        th.start()
        assert bytes(m0.recv(1)) == payload
        th.join(10.0)
    finally:
        for m in (m0, m1):
            m.close()


@pytest.mark.parametrize("kind", ["drop", "dup"])
def test_chaos_send_actions(port_kv, monkeypatch, kind):
    monkeypatch.setenv("HOROVOD_CHAOS", f"{kind}:rank=1,peer=0,send=0,"
                                        f"mesh=cd{kind},count=1")
    tchaos.configure(1)
    try:
        states = [_state(r, 0.7) for r in range(2)]
        m0, m1 = _mesh_pair(port_kv, f"cd{kind}", states)
        try:
            m1.send(0, b"first")
            if kind == "drop":
                with pytest.raises(RanksFailedError):
                    m0.recv(1)
            else:
                assert bytes(m0.recv(1)) == b"first"
                assert bytes(m0.recv(1)) == b"first"   # the duplicate
            m1.send(0, b"second")                  # count exhausted
            assert bytes(m0.recv(1)) == b"second"
        finally:
            for m in (m0, m1):
                m.close()
    finally:
        monkeypatch.setenv("HOROVOD_CHAOS", "")
        tchaos.configure(1)


# ---------------------------------------------------------------------------
# Process batteries, one world at a time
# ---------------------------------------------------------------------------
@world_locked("size")
def _run_world(battery: str, size: int, tmp_path, expected_rcs=None,
               timeout: float = 120.0) -> list[str]:
    from horovod_tpu_torch.runner.network import RendezvousServer
    server = RendezvousServer()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), battery, str(r), str(size),
         str(port), str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(size)]
    outputs, failed = [], []
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failed.append((r, "timeout"))
            outputs.append(f"--- rank {r} (rc={p.returncode}) ---\n{out}")
            if p.returncode != (expected_rcs or {}).get(r, 0):
                failed.append((r, p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    assert not failed, f"worker failures: {failed}\n" + "\n".join(outputs)
    return outputs


def test_chaos_sigkill_converts_deadlock_4rank(tmp_path):
    """A chaos SIGKILL of rank 2 at collective 3: every survivor raises
    RanksFailedError naming rank 2 within 2x the fault timeout, and its
    flight dump's tail names the in-flight op (asserted in-battery)."""
    outputs = _run_world("kill", 4, tmp_path,
                         expected_rcs={2: -signal.SIGKILL})
    for r in (0, 1, 3):
        assert f"survivor {r}: RanksFailedError(" in outputs[r], outputs[r]


def test_retry_policy_recovers_over_rebuilt_channels_4rank(tmp_path):
    outputs = _run_world("retry", 4, tmp_path)
    assert all("retry converged after" in o for o in outputs), outputs


def test_frozen_rank_detected_by_deadline_2rank(tmp_path):
    outputs = _run_world("freeze", 2, tmp_path)
    assert "wedged peer converted" in outputs[0], outputs[0]


def test_off_mode_zero_overhead_2rank(tmp_path):
    outputs = _run_world("off", 2, tmp_path)
    assert all("off mode clean" in o for o in outputs), outputs
