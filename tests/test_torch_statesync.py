"""Elastic membership of the port against the JAX package, on the CPU.

- The wire: ``tcp_transport``'s state frames and ``kvstream``'s KV frames
  of the port are bitwise the reference's for the same kind, meta and
  payload; ``Snapshot`` images, stamps and digests of one tree are equal
  in both packages (a numpy tree, and gpt_tiny's serving tree against
  the reference's ``{"params": ...}``).
- The units: the reference's ``TestStreaming`` cases on the port's
  ``PeerMesh`` (a bulk round bit-identical, a fresh second round, resume
  across a donor's death, a torn round refused, a corrupt image refused,
  the guard bounding waits), ``TestAutoscale`` with the decision
  sequences of both packages equal for the same observations,
  ``TestHttpSource``, ``TestBlacklistReadmission``, ``TestDonation``, the
  chaos ``preempt`` action, and the Trainer-state tree
  (``checkpoint.train_state_tree``/``load_train_state``).
- The batteries (``tests/torch_statesync_worker.py``): the grow, 3 -> 2
  -> 3 at ``n = 1 << 18`` (a chaos SIGKILL, the failure shrink, a joiner
  by peer streaming), and the preemption grace at 3 ranks, each with the
  reference's in-battery outcomes and its membership flight events in
  order.

Every test runs under a hard SIGALRM guard: a membership deadlock must
fail fast.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu.common import tcp_transport as j_tcp
from horovod_tpu.serving import kvstream as j_kvstream
from horovod_tpu.statesync import autoscale as j_autoscale
from horovod_tpu.statesync import snapshot as j_snapshot
from horovod_tpu_torch.common import tcp_transport as t_tcp
from horovod_tpu_torch.runner.network import (RendezvousClient,
                                              RendezvousServer)
from horovod_tpu_torch.serving import kvstream as t_kvstream
from horovod_tpu_torch.statesync import (AutoscaleController,
                                         AutoscalePolicy, DonorServer,
                                         JoinerPuller, Snapshot,
                                         SnapshotStamp, StreamError,
                                         TornSnapshotError, flatten_state,
                                         state_digest, unflatten_state)
from horovod_tpu_torch.statesync import autoscale as t_autoscale
from horovod_tpu_torch.statesync.stream import StreamGuard
from torch_sigterm import restore_sigterm  # noqa: F401
from torch_statesync_worker import JOINERS
from torch_world_lock import world_lock

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_statesync_worker.py"
HARD_GUARD_SECONDS = 420
MEMBERSHIP_KINDS = ("shrink", "donate", "grow", "join-announce",
                    "join-ready", "join-entered", "sigterm-grace",
                    "departed", "shrink-proactive")


@pytest.fixture(autouse=True)
def hard_timeout_guard():
    """A re-introduced membership deadlock must fail fast, not eat the
    tier-1 budget."""
    def _expired(signum, frame):
        raise TimeoutError(
            f"statesync test exceeded the {HARD_GUARD_SECONDS}s hard "
            f"guard — a blocking wait has lost its deadline")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(HARD_GUARD_SECONDS)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# The wire, bitwise against the reference
# ---------------------------------------------------------------------------
FRAMES = [
    (1, {"round": 0}, b""),
    (2, {"epoch": "e~g1", "step": 42, "digest": 0xdeadbeefcafe,
         "nbytes": 1 << 20, "round": 1, "donor": 2}, b""),
    (3, {"o": 0, "n": 65536}, b""),
    (4, {"o": 8, "n": 3, "crc": 5}, b"pay"),
    (5, {"o": 8, "n": 3}, b""),
    (6, {}, b""),
    (4, {"o": 1 << 33, "n": 5, "crc": 1 << 31}, bytes(range(256)) * 9),
]


@pytest.mark.parametrize("kind,meta,payload", FRAMES,
                         ids=[f"kind{k}-{i}" for i, (k, _, _)
                              in enumerate(FRAMES)])
def test_state_frames_bitwise_reference(kind, meta, payload):
    raw = t_tcp.pack_state_frame(kind, meta, payload)
    assert raw == j_tcp.pack_state_frame(kind, meta, payload)
    got = t_tcp.unpack_state_frame(raw)
    want = j_tcp.unpack_state_frame(raw)
    assert (got[0], got[1], bytes(got[2])) == \
        (want[0], want[1], bytes(want[2])) == (kind, meta, payload)


def test_state_frame_constants_match_reference():
    names = ["STATE_MAGIC", "STATE_HELLO", "STATE_META", "STATE_REQ",
             "STATE_DATA", "STATE_END", "STATE_BYE"]
    assert [getattr(t_tcp, n) for n in names] == \
        [getattr(j_tcp, n) for n in names]
    with pytest.raises(ValueError, match="bad magic"):
        t_tcp.unpack_state_frame(b"\x00\x01\x02 not a state frame")


KV_FRAMES = [
    (1, {"rid": 3, "o": 0, "n": 4, "crc": 77, "total": 4},
     b"\x01\x02\x03\x04"),
    (2, {"rid": 3, "total": 4, "first": 9, "plen": 30, "cursor": 30,
         "shape": [4, 1, 8, 4, 16], "dtype": "float32"}, b""),
    (1, {"rid": 1 << 40, "o": 1 << 20, "n": 7, "crc": 0, "total": 1 << 21},
     b"\xff" * 7),
]


@pytest.mark.parametrize("kind,meta,payload", KV_FRAMES,
                         ids=["data", "done", "big-offsets"])
def test_kv_frames_bitwise_reference(kind, meta, payload):
    raw = t_kvstream.pack_kv_frame(kind, meta, payload)
    assert raw == j_kvstream.pack_kv_frame(kind, meta, payload)
    got = t_kvstream.unpack_kv_frame(raw)
    want = j_kvstream.unpack_kv_frame(raw)
    assert (got[0], got[1], bytes(got[2])) == \
        (want[0], want[1], bytes(want[2]))
    assert t_kvstream.kvstream_scope("e~sv1", 2) == \
        j_kvstream.kvstream_scope("e~sv1", 2)
    with pytest.raises(ValueError, match="non-KVS frame"):
        t_kvstream.unpack_kv_frame(b"\x00 not a kv frame")


# ---------------------------------------------------------------------------
# Snapshot images, stamps and digests
# ---------------------------------------------------------------------------
def _tree(n=64, seed=3):
    rng = np.random.default_rng(seed)
    return {"params": rng.standard_normal(n).astype(np.float32),
            "opt": rng.standard_normal(n).astype(np.float32),
            "step": np.int64(17)}


@pytest.mark.parametrize("n", [64, 100000])
def test_snapshot_matches_reference(n):
    tree = _tree(n=n)
    # The reference flattens a dict in sorted key order (jax's tree
    # order); the port takes the mapping's own order.
    port = Snapshot(dict(sorted(tree.items())), "ep~g1", 5)
    ref = j_snapshot.Snapshot(tree, "ep~g1", 5)
    assert bytes(port.data) == bytes(ref.data)
    assert port.stamp.as_meta() == ref.stamp.as_meta()
    assert state_digest(port.data) == j_snapshot.state_digest(ref.data)


def test_serving_tree_digest_matches_reference():
    """gpt_tiny's serving state: the port's ``state_tree`` (flax leaf
    order, flax layouts) flattens to the reference's ``{"params":
    ...}`` image of the same weights, byte for byte."""
    from horovod_tpu_torch import TransformerLM, convert
    from horovod_tpu_torch.serving import ServeConfig
    from horovod_tpu_torch.serving.replica import (_params_tree,
                                                   _serving_model_cfg,
                                                   serving_params_template)
    cfg = ServeConfig(max_seq=64)
    model = TransformerLM(_serving_model_cfg(cfg), device="cpu",
                          seed=cfg.seed)
    tree = _params_tree(model)
    template = serving_params_template(cfg)
    assert list(template) == list(tree)
    assert all(torch.equal(template[k], tree[k]) for k in tree)
    flax = convert.params_to_flax(model.state_dict(), model.cfg)
    port = Snapshot(tree, "e", 3)
    ref = j_snapshot.Snapshot({"params": flax}, "e", 3)
    assert port.stamp == SnapshotStamp.from_meta(ref.stamp.as_meta())
    assert bytes(port.data) == bytes(ref.data)


class TestSnapshot:
    def test_flatten_unflatten_roundtrip(self):
        tree = _tree()
        out = unflatten_state(flatten_state(tree), tree)
        for k in tree:
            np.testing.assert_array_equal(out[k].numpy(), tree[k])

    def test_snapshot_is_a_copy(self):
        tree = {k: torch.from_numpy(np.array(v)) for k, v in _tree().items()}
        snap = Snapshot(tree, "e", 1)
        before = bytes(snap.data)
        tree["params"] += 1.0
        assert bytes(snap.data) == before

    def test_digest_changes_on_any_flip(self):
        buf = flatten_state(_tree(n=100000))
        d = state_digest(buf)
        for pos in (0, 70000, len(buf) - 1):
            tampered = bytearray(buf)
            tampered[pos] ^= 1
            assert state_digest(tampered) != d

    def test_unflatten_rejects_size_mismatch(self):
        tree = _tree()
        with pytest.raises(ValueError, match="does not match"):
            unflatten_state(flatten_state(tree)[:-4], tree)

    def test_stamp_meta_roundtrip(self):
        s = SnapshotStamp("ep~g1", 42, 0xdeadbeef, 1024)
        assert SnapshotStamp.from_meta(s.as_meta()) == s


# ---------------------------------------------------------------------------
# The Trainer's state as a tree
# ---------------------------------------------------------------------------
def _train_state(seed: int, steps: int):
    from horovod_tpu_torch import TransformerLM, gpt_tiny
    from horovod_tpu_torch.training import TrainState, cross_entropy_loss
    model = TransformerLM(gpt_tiny(dtype=torch.float32), device="cpu",
                          seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    state = TrainState(step=0, model=model, optimizer=opt)
    gen = torch.Generator().manual_seed(11)
    x = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=gen)
    for _ in range(steps):
        cross_entropy_loss(model(x, train=True), x).backward()
        opt.step()
        opt.zero_grad()
        state.step += 1
    return state, x


def test_train_state_tree_round_trip_through_a_snapshot():
    """A fresh state's tree has the stepped one's leaves (the optimizer's
    first-step state in place of what it has not created yet); a
    snapshot pulled into it reproduces the digest, and one more step on
    both keeps them bitwise equal."""
    from horovod_tpu_torch.checkpoint import (load_train_state,
                                              train_state_tree)
    from horovod_tpu_torch.training import cross_entropy_loss
    donor, x = _train_state(0, 2)
    fresh, _ = _train_state(1, 0)
    want, got = train_state_tree(donor), train_state_tree(fresh)
    assert list(want) == list(got)
    assert [(t.shape, t.dtype) for t in want.values()] == \
        [(t.shape, t.dtype) for t in got.values()]
    assert want["step"].item() == 2 and got["step"].item() == 0
    snap = Snapshot(want, "e", 2)
    load_train_state(unflatten_state(snap.data, got), fresh)
    assert fresh.step == 2
    assert state_digest(flatten_state(train_state_tree(fresh))) == \
        snap.stamp.digest
    for st in (donor, fresh):
        cross_entropy_loss(st.model(x, train=True), x).backward()
        st.optimizer.step()
        st.optimizer.zero_grad()
    assert flatten_state(train_state_tree(donor)) == \
        flatten_state(train_state_tree(fresh))


def test_load_train_state_refuses_another_model():
    from horovod_tpu_torch import TransformerLM, gpt_tiny
    from horovod_tpu_torch.checkpoint import (load_train_state,
                                              train_state_tree)
    from horovod_tpu_torch.training import TrainState
    donor, _ = _train_state(0, 1)
    other = TransformerLM(gpt_tiny(dtype=torch.float32, num_layers=1),
                          device="cpu", seed=0)
    target = TrainState(step=0, model=other,
                        optimizer=torch.optim.AdamW(other.parameters()))
    with pytest.raises(ValueError, match="leaves"):
        load_train_state(train_state_tree(donor), target)


# ---------------------------------------------------------------------------
# Streaming over the port's PeerMesh (in-process donors)
# ---------------------------------------------------------------------------
@pytest.fixture()
def kv_server():
    srv = RendezvousServer()
    port = srv.start()
    yield RendezvousClient("127.0.0.1", port, 20.0)
    srv.stop()


def _spawn_donors(kv, scope, snap, num_donors, donor_cls=DonorServer,
                  dying=()):
    donors = []
    for r in range(num_donors):
        cls = donor_cls if r in dying else DonorServer
        d = cls(kv, scope, r, num_donors, chunk_bytes=32768, timeout=15.0)
        d.offer_snapshot(0, snap)
        d.start()
        donors.append(d)
    return donors


class TestStreaming:
    def test_bulk_round_bit_identical(self, kv_server):
        snap = Snapshot(_tree(n=200000), "e0", 5)
        donors = _spawn_donors(kv_server, "sssync.u.0", snap, 3)
        p = JoinerPuller(kv_server, "sssync.u.0", 3, timeout=15.0)
        p.connect()
        image, stamp = p.pull_round(0)
        assert bytes(image) == bytes(snap.data)
        assert stamp == snap.stamp
        # Every donor served a DISJOINT shard (bytes sum to the image).
        assert sum(b for b, _ in p.donor_stats.values()) == len(image)
        p.close()
        for d in donors:
            d.join(10.0)
            assert d.error is None

    def test_second_round_streams_fresh_snapshot(self, kv_server):
        tree = _tree(n=50000)
        snap0 = Snapshot(tree, "e0", 5)
        donors = _spawn_donors(kv_server, "sssync.u.1", snap0, 2)
        p = JoinerPuller(kv_server, "sssync.u.1", 2, timeout=15.0)
        p.connect()
        img0, _ = p.pull_round(0)
        tree["params"] *= 2.0
        snap1 = Snapshot(tree, "e0", 9)
        for d in donors:
            d.offer_snapshot(1, snap1)
        img1, st1 = p.pull_round(1)
        assert bytes(img1) == bytes(snap1.data) != bytes(img0)
        assert st1.step == 9
        p.close()

    def test_resume_across_donor_death(self, kv_server):
        """A donor dying mid-range reassigns its unfinished tail to the
        survivors; the assembled image still digest-verifies."""
        class DyingDonor(DonorServer):
            def _serve_range(self, mesh, joiner, snap, offset, length,
                             counter):
                import zlib
                view = memoryview(snap.data)
                n = min(self.chunk_bytes, length)
                chunk = view[offset:offset + n]
                mesh.send(joiner, t_tcp.pack_state_frame(
                    t_tcp.STATE_DATA,
                    {"o": offset, "n": n, "crc": zlib.crc32(chunk)},
                    chunk))
                raise StreamError("unit-test chaos: donor dies")

        snap = Snapshot(_tree(n=300000), "e0", 5)
        _spawn_donors(kv_server, "sssync.u.2", snap, 3,
                      donor_cls=DyingDonor, dying={1})
        p = JoinerPuller(kv_server, "sssync.u.2", 3, timeout=10.0)
        p.connect()
        image, _ = p.pull_round(0)
        assert bytes(image) == bytes(snap.data)
        assert 1 in p._dead
        p.close()

    def test_torn_snapshot_rejected(self, kv_server):
        """Donors stamped at different steps: the round is rejected
        before a single byte is interpreted."""
        t = _tree(n=4096)
        snap_a = Snapshot(t, "e0", 5)
        t["params"] += 1.0
        snap_b = Snapshot(t, "e0", 6)
        d0 = DonorServer(kv_server, "sssync.u.3", 0, 2, chunk_bytes=1024,
                         timeout=10.0)
        d1 = DonorServer(kv_server, "sssync.u.3", 1, 2, chunk_bytes=1024,
                         timeout=10.0)
        d0.offer_snapshot(0, snap_a)
        d1.offer_snapshot(0, snap_b)
        d0.start()
        d1.start()
        p = JoinerPuller(kv_server, "sssync.u.3", 2, timeout=10.0)
        p.connect()
        with pytest.raises(TornSnapshotError, match="torn snapshot"):
            p.pull_round(0)
        p.close()

    def test_verify_round_rejects_corrupt_image(self):
        snap = Snapshot(_tree(), "e0", 5)
        image = bytearray(snap.data)
        image[3] ^= 0xff
        with pytest.raises(TornSnapshotError, match="stale or corrupt"):
            JoinerPuller.verify_round(image, snap.stamp)

    def test_stream_guard_bounds_waits(self):
        guard = StreamGuard(0.2)
        guard.check(0, 0.1, "recv")   # under the deadline: no raise
        with pytest.raises(StreamError, match="no bytes"):
            guard.check(0, 0.3, "recv")


# ---------------------------------------------------------------------------
# Autoscale policy and controller
# ---------------------------------------------------------------------------
def _policy(side, **kw):
    kw.setdefault("up_shed_rate", 0.05)
    kw.setdefault("up_queue_fraction", 0.5)
    kw.setdefault("down_lag_ms", 50.0)
    kw.setdefault("hysteresis_rounds", 3)
    kw.setdefault("queue_depth_limit", 100)
    return side.AutoscalePolicy(2, 8, **kw)


# Observation scripts: (current size, queue depth, shed rate, lag ms).
SCRIPTS = {
    "sustained-overload": dict(obs=[(4, 0, 0.5, 0)] * 8),
    "burst-broken": dict(obs=[(4, 0, 0.5, 0), (4, 0, 0.0, 0)]
                         + [(4, 0, 0.5, 0)] * 4),
    "cooldown": dict(hysteresis_rounds=1,
                     obs=[(4, 0, 0.5, 0), (5, 0, 0.9, 0), (5, 0, 0.9, 0)]),
    "idle-straggler": dict(hysteresis_rounds=2, obs=[(4, 0, 0, 80)] * 6),
    "straggler-under-load": dict(hysteresis_rounds=1,
                                 obs=[(4, 0, 0.2, 80)] * 3),
    "bounds": dict(hysteresis_rounds=1,
                   obs=[(8, 0, 0.9, 0), (2, 0, 0, 99), (8, 90, 0, 0)]),
    "queue-depth": dict(obs=[(3, 60, 0, 0)] * 4 + [(4, 10, 0, 70)] * 6),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_autoscale_decisions_match_reference(script):
    spec = dict(SCRIPTS[script])
    obs = spec.pop("obs")
    sides = []
    for side in (j_autoscale, t_autoscale):
        p = _policy(side, **spec)
        sides.append([
            None if d is None else (d.direction, d.target, d.reason)
            for d in (p.observe(cur, queue_depth=q, shed_rate=s,
                                straggler_lag_ms=lag)
                      for cur, q, s, lag in obs)])
    assert sides[0] == sides[1]
    assert any(d is not None for d in sides[1]) or script == "bounds"


class TestAutoscale:
    def test_scale_up_needs_sustained_overload(self):
        p = _policy(t_autoscale)
        assert p.observe(4, shed_rate=0.5) is None
        assert p.observe(4, shed_rate=0.5) is None
        d = p.observe(4, shed_rate=0.5)
        assert d is not None and d.direction == "up" and d.target == 5

    def test_one_burst_never_flaps(self):
        p = _policy(t_autoscale)
        assert p.observe(4, shed_rate=0.5) is None
        assert p.observe(4, shed_rate=0.0) is None   # streak broken
        assert p.observe(4, shed_rate=0.5) is None
        assert p.observe(4, shed_rate=0.5) is None
        assert p.observe(4, shed_rate=0.5) is not None

    def test_cooldown_after_decision(self):
        p = _policy(t_autoscale, hysteresis_rounds=1)
        assert p.observe(4, shed_rate=0.5).direction == "up"
        assert p.observe(5, shed_rate=0.9) is None

    def test_scale_down_on_idle_straggler(self):
        p = _policy(t_autoscale, hysteresis_rounds=2)
        assert p.observe(4, straggler_lag_ms=80.0) is None
        d = p.observe(4, straggler_lag_ms=80.0)
        assert d is not None and d.direction == "down" and d.target == 3

    def test_no_scale_down_under_load(self):
        p = _policy(t_autoscale, hysteresis_rounds=1)
        d = p.observe(4, straggler_lag_ms=80.0, shed_rate=0.2)
        assert d is not None and d.direction == "up"

    def test_bounds_respected(self):
        p = _policy(t_autoscale, hysteresis_rounds=1)
        assert p.observe(8, shed_rate=0.9) is None       # at max_np
        p2 = _policy(t_autoscale, hysteresis_rounds=1)
        assert p2.observe(2, straggler_lag_ms=99.0) is None   # at min_np

    def test_controller_drives_driver_and_metrics(self):
        class StubDriver:
            def __init__(self):
                self.targets = []

            def world_size(self):
                return 4

            def set_target_np(self, n):
                self.targets.append(n)

        gauges = {"queue_depth": 0.0, "shed_rate": 0.4,
                  "straggler_lag_ms": 0.0}
        driver = StubDriver()
        ctl = AutoscaleController(
            driver, lambda: dict(gauges),
            _policy(t_autoscale, hysteresis_rounds=2), interval=999.0)
        assert ctl.tick() is None
        d = ctl.tick()
        assert d is not None and driver.targets == [5]
        assert ctl.decisions == [d]

    def test_registry_source_reads_the_port_registry(self):
        from horovod_tpu_torch.telemetry.registry import MetricsRegistry
        reg = MetricsRegistry(0)
        src = t_autoscale.registry_source(reg)
        reg.gauge("horovod_serve_queue_depth").set(12)
        reg.gauge("horovod_controller_straggler_lag_ms").set(7.5)
        served = reg.counter("horovod_serve_requests_total",
                             labels={"outcome": "served"})
        shed = reg.counter("horovod_serve_requests_total",
                           labels={"outcome": "shed"})
        served.inc(10)
        s1 = src()
        assert s1 == {"queue_depth": 12.0, "shed_rate": 0.0,
                      "straggler_lag_ms": 7.5}
        served.inc(10)
        shed.inc(10)
        assert src()["shed_rate"] == pytest.approx(0.5)


class TestHttpSource:
    def test_scrapes_exposition_and_deltas(self):
        import http.server
        import threading

        body = [(b"# HELP x\n"
                 b'horovod_serve_requests_total{outcome="served"} 10\n'
                 b'horovod_serve_requests_total{outcome="shed"} 0\n'
                 b"horovod_serve_queue_depth 12\n"
                 b"horovod_controller_straggler_lag_ms 7.5\n")]

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body[0])))
                self.end_headers()
                self.wfile.write(body[0])

            def log_message(self, *a):
                pass

        srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}/"
            port_src = t_autoscale.http_source(url)
            ref_src = j_autoscale.http_source(url)
            s1 = port_src()
            assert s1 == ref_src()
            assert s1["queue_depth"] == 12.0
            assert s1["straggler_lag_ms"] == 7.5
            body[0] = (
                b'horovod_serve_requests_total{outcome="served"} 20\n'
                b'horovod_serve_requests_total{outcome="shed"} 10\n')
            s2 = port_src()
            assert s2 == ref_src()
            assert s2["shed_rate"] == pytest.approx(0.5)
        finally:
            srv.shutdown()
            srv.server_close()

    def test_unreachable_endpoint_reads_idle(self):
        src = t_autoscale.http_source("http://127.0.0.1:1/", timeout=0.2)
        assert src() == {"queue_depth": 0.0, "shed_rate": 0.0,
                         "straggler_lag_ms": 0.0}


# ---------------------------------------------------------------------------
# Elastic driver: blacklist readmission and the autoscale target
# ---------------------------------------------------------------------------
class TestBlacklistReadmission:
    def _mgr(self, slots=2, cooldown=None):
        from horovod_tpu_torch.elastic.discovery import (FixedHostDiscovery,
                                                         HostManager)
        return HostManager(FixedHostDiscovery(OrderedDict(a=slots, b=2)),
                           blacklist_cooldown=cooldown)

    def test_manual_clear_readmits_with_fresh_slots(self):
        from horovod_tpu_torch.elastic.discovery import (FixedHostDiscovery,
                                                         HostManager)
        disc = FixedHostDiscovery(OrderedDict(a=2, b=2))
        mgr = HostManager(disc)
        mgr.update_available_hosts()
        mgr.blacklist("a")
        mgr.update_available_hosts()
        assert "a" not in mgr.current_hosts
        # The host returns with a DIFFERENT slot count; clearing picks up
        # the refreshed count, not a remembered one.
        disc._hosts["a"] = 4
        assert mgr.clear_blacklist("a") is True
        assert not mgr.is_blacklisted("a")
        mgr.update_available_hosts()
        assert mgr.current_hosts["a"] == 4

    def test_clear_unknown_host_is_noop(self):
        assert self._mgr().clear_blacklist("nope") is False

    def test_cooldown_expiry_readmits(self):
        mgr = self._mgr(cooldown=0.05)
        mgr.update_available_hosts()
        mgr.blacklist("a")
        assert mgr.is_blacklisted("a")
        mgr.update_available_hosts()
        assert "a" not in mgr.current_hosts
        time.sleep(0.08)
        mgr.update_available_hosts()
        assert "a" in mgr.current_hosts
        assert not mgr.blacklisted_hosts

    def test_explicit_cooldown_overrides_default(self):
        mgr = self._mgr(cooldown=None)
        mgr.blacklist("a", cooldown=0.05)
        time.sleep(0.08)
        assert not mgr.is_blacklisted("a")

    def test_forever_without_cooldown(self):
        mgr = self._mgr()
        mgr.blacklist("a")
        time.sleep(0.05)
        assert mgr.is_blacklisted("a")

    def test_driver_target_np_clamped(self):
        from horovod_tpu_torch.elastic.discovery import FixedHostDiscovery
        from horovod_tpu_torch.elastic.driver import ElasticDriver
        driver = ElasticDriver(FixedHostDiscovery(OrderedDict(a=8)),
                               min_np=2, max_np=6)
        driver.set_target_np(99)
        assert driver.target_np() == 6
        driver.set_target_np(1)
        assert driver.target_np() == 2
        driver.set_target_np(4)
        assert driver.target_np() == 4

    def test_target_caps_the_next_round(self):
        """The target caps the slots of the next round the driver forms
        (its ``_form_round``), as the reference's does."""
        from horovod_tpu_torch.elastic.discovery import FixedHostDiscovery
        from horovod_tpu_torch.elastic.driver import ElasticDriver
        driver = ElasticDriver(FixedHostDiscovery(OrderedDict(a=8)),
                               min_np=2, max_np=6)
        driver._host_manager.update_available_hosts()
        driver._launch_worker = lambda slot: None   # form rounds only
        driver.set_target_np(3)
        driver._form_round()
        assert len(driver.final_slots()) == 3
        driver.set_target_np(5)
        driver._form_round()
        assert len(driver.final_slots()) == 5


# ---------------------------------------------------------------------------
# Donation, and the chaos preempt action
# ---------------------------------------------------------------------------
class TestDonation:
    def test_fetch_donation_verifies_digest(self, kv_server):
        from horovod_tpu_torch.statesync.service import (_donate_scope,
                                                         fetch_donation)
        tree = {"shard": np.arange(32, dtype=np.float32)}
        image = flatten_state(tree)
        kv_server.put(_donate_scope("ep"), "1.meta", json.dumps(
            {"digest": state_digest(image), "nbytes": len(image),
             "seq": 3}).encode())
        kv_server.put(_donate_scope("ep"), "1", bytes(image))
        out = fetch_donation("ep", 1, {"shard": np.zeros(32, np.float32)},
                             kv=kv_server)
        np.testing.assert_array_equal(out["shard"].numpy(), tree["shard"])
        # Tampered payload: rejected, never unflattened.
        kv_server.put(_donate_scope("ep"), "1",
                      bytes(bytearray([image[0] ^ 0xff]) + image[1:]))
        assert fetch_donation("ep", 1, {"shard": np.zeros(32, np.float32)},
                              kv=kv_server) is None

    def test_failure_shrink_of_a_sharded_state_raises(self, kv_server):
        """A dead rank took its chunks with it: a sharded service's
        failure shrink raises at once, naming the restore; a static
        (serving) state cannot be sharded."""
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.statesync import StateSyncService
        hvd.init()
        try:
            svc = StateSyncService(lambda: {}, sharded=True, kv=kv_server)
            dead = hvd.RanksFailedError({1}, op="loss.2")
            with pytest.raises(RuntimeError,
                               match="restore_checkpoint") as err:
                svc.shrink_on_failure(dead)
            assert err.value.__cause__ is dead
            svc.close()
            with pytest.raises(ValueError, match="not sharded"):
                StateSyncService(lambda: {}, sharded=True,
                                 static_state=True, kv=kv_server)
        finally:
            hvd.shutdown()

    def test_missing_donation_is_none(self, kv_server):
        from horovod_tpu_torch.statesync.service import fetch_donation
        assert fetch_donation("ep", 7, {"x": np.zeros(1)},
                              kv=kv_server) is None

    def test_kv_delete_consumes_marks(self, kv_server):
        kv_server.put("ssgrow.e", "join:0", b"{}")
        assert kv_server.get("ssgrow.e", "join:0") == b"{}"
        kv_server.delete("ssgrow.e", "join:0")
        assert kv_server.get("ssgrow.e", "join:0") is None

    def test_scopes_match_reference(self):
        from horovod_tpu.statesync import service as js
        from horovod_tpu.statesync import stream as jst
        from horovod_tpu_torch.statesync import service as ts
        from horovod_tpu_torch.statesync import stream as tst
        assert ts._donate_scope("e") == js._donate_scope("e")
        assert ts._grow_scope("e") == js._grow_scope("e")
        assert tst.sync_scope("e", 3) == jst.sync_scope("e", 3)


class TestChaosPreempt:
    def test_parse_and_defaults(self):
        from horovod_tpu_torch.resilience.chaos import parse_spec
        act = parse_spec("preempt:rank=2,op=7")[0]
        assert act.kind == "preempt"
        assert act.rank == 2 and act.op == 7
        assert act.count == 1   # one notice, not a repeating signal

    def test_delivers_sigterm_and_survives(self):
        """The preempt action sends SIGTERM and keeps running — the
        grace path owns the departure."""
        from horovod_tpu_torch.resilience.chaos import ChaosEngine
        hits = []
        old = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
        try:
            eng = ChaosEngine("preempt:rank=0,op=1", rank=0)
            assert eng.on_response(["t0"]) is None
            assert not hits
            assert eng.on_response(["t1"]) is None   # op 1: fires
            assert hits == [signal.SIGTERM]
            assert eng.on_response(["t2"]) is None   # count exhausted
            assert hits == [signal.SIGTERM]
        finally:
            signal.signal(signal.SIGTERM, old)


# ---------------------------------------------------------------------------
# Process-level batteries
# ---------------------------------------------------------------------------
def _run_world(battery: str, size: int, outdir: Path, expected_rcs=None,
               timeout: float = 240.0) -> list[str]:
    """Run ``battery``'s world of ``size`` launch ranks (and its joiner)
    and return each launch rank's output; a battery with a joiner runs
    one process more."""
    with world_lock(size + (battery in JOINERS)):
        return _world(battery, size, outdir, expected_rcs, timeout)


def _world(battery: str, size: int, outdir: Path, expected_rcs,
           timeout: float) -> list[str]:
    server = RendezvousServer()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), battery, str(r), str(size),
         str(port), str(outdir)], env=env, stdout=subprocess.PIPE,
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


def membership_events(outdir: Path, battery: str, launch_rank) -> list:
    """The membership transitions of one rank's flight ring, in order."""
    with open(outdir / f"{battery}.{launch_rank}.json") as f:
        record = json.load(f)
    return [kind for kind, _ in record["flight"]
            if kind in MEMBERSHIP_KINDS]


def test_statesync_grow_rides_3_2_3(tmp_path):
    """A chaos SIGKILL of rank 2 mid-training: the survivors shrink with
    zero failed steps after it, a replacement joins by peer streaming
    with zero failed incumbent steps, its catch-up bounded, the streamed
    state digest-equal on every rank (asserted in-battery)."""
    outputs = _run_world("grow", 3, tmp_path,
                         expected_rcs={2: -signal.SIGKILL})
    for r in (0, 1):
        assert "rode 3->2->3" in outputs[r], outputs[r]
        assert membership_events(tmp_path, "grow", r) == \
            ["shrink", "donate", "grow"]
    assert "joiner: catch-up" in outputs[0], outputs[0]
    assert membership_events(tmp_path, "joiner", "J") == \
        ["join-announce", "join-ready", "join-entered"]
    digests = {json.load(open(tmp_path / f"{name}.json"))["digest"]
               for name in ("grow.0", "grow.1", "joiner.J")}
    assert len(digests) == 1, digests


def test_statesync_preempt_grace_3rank(tmp_path):
    """The preempted rank departs with bye| inside the grace window (exit
    0, never a signal death) and the survivors shrink proactively with
    no RanksFailedError anywhere (the battery runs its collectives bare:
    any structured failure fails a worker)."""
    outputs = _run_world("preempt", 3, tmp_path)
    assert "departed with bye| stamp" in outputs[1], outputs[1]
    assert membership_events(tmp_path, "preempt", 1) == \
        ["sigterm-grace", "departed"]
    for r in (0, 2):
        assert "no RanksFailedError anywhere" in outputs[r], outputs[r]
        assert membership_events(tmp_path, "preempt", r) == \
            ["shrink-proactive"]


def _sharded_records(outdir: Path, battery: str) -> dict:
    joiner = battery.replace("grow", "joiner")
    return {name: json.load(open(outdir / f"{name}.json"))
            for name in (f"{battery}.0", f"{battery}.1", f"{joiner}.J")}


def _fake_mesh(**sizes):
    """A port ``Mesh`` record (no group) of the given axis sizes, rank 0."""
    from horovod_tpu_torch.parallel.mesh import DEFAULT_AXES, Mesh
    shape = {a: sizes.get(a, 1) for a in DEFAULT_AXES}
    return Mesh(shape=shape, group=None, device=torch.device("cpu"),
                groups={a: None for a, n in shape.items() if n > 1},
                coords=dict.fromkeys(shape, 0))


def _sharded_plan(model, n: int) -> dict:
    from horovod_tpu_torch.parallel.sharding import (ShardingRules,
                                                     plan_sharding)
    from torch_statesync_worker import SHARDED_RULES
    return plan_sharding(model, _fake_mesh(fsdp=n),
                         ShardingRules(list(SHARDED_RULES)))


def test_statesync_grow_sharded_rides_fsdp_2_3_2(tmp_path):
    """A state with sharded parameters (the FSDP table) grows from fsdp=2
    to 3 by a joiner and is preempted back to 2, without a restart: the
    incumbents donate the gathered (whole) state, the joiner loads it into
    its sharded Trainer with the stamp's digest, every rank re-cuts the
    transition's whole tree on the new mesh, and every rank's gathered
    state is equal after every step.  The same battery with no rules
    gives the same losses and digests, bit for bit."""
    from torch_statesync_worker import ShardedRun
    runs = {}
    for battery in ("grow-sharded", "grow-plain"):
        out = tmp_path / battery
        out.mkdir()
        outputs = _run_world(battery, 2, out)
        for r in (0, 1):
            assert "rode fsdp 2->3->2" in outputs[r], outputs[r]
            assert membership_events(out, battery, r) == \
                ["donate", "grow", "shrink-proactive"]
        joiner = battery.replace("grow", "joiner")
        assert membership_events(out, joiner, "J") == \
            ["join-announce", "join-ready", "join-entered", "sigterm-grace",
             "departed"]
        runs[battery] = _sharded_records(out, battery)
    sharded, plain = runs["grow-sharded"], runs["grow-plain"]
    for (name, got), want in zip(sharded.items(), plain.values()):
        strip = [{k: v for k, v in s.items() if k != "elements"}
                 for rec in (got, want) for s in rec["steps"]]
        half = len(strip) // 2
        assert strip[:half] == strip[half:], name
        assert got["entered_digest"] == want["entered_digest"], name
    inc = sharded["grow-sharded.0"]["steps"]
    assert [s["size"] for s in inc] == [2, 2, 3, 3, 3, 2, 2, 2]
    joined = sharded["joiner-sharded.J"]
    assert joined["entered_digest"] == joined["stamp_digest"] \
        == sharded["grow-sharded.0"]["entered_digest"]
    assert (joined["rank"], joined["size"]) == (2, 3)
    # Every rank's gathered state is the same after every step.
    by_step: dict[int, set] = {}
    for rec in sharded.values():
        for s in rec["steps"]:
            by_step.setdefault(s["step"], set()).add(s["digest"])
    assert sorted(by_step) == list(range(1, 9))
    assert all(len(d) == 1 for d in by_step.values()), by_step
    # Each rank holds its chunks: the elements the table cuts, over the
    # world's size.
    model = ShardedRun.fresh().model
    whole = sum(p.numel() for p in model.parameters())
    for n in (2, 3):
        held = sum(int(np.prod(leaf.flax_shape)) // (n if leaf.sharded
                                                      else 1)
                   for leaf in _sharded_plan(model, n).values())
        assert held < whole
        assert {s["elements"] for rec in sharded.values()
                for s in rec["steps"] if s["size"] == n} == {held}
    assert {s["elements"] for rec in plain.values()
            for s in rec["steps"]} == {whole}
    _hold_gathered_to_reference(tmp_path / "grow-sharded", model)


def _hold_gathered_to_reference(outdir: Path, model) -> None:
    """The port's gathered parameters at fsdp=2, leaf by leaf, against
    what the reference's snapshot reads (``np.asarray`` of each leaf)
    from arrays sharded by the same rules on a 2-device CPU mesh, built
    from the two ranks' chunks; then the two images whole."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from horovod_tpu.parallel.mesh import DEFAULT_AXES
    chunks = [dict(np.load(outdir / f"grow-sharded.{r}.chunks.npz"))
              for r in (0, 1)]
    whole = dict(np.load(outdir / "grow-sharded.whole.npz"))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(
        [2 if a == "fsdp" else 1 for a in DEFAULT_AXES]), DEFAULT_AXES)
    ref_tree, port_tree = [], []
    for name, leaf in _sharded_plan(model, 2).items():
        parts = [leaf.to_flax(torch.from_numpy(c[name]),
                              leaf.chunk_flax_shape).contiguous().numpy()
                 for c in chunks]
        arr = jax.make_array_from_single_device_arrays(
            leaf.flax_shape, NamedSharding(mesh, PartitionSpec(*leaf.spec)),
            [jax.device_put(p, d) for p, d in
             zip(parts, mesh.devices.reshape(-1))])
        got = leaf.to_flax(torch.from_numpy(whole[f"params/{name}"]),
                           leaf.flax_shape).contiguous()
        want = np.asarray(arr)
        assert (got.numpy().dtype, got.shape) == (want.dtype, want.shape)
        assert got.numpy().tobytes() == want.tobytes(), name
        ref_tree.append(arr)
        port_tree.append(got)
    assert bytes(flatten_state(port_tree)) == \
        bytes(j_snapshot.flatten_state(ref_tree))
