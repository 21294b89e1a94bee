"""The port's replicated rendezvous against the JAX package, on the CPU.

- The write-ahead log: records written by each package's ``WalWriter``
  are the same bytes, and a log written by either package replays in the
  other to the same ``replay_state`` (digest, KV, counters, claims, epoch);
  torn tails and epoch fencing as the reference's ``TestWal``.
- The durable server: a restarted server replays the log, whichever
  package wrote it; the reference's ``TestDurableServer`` and
  ``TestClient`` cases on the port's server and client.
- Failover: the reference's ``TestFailover`` and ``TestSubprocessPrimary``
  on the port (``python -m horovod_tpu_torch.runner.controlplane`` as the
  primary), with each package's client; after every failover the promoted
  standby's ``kv_digest()`` equals both packages' replay of the log.
- Chaos ``coordkill``/``coordpause`` parse as the reference's and signal
  the primary found through the seed list.
- The wire handshake: ``advertised_hello`` and the negotiated proto equal
  the reference's for each ``HOROVOD_PROTO_COMPAT``; the WAL's group
  commit of 64 stamps (``tests/test_fleetsim.py``'s case).
- Two worlds of ``tests/torch_controlplane_worker.py``: the rolling
  upgrade at 2 ranks, and the coordinator kill, then a shrink and a grow,
  at 4 ranks over a 500 ms lease.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from horovod_tpu.common import wire as j_wire
from horovod_tpu.resilience import chaos as j_chaos
from horovod_tpu.runner import controlplane as j_cp
from horovod_tpu.runner import network as j_net
from horovod_tpu_torch.common import wire as t_wire
from horovod_tpu_torch.resilience import chaos as t_chaos
from horovod_tpu_torch.runner import controlplane as t_cp
from horovod_tpu_torch.runner import network as t_net
from horovod_tpu_torch.runner.network import (RendezvousClient,
                                              RendezvousServer, free_port)
from torch_world_lock import world_locked

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "torch_controlplane_worker.py"
LEASE_MS = 300.0
CPS = {"port": t_cp, "ref": j_cp}
NETS = {"port": t_net, "ref": j_net}

# A log's worth of every record kind, the fenced stale write included.
RECORDS = [(1, "leader", "", "0", b"0|0"),
           (1, "lease", "", "0", b"0|1e12"),
           (1, "put", "s", "committed", b"yes"),
           (1, "claim", "s", "slots", b"h1|0"),
           (1, "claim", "s", "slots", b"h2|1"),
           (1, "put", "mesh", "addr:0", b"10.0.0.1:4711"),
           (1, "delete", "s", "committed", b""),
           (1, "put", "s", "kept", bytes(range(256))),
           (2, "leader", "", "1", b"1|0"),
           (1, "put", "s", "stale", b"fenced-out"),
           (2, "put", "s", "new", b"ok"),
           (2, "delete", "mesh", "", b""),
           (2, "claim", "s", "slots", b"|2")]


def _write(cp, path: str, records=RECORDS) -> bytes:
    w = cp.WalWriter(path)
    for rec in records:
        assert w.append(*rec)
    w.close()
    with open(path, "rb") as f:
        return f.read()


def _clean(state: dict) -> dict:
    return {k: state[k] for k in ("kv", "counters", "claims", "digest",
                                  "epoch", "leader_id", "lease_expiry")}


# --- WAL ------------------------------------------------------------------
class TestWal:
    def test_records_are_the_reference_bytes(self, tmp_path):
        os.makedirs(tmp_path / "t")
        ours = _write(t_cp, t_cp.wal_path(str(tmp_path / "t")))
        theirs = _write(j_cp, j_cp.wal_path(str(tmp_path)))
        assert ours == theirs
        assert t_cp.wal_path("d") == j_cp.wal_path("d")

    @pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                               ("ref", "port")])
    def test_each_package_replays_the_others_log(self, tmp_path, writer,
                                                 reader):
        path = CPS[writer].wal_path(str(tmp_path))
        _write(CPS[writer], path)
        got = CPS[reader].replay_state(path)
        want = CPS[writer].replay_state(path)
        assert _clean(got) == _clean(want)
        assert list(CPS[reader].replay(path)) == \
            list(CPS[writer].replay(path))
        assert got["epoch"] == 2 and "stale" not in got["kv"]["s"]
        assert got["claims"]["s/slots"] == {"h1": 0, "h2": 1}
        assert got["counters"]["s/slots"] == 3

    def test_record_roundtrip_and_digest(self, tmp_path):
        path = t_cp.wal_path(str(tmp_path))
        _write(t_cp, path, [(1, "put", "s", "k", b"v"),
                            (1, "claim", "s", "slots", b"h1|0"),
                            (1, "delete", "s", "k", b"")])
        assert [(r[1], r[2], r[3]) for r in t_cp.replay(path)] == [
            ("put", "s", "k"), ("claim", "s", "slots"),
            ("delete", "s", "k")]
        state = t_cp.replay_state(path)
        assert state["kv"].get("s", {}) == {}
        assert state["counters"]["s/slots"] == 1
        assert state["claims"]["s/slots"] == {"h1": 0}
        assert state["digest"] == j_cp.replay_state(path)["digest"]

    @pytest.mark.parametrize("tail", [
        b"\x00\x00\x00\x20garbage-without-its-crc",   # a partial record
        b"\x00\x00\x00\x02ab\x00\x00\x00\x00",         # a CRC mismatch
        b"\x00\x00"])                                  # a torn header
    def test_torn_tail_tolerated(self, tmp_path, tail):
        path = t_cp.wal_path(str(tmp_path))
        _write(t_cp, path, [(1, "put", "s", "a", b"1"),
                            (1, "put", "s", "b", b"2")])
        with open(path, "ab") as f:
            f.write(tail)
        state = t_cp.replay_state(path)
        assert state["kv"]["s"] == {"a": b"1", "b": b"2"}
        assert _clean(state) == _clean(j_cp.replay_state(path))

    def test_epoch_fencing_drops_stale_primary_writes(self, tmp_path):
        path = t_cp.wal_path(str(tmp_path))
        _write(t_cp, path, [(1, "leader", "", "0", b"0|0"),
                            (1, "put", "s", "committed", b"yes"),
                            (2, "leader", "", "1", b"1|0"),
                            (1, "put", "s", "stale", b"fenced-out"),
                            (2, "put", "s", "new", b"ok")])
        state = t_cp.replay_state(path)
        assert state["epoch"] == 2 and state["leader_id"] == 1
        assert state["kv"]["s"] == {"committed": b"yes", "new": b"ok"}

    def test_replay_from_an_offset(self, tmp_path):
        path = t_cp.wal_path(str(tmp_path))
        raw = _write(t_cp, path)
        first = t_cp._encode_record(*RECORDS[0])
        assert raw.startswith(first)
        assert list(t_cp.replay(path, len(first))) == \
            list(j_cp.replay(path, len(first)))
        assert list(t_cp.replay(str(tmp_path / "none"))) == []

    def test_group_commit_coalesces_at_64(self, tmp_path, monkeypatch):
        """64 heartbeat stamps in one ``put_many`` land as 64 records in
        a handful of fsync batches (the group-commit counters)."""
        from horovod_tpu_torch import telemetry
        monkeypatch.setenv("HOROVOD_METRICS", "on")
        reg = telemetry.configure()

        def counter(name):
            return sum(e["value"] for e in reg.snapshot()["metrics"]
                       if e["name"] == name)
        try:
            server = RendezvousServer(wal_dir=str(tmp_path))
            port = server.start()
            try:
                client = RendezvousClient(f"127.0.0.1:{port}",
                                          timeout=10.0)
                base = (counter("horovod_rendezvous_wal_records_total"),
                        counter("horovod_rendezvous_wal_commit_batches_"
                                "total"))
                client.put_many([("hb", f"fleet:{i}",
                                  f"{i}|{os.getpid()}".encode())
                                 for i in range(64)])
                records = counter(
                    "horovod_rendezvous_wal_records_total") - base[0]
                batches = counter(
                    "horovod_rendezvous_wal_commit_batches_total") - base[1]
                assert records == 64
                assert 1 <= batches <= 16, batches
                assert client.get("hb", "fleet:63") == \
                    b"63|%d" % os.getpid()
                for cp in CPS.values():
                    replayed = cp.replay_state(cp.wal_path(str(tmp_path)))
                    assert replayed["kv"]["hb"]["fleet:0"] == \
                        b"0|%d" % os.getpid()
            finally:
                server.stop()
        finally:
            monkeypatch.delenv("HOROVOD_METRICS")
            telemetry.configure()


# --- the durable server ---------------------------------------------------
def _drive(client) -> int:
    client.put("mesh", "addr:0", b"10.0.0.1:4711")
    idx = client.claim("slots", "h1", task_key="h1[0]")
    client.put("mesh", "gone", b"x")
    client.delete("mesh", "gone")
    client.put_many([("hb", f"e:{i}", b"%d" % i) for i in range(5)])
    return idx


class TestDurableServer:
    @pytest.mark.parametrize("first,second", [("port", "port"),
                                              ("ref", "port"),
                                              ("port", "ref")])
    def test_restart_replays_the_log(self, tmp_path, first, second):
        """A server of ``second`` restarts on the log a server of
        ``first`` wrote: the same values, digest and claim indices."""
        wal_dir = str(tmp_path)
        srv = NETS[first].RendezvousServer(wal_dir=wal_dir)
        srv.start()
        client = RendezvousClient("127.0.0.1", srv.port, timeout=10.0)
        idx = _drive(client)
        digest = srv.kv_digest()
        srv.stop()

        srv2 = NETS[second].RendezvousServer(wal_dir=wal_dir)
        srv2.start()
        try:
            c2 = RendezvousClient("127.0.0.1", srv2.port, timeout=10.0)
            assert c2.get("mesh", "addr:0") == b"10.0.0.1:4711"
            assert c2.get("mesh", "gone") is None
            assert c2.get("hb", "e:4") == b"4"
            assert c2.claim("slots", "h1", task_key="h1[0]") == idx
            assert srv2.kv_digest() == digest
            assert c2.claim("slots", "h1", task_key="h1[1]") == idx + 1
        finally:
            srv2.stop()
        path = t_cp.wal_path(wal_dir)
        assert t_cp.replay_state(path)["digest"] == \
            j_cp.replay_state(path)["digest"]

    def test_the_knob_attaches_the_log(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_WAL_DIR", str(tmp_path))
        srv = RendezvousServer()
        srv.start()
        try:
            assert srv.controlplane is not None
            assert srv.controlplane.role == "primary"
            assert srv.controlplane.epoch == 1
            RendezvousClient("127.0.0.1", srv.port, 5.0).put("s", "k", b"v")
        finally:
            srv.stop()
        assert t_cp.replay_state(t_cp.wal_path(str(tmp_path)))["kv"] == \
            {"s": {"k": b"v"}}

    def test_without_wal_dir_behavior_unchanged(self):
        srv = RendezvousServer()
        srv.start()
        try:
            assert srv.controlplane is None
            client = RendezvousClient("127.0.0.1", srv.port, timeout=5.0)
            client.put("s", "k", b"v")
            assert client.get("s", "k") == b"v"
            assert client.probe().startswith("primary")
        finally:
            srv.stop()

    def test_ctl_endpoints(self, tmp_path):
        """``/.ctl/role``, ``pid`` and ``wal?from=`` answer as the
        reference's server does over the same log."""
        from urllib import request as urlrequest
        out = {}
        for side in ("port", "ref"):
            wal_dir = str(tmp_path / side)
            srv = NETS[side].RendezvousServer(wal_dir=wal_dir)
            srv.start()
            try:
                RendezvousClient("127.0.0.1", srv.port, 5.0).put(
                    "s", "k", b"v")
                base = f"http://127.0.0.1:{srv.port}/.ctl/"
                role = urlrequest.urlopen(base + "role").read()
                pid = int(urlrequest.urlopen(base + "pid").read())
                with urlrequest.urlopen(base + "wal?from=0") as resp:
                    raw, end = resp.read(), int(
                        resp.headers["X-Hvd-Wal-End"])
            finally:
                srv.stop()
            data = [r for r in t_cp.replay(t_cp.wal_path(wal_dir))
                    if r[1] == "put"]
            out[side] = (role, pid, end == len(raw), data)
        assert out["port"][0] == out["ref"][0] == b"primary|1|"
        assert out["port"][1] == out["ref"][1] == os.getpid()
        assert out["port"][2:] == out["ref"][2:]


# --- client behavior against the port's server ----------------------------
class TestClient:
    def test_long_poll_wait_wakes_on_put(self):
        srv = RendezvousServer()
        srv.start()
        client = RendezvousClient("127.0.0.1", srv.port, timeout=10.0)
        t = threading.Thread(target=lambda: (time.sleep(0.3),
                                             srv.put("s", "slow",
                                                     b"arrived")))
        t0 = time.monotonic()
        t.start()
        value = client.wait("s", "slow", timeout=5.0)
        wall = time.monotonic() - t0
        t.join()
        srv.stop()
        assert value == b"arrived"
        assert 0.25 < wall < 2.0, wall

    def test_idempotent_retry_rides_restart_window(self, tmp_path):
        wal_dir = str(tmp_path)
        srv = RendezvousServer(wal_dir=wal_dir)
        srv.start()
        port = srv.port
        srv.put("s", "k", b"v")
        srv.stop()
        client = RendezvousClient("127.0.0.1", port, timeout=8.0)
        restarted = []

        def _restart_later():
            time.sleep(0.6)
            back = RendezvousServer(port=port, wal_dir=wal_dir)
            back.start()
            restarted.append(back)

        t = threading.Thread(target=_restart_later)
        t.start()
        value = client.get("s", "k")
        t.join()
        restarted[0].stop()
        assert value == b"v"

    def test_bare_claim_fails_fast_unreachable(self):
        client = RendezvousClient("127.0.0.1", free_port(), timeout=2.0)
        t0 = time.monotonic()
        with pytest.raises(OSError):
            client.claim("slots", "h1")          # no task_key: no retry
        assert time.monotonic() - t0 < 1.0
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            client.get("s", "k")                 # idempotent: bounded
        assert 1.5 < time.monotonic() - t0 < 5.0

    @pytest.mark.parametrize("addr,port", [
        ("10.0.0.1:19000,10.0.0.2:19001", -1), ("host", 80),
        ("a:1, b:2 ,", 0), ("127.0.0.1", 4711)])
    def test_seed_list_parsing(self, addr, port):
        assert RendezvousClient.parse_endpoints(addr, port) == \
            j_net.RendezvousClient.parse_endpoints(addr, port)


# --- failover ---------------------------------------------------------------
def _assert_digest_is_the_log(server, wal_dir: str) -> None:
    path = t_cp.wal_path(wal_dir)
    assert server.kv_digest() == t_cp.replay_state(path)["digest"] == \
        j_cp.replay_state(path)["digest"]


class TestFailover:
    @pytest.mark.parametrize("client_side", ["port", "ref"])
    def test_standby_promotes_and_no_committed_write_lost(self, tmp_path,
                                                          client_side):
        lease_s = LEASE_MS / 1e3
        servers, eps = t_cp.start_replica_set(2, str(tmp_path),
                                              lease_ms=LEASE_MS)
        try:
            client = NETS[client_side].RendezvousClient(",".join(eps),
                                                        timeout=10.0)
            for i in range(8):
                client.put("s", f"k{i}", f"v{i}".encode())
            assert client.claim("slots", "h1", task_key="h1[0]") == 0
            digest = servers[0].kv_digest()
            _assert_digest_is_the_log(servers[0], str(tmp_path))
            # A standby answers 409 and names the leader.
            assert servers[1].controlplane.check_write() == (False, eps[0])
            assert servers[0].controlplane.describe().startswith("primary|")

            # Hard-kill the primary (no graceful teardown).
            servers[0]._httpd.controlplane._stop.set()
            servers[0]._httpd.shutdown()
            servers[0]._httpd.server_close()

            t0 = time.monotonic()
            assert client.wait("s", "k3", timeout=10 * lease_s) == b"v3"
            assert time.monotonic() - t0 < 3.5 * lease_s
            standby = servers[1]
            assert standby.controlplane.role == "primary"
            assert standby.controlplane.failovers == 1
            assert standby.kv_digest() == digest
            assert client.claim("slots", "h1", task_key="h1[0]") == 0
            for i in range(8):
                assert client.get("s", f"k{i}") == f"v{i}".encode()
            client.put("s", "post", b"after")
            assert client.get("s", "post") == b"after"
            _assert_digest_is_the_log(standby, str(tmp_path))
        finally:
            for s in servers[1:]:
                s.stop()


def _spawn_primary(wal_dir, endpoints, lease_ms=LEASE_MS):
    """One replica as its own process (the chaos coordkill target)."""
    port = int(endpoints[0].rsplit(":", 1)[1])
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.controlplane",
         "--port", str(port), "--wal-dir", str(wal_dir),
         "--replica-id", "0", "--endpoints", ",".join(endpoints),
         "--lease-ms", str(lease_ms)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    line = proc.stdout.readline().decode()
    assert line == f"READY {port} {proc.pid}\n", line
    return proc


def _replica_pair(wal_dir, lease_ms=LEASE_MS):
    ports = [free_port(), free_port()]
    eps = [f"127.0.0.1:{p}" for p in ports]
    proc = _spawn_primary(wal_dir, eps, lease_ms)
    standby = RendezvousServer(port=ports[1], wal_dir=str(wal_dir),
                               replica_id=1, endpoints=eps,
                               lease_ms=lease_ms, standby=True)
    standby.start()
    return proc, standby, eps


class TestSubprocessPrimary:
    def test_sigkill_primary_promotes_standby(self, tmp_path):
        proc, standby, eps = _replica_pair(tmp_path)
        try:
            client = RendezvousClient(",".join(eps), timeout=15.0)
            client.put("s", "before", b"1")
            assert client.find_primary() == eps[0]
            proc.kill()
            proc.wait(timeout=10)
            assert client.wait("s", "before",
                               timeout=10 * LEASE_MS / 1e3) == b"1"
            assert standby.controlplane.role == "primary"
            client.put("s", "after", b"2")
            assert client.find_primary() == eps[1]
            _assert_digest_is_the_log(standby, str(tmp_path))
        finally:
            if proc.poll() is None:
                proc.kill()
            standby.stop()

    def test_coordpause_split_brain_fenced(self, tmp_path):
        """SIGSTOP the primary past its lease; the standby promotes; on
        SIGCONT the stale primary fences itself on the log's higher
        leader epoch: it demotes, answers 409 naming the new leader, and
        no acknowledged write is lost."""
        proc, standby, eps = _replica_pair(tmp_path)
        try:
            client = RendezvousClient(",".join(eps), timeout=15.0)
            client.put("s", "pre-pause", b"1")
            os.kill(proc.pid, signal.SIGSTOP)
            deadline = time.monotonic() + 10 * LEASE_MS / 1e3
            while standby.controlplane.role != "primary":
                assert time.monotonic() < deadline, "no promotion"
                time.sleep(0.05)
            client.put("s", "during-pause", b"2")
            os.kill(proc.pid, signal.SIGCONT)
            old = RendezvousClient(eps[0], timeout=5.0)
            deadline = time.monotonic() + 10 * LEASE_MS / 1e3
            role = ""
            while time.monotonic() < deadline:
                role = old.probe() or ""
                if role.startswith("standby"):
                    break
                time.sleep(0.05)
            # A loaded host may lapse a lease once more (a self-renewal
            # at a higher epoch): the role and the leader are what hold.
            assert role.startswith("standby|") and role.endswith(eps[1]), \
                role
            import urllib.error
            from urllib import request as urlrequest
            req = urlrequest.Request(f"http://{eps[0]}/s/x", data=b"1",
                                     method="PUT")
            with pytest.raises(urllib.error.HTTPError) as info:
                urlrequest.urlopen(req, timeout=5.0)
            assert info.value.code == 409
            assert info.value.headers["X-Hvd-Leader"] == eps[1]
            seeded = RendezvousClient(",".join(eps), timeout=15.0)
            assert seeded.get("s", "pre-pause") == b"1"
            assert seeded.get("s", "during-pause") == b"2"
            seeded.put("s", "post-resume", b"3")
            assert standby.controlplane.role == "primary"
            _assert_digest_is_the_log(standby, str(tmp_path))
        finally:
            if proc.poll() is None:
                proc.kill()
            standby.stop()


# --- chaos coord actions ----------------------------------------------------
class TestChaosCoordActions:
    @pytest.mark.parametrize("spec", [
        "coordkill:at=5;coordpause:at=7,ms=800,rank=1",
        "coordkill:op=3,rank=*,count=2", "coordpause:name=grads.4"])
    def test_parse_coord_actions(self, spec):
        def fields(mod):
            return [(a.kind, a.rank, a.op, a.name, a.ms, a.count)
                    for a in mod.parse_spec(spec)]
        assert fields(t_chaos) == fields(j_chaos)

    def _armed(self, monkeypatch, eps, spec):
        monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", ",".join(eps))
        monkeypatch.setenv("HOROVOD_GLOO_RENDEZVOUS_PORT",
                           eps[0].rsplit(":", 1)[1])
        return t_chaos.ChaosEngine(spec, rank=0)

    def test_coordkill_sigkills_the_primary(self, tmp_path, monkeypatch):
        eps = [f"127.0.0.1:{free_port()}"]
        proc = _spawn_primary(tmp_path, eps)
        try:
            eng = self._armed(monkeypatch, eps, "coordkill:at=2")
            assert eng.on_response(["t0"]) is None
            eng.on_response(["t1"])
            assert proc.poll() is None
            eng.on_response(["t2"])             # global index 2: fire
            proc.wait(timeout=10)
            assert proc.returncode == -signal.SIGKILL
        finally:
            if proc.poll() is None:
                proc.kill()

    def test_coordpause_stops_then_resumes_the_primary(self, tmp_path,
                                                       monkeypatch):
        eps = [f"127.0.0.1:{free_port()}"]
        proc = _spawn_primary(tmp_path, eps)
        try:
            eng = self._armed(monkeypatch, eps,
                              "coordpause:name=grads,ms=600")
            assert eng.on_response(["loss"]) is None
            eng.on_response(["grads.0"])
            time.sleep(0.1)
            with open(f"/proc/{proc.pid}/stat") as f:
                assert f.read().split(") ")[1][0] == "T"
            time.sleep(1.2)
            client = RendezvousClient(eps[0], timeout=5.0)
            client.put("s", "k", b"v")          # answers again
            assert client.get("s", "k") == b"v"
            assert proc.poll() is None
        finally:
            proc.kill()

    def test_no_primary_reachable_skips(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_GLOO_RENDEZVOUS_ADDR", raising=False)
        for mod in (t_chaos, j_chaos):
            eng = mod.ChaosEngine("coordkill:at=0", rank=0)
            assert eng.on_response(["x"]) is None
            assert eng.actions[0].count == 0


# --- the wire handshake ----------------------------------------------------
class TestWireHandshake:
    @pytest.mark.parametrize("compat", ["", "0", "1", "2", "3", "9"])
    def test_advertised_hello_is_the_reference(self, compat, monkeypatch):
        monkeypatch.setenv("HOROVOD_PROTO_COMPAT", compat)
        got = t_net.advertised_hello()
        assert got == j_net.advertised_hello()
        assert t_wire.pack_hello(*got) == j_wire.pack_hello(*got)
        native = (t_wire.PROTO_VERSION, t_wire.FEATURES_ALL)
        for peer in ((1, 0), (2, t_wire.PROTO_FEATURE_SETS[2]), native):
            assert t_wire.negotiate(*got, *peer) == \
                j_wire.negotiate(*got, *peer)
        if compat in ("1",):
            assert got == (1, 0)
        if compat in ("", "0", "9"):
            assert got == native


# --- worlds -----------------------------------------------------------------
def _clean_env(epoch: str) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=os.pathsep.join([str(REPO), str(TESTS)]),
               OMP_NUM_THREADS="1", HOROVOD_RENDEZVOUS_EPOCH=epoch)
    return env


@world_locked("size")
def _run_world(battery: str, size: int, eps: list[str], outdir: Path,
               timeout: float, expected_rcs=None) -> list[str]:
    port = eps[0].rsplit(":", 1)[1]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), battery, str(r), str(size),
         ",".join(eps), port, str(outdir)],
        env=_clean_env(f"cp{battery}{size}"), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    outputs, failed = [], []
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failed.append((r, "timeout"))
            outputs.append(f"--- rank {r} (rc={p.returncode}) ---\n"
                           + out.decode(errors="replace"))
            if p.returncode != (expected_rcs or {}).get(r, 0):
                failed.append((r, p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert not failed, f"{failed}\n" + "\n".join(outputs)
    return outputs


def test_rolling_upgrade_mixed_proto_2rank(tmp_path):
    """Rank 1 speaks proto 1: the world negotiates the base schema and
    steps under the strict fingerprint, then the lagging rank upgrades
    and the world re-forms at the native proto (over a seed list of one
    in-memory server)."""
    srv = RendezvousServer()
    srv.start()
    try:
        outputs = _run_world("rolling", 2, [f"127.0.0.1:{srv.port}"],
                             tmp_path, timeout=120.0)
    finally:
        srv.stop()
    assert all(f"ROLLING_OK rank={r} proto 1->{t_wire.PROTO_VERSION}"
               in out for r, out in enumerate(outputs)), outputs


def test_coordkill_then_shrink_grow_4rank(tmp_path):
    """The rendezvous primary (its own process) is SIGKILLed at
    collective 5 with heartbeats and the statesync watchers live; the
    standby promotes and the clients fail over; rank 2's SIGKILL at
    collective 13 then rides 4 -> 3 -> 4, the joiner's bootstrap and the
    heartbeat table all served by the promoted standby.  After every
    worker exits, the live digest equals both packages' replay."""
    wal_dir = tmp_path / "wal"
    wal_dir.mkdir()
    out = tmp_path / "out"
    out.mkdir()
    proc, standby, eps = _replica_pair(wal_dir, lease_ms=500.0)
    try:
        outputs = _run_world("grow", 4, eps, out, timeout=180.0,
                             expected_rcs={2: -signal.SIGKILL})
        assert any("rode 4->3->4" in o for o in outputs), outputs
        assert any("SIGKILL rendezvous primary" in o for o in outputs)
        proc.wait(timeout=10)
        assert proc.returncode == -signal.SIGKILL
        assert standby.controlplane.role == "primary"
        assert standby.controlplane.failovers == 1
        _assert_digest_is_the_log(standby, str(wal_dir))
        state = t_cp.replay_state(t_cp.wal_path(str(wal_dir)))
        assert state["epoch"] == 2 and state["leader_id"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
        standby.stop()
