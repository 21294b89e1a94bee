"""The port's telemetry against the JAX package's, in one process.

The same sequence of metric updates renders byte-equal Prometheus text
and an equal snapshot in both registries; the straggler aggregator gives
the same gauges and verdicts; the no-op registry is inert; the exporter
answers a scrape over loopback, closes its thread and falls back to an
ephemeral port when its port is taken; the dump paths and the JSON dump
are the reference's; the flight ring keeps the same events, snapshot and
dump (times aside); ``HOROVOD_FLIGHT=0`` installs no SIGTERM handler and
starts no thread, and with the recorder on SIGTERM dumps the ring.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from urllib import request as urlrequest

import numpy as np
import pytest

from horovod_tpu import telemetry as ref_tm
from horovod_tpu.common import message as ref_msg
from horovod_tpu.telemetry import flight as ref_flight
from horovod_tpu_torch import telemetry as port_tm
from horovod_tpu_torch.common import message as port_msg
from horovod_tpu_torch.telemetry import flight as port_flight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _updates(reg, seed: int) -> None:
    """A seeded mix of counters, gauges and histograms with labels,
    values from sub-microsecond to terabytes, zeros and negatives."""
    rng = np.random.default_rng(seed)
    planes = ("tcp", "shm", "basic")
    for i in range(300):
        kind = int(rng.integers(3))
        labels = {"plane": planes[int(rng.integers(3))],
                  "op": ("allreduce", "allgather")[int(rng.integers(2))]}
        if i % 7 == 0:
            labels = None
        value = float(rng.choice([0.0, -1.5, 1e-9, 3.25, 7e5, 1.3e12])
                      * rng.uniform(0.5, 2.0))
        if kind == 0:
            reg.counter("horovod_test_bytes_total", "Bytes moved",
                        labels=labels).inc(abs(value))
        elif kind == 1:
            reg.gauge("horovod_test_depth", "Queue depth",
                      labels=labels).set(value)
        else:
            reg.histogram("horovod_test_latency_ms", "Latency",
                          labels=labels).observe(value)
    reg.counter("horovod_test_plain_total").inc(3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_renders_the_reference_text_and_snapshot(seed):
    port, ref = port_tm.MetricsRegistry(rank=3), ref_tm.MetricsRegistry(3)
    _updates(port, seed)
    _updates(ref, seed)
    assert port.render_prometheus() == ref.render_prometheus()
    assert port.snapshot() == ref.snapshot()
    hp = port.histogram("horovod_test_latency_ms")
    hr = ref.histogram("horovod_test_latency_ms")
    for p in (0, 1, 50, 99, 100):
        assert hp.percentile(p) == hr.percentile(p)


def test_summary_is_the_reference_digest(monkeypatch):
    monkeypatch.setenv("HOROVOD_METRICS", "1")
    regs = port_tm.configure(1), ref_tm.configure(1)
    for reg in regs:
        reg.counter("horovod_tcp_bytes_sent_total",
                    labels={"mesh": "data0", "peer": "0"}).inc(4096)
        reg.counter("horovod_tcp_bytes_received_total",
                    labels={"mesh": "data0", "peer": "0"}).inc(2048)
        reg.counter("horovod_controller_cache_hit_total").inc(9)
        reg.counter("horovod_controller_cache_miss_total").inc(3)
        reg.counter("horovod_collective_bytes_total",
                    labels={"plane": "tcp", "op": "allreduce"}).inc(512)
        reg.counter("horovod_shm_staged_bytes_total").inc(64)
        for s, ms in (("0", 6.0), ("1", 2.0)):
            reg.counter("horovod_stream_busy_ms_total",
                        labels={"stream": s}).inc(ms)
    got = port_tm.summary()
    assert got == ref_tm.summary()
    assert got["cache_hit_rate"] == 0.75
    assert got["stream_utilization"] == {"0": 0.75, "1": 0.25}
    monkeypatch.setenv("HOROVOD_METRICS", "0")
    assert port_tm.configure(0) is port_tm.NULL_REGISTRY
    ref_tm.configure(0)
    assert port_tm.summary() == {} == ref_tm.summary()


def test_null_registry_is_inert():
    reg = port_tm.NULL_REGISTRY
    assert not reg.enabled and isinstance(reg, port_tm.NullRegistry)
    for make in (reg.counter, reg.gauge, reg.histogram):
        m = make("x", "help", labels={"a": "b"})
        assert m is port_tm.NULL_METRIC
        m.inc(5)
        m.set(3)
        m.observe(7)
        assert m.value == 0.0 and m.count == 0 and m.quantile(0.5) == 0.0
        assert m.percentile(99) == 0.0 and m.nonzero_buckets() == []
    assert reg.render_prometheus() == ""
    assert reg.snapshot() == ref_tm.NULL_REGISTRY.snapshot()


def _lists(msg, rng) -> list:
    return [msg.RequestList(tm_cycles=int(rng.integers(0, 5)),
                            tm_cycle_ms=float(rng.uniform(0, 9)),
                            tm_sync_wait_ms=float(rng.uniform(0, 3)),
                            tm_queue_depth=int(rng.integers(0, 7)))
            for _ in range(4)]


def test_straggler_aggregator_gives_the_reference_gauges():
    """Rank 2 arrives 8-12 ms late on every tensor: both aggregators
    name it each window, with the same lag statistics and per-rank
    snapshot gauges."""
    regs = port_tm.MetricsRegistry(0), ref_tm.MetricsRegistry(0)
    aggs = [mod.StragglerAggregator(4, reg, window=5, threshold_ms=5.0)
            for mod, reg in ((port_tm, regs[0]), (ref_tm, regs[1]))]
    rng = np.random.default_rng(4)
    for i in range(23):
        times = {r: 100.0 + i + float(rng.uniform(0, 0.002))
                 for r in range(4)}
        times[2] += float(rng.uniform(0.008, 0.012))
        if i % 6 == 5:
            times = {0: times[0]}          # one rank: not a skew sample
        for agg in aggs:
            agg.observe_tensor(dict(times))
        if i % 4 == 0:
            seed = int(rng.integers(1 << 30))
            aggs[0].observe_snapshots(
                _lists(port_msg, np.random.default_rng(seed)))
            aggs[1].observe_snapshots(
                _lists(ref_msg, np.random.default_rng(seed)))
    assert aggs[0].windows_completed == aggs[1].windows_completed == 4
    assert aggs[0].last_straggler == aggs[1].last_straggler == 2
    assert aggs[0].last_skew_ms == aggs[1].last_skew_ms
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].render_prometheus() == regs[1].render_prometheus()


def test_exporter_serves_closes_and_falls_back():
    reg = port_tm.MetricsRegistry(1)
    reg.counter("horovod_basic_ops_total", "ops").inc(2)
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    base = taken.getsockname()[1] - 1          # rank 1 wants the taken one
    before = {t.name for t in threading.enumerate()}
    ex = port_tm.MetricsExporter(reg, 1, base, bind="127.0.0.1")
    try:
        assert ex.port != base + 1 and ex.port > 0
        with urlrequest.urlopen(f"http://127.0.0.1:{ex.port}/metrics",
                                timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        assert body == reg.render_prometheus()
        assert "horovod_basic_ops_total 2\n" in body
        with pytest.raises(urlrequest.HTTPError) as err:
            urlrequest.urlopen(f"http://127.0.0.1:{ex.port}/nope",
                               timeout=10)
        assert err.value.code == 404
    finally:
        ex.close()
        taken.close()
    assert {t.name for t in threading.enumerate()} <= before
    with pytest.raises(OSError):
        urlrequest.urlopen(f"http://127.0.0.1:{ex.port}/metrics", timeout=2)


def test_exporter_close_reaps_its_request_threads(monkeypatch):
    """A request thread may still be finishing its response when the
    client has read it (the stdlib joins no daemon request thread):
    ``close`` must reap it, here made slow to exit on purpose."""
    from horovod_tpu_torch.telemetry import exporter
    finish = exporter._MetricsHandler.finish

    def slow_finish(self):
        time.sleep(1.5)
        finish(self)
    monkeypatch.setattr(exporter._MetricsHandler, "finish", slow_finish)
    reg = port_tm.MetricsRegistry(0)
    before = {t.name for t in threading.enumerate()}
    ex = port_tm.MetricsExporter(reg, 0, 0, bind="127.0.0.1")
    with urlrequest.urlopen(f"http://127.0.0.1:{ex.port}/metrics",
                            timeout=10) as r:
        assert r.read().decode() == reg.render_prometheus()
    t0 = time.monotonic()
    ex.close()
    assert time.monotonic() - t0 < 6.0
    assert {t.name for t in threading.enumerate()} <= before


@pytest.mark.parametrize("path", ["m.json", "metrics", "out/{rank}.json",
                                  "a.b/c", "/tmp/x.y.z"])
def test_dump_paths_and_json_are_the_reference(tmp_path, path):
    for rank in (0, 3):
        assert port_tm.resolve_dump_path(path, rank) == \
            ref_tm.resolve_dump_path(path, rank)
    regs = port_tm.MetricsRegistry(2), ref_tm.MetricsRegistry(2)
    outs = []
    for i, (mod, reg) in enumerate(((port_tm, regs[0]),
                                    (ref_tm, regs[1]))):
        _updates(reg, 5)
        d = tmp_path / str(i)
        d.mkdir()
        written = mod.dump_json(reg, str(d / "m.json"), 2)
        assert written == str(d / "m.r2.json")
        with open(written) as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


def _events(rec, n: int) -> None:
    for i in range(n):
        rec.record(("enqueue", "dispatch", "done", "error")[i % 4],
                   f"t{i % 13}", trace=f"{i}.{i % 3}" if i % 2 else None,
                   detail="x" * (i % 5))


def _timeless(payload) -> dict:
    payload = dict(payload)
    for key in ("dumped_wall_time", "dumped_monotonic"):
        assert isinstance(payload.pop(key), float)
    payload["events"] = [{k: v for k, v in e.items() if k != "ts"}
                         for e in payload["events"]]
    return payload


@pytest.mark.parametrize("capacity,n", [(16, 40), (2, 20), (256, 100)])
def test_flight_ring_is_the_reference(tmp_path, capacity, n):
    recs = [mod.FlightRecorder(1, capacity, str(tmp_path / f"f{i}.json"))
            for i, mod in enumerate((port_flight, ref_flight))]
    for rec in recs:
        _events(rec, n)
        rec.set_metadata(rank=1, size=4, clock_offset_us=12.5)
    snaps = [[{k: v for k, v in e.items() if k != "ts"}
              for e in rec.snapshot()] for rec in recs]
    assert snaps[0] == snaps[1]
    assert len(snaps[0]) == min(n, max(capacity, 8))
    assert snaps[0][-1]["name"] == f"t{(n - 1) % 13}"
    dumps = []
    for rec in recs:
        path = rec.dump(reason="fingerprint divergence")
        assert path == rec.path and rec.dumps == 1
        with open(path) as f:
            dumps.append(_timeless(json.load(f)))
    assert dumps[0] == dumps[1]
    assert not list(tmp_path.glob("*.tmp*"))
    bad = port_flight.FlightRecorder(0, 8, str(tmp_path / "no" / "x.json"))
    assert bad.dump() is None and bad.dumps == 0


_FLIGHT_OFF = """
import signal, threading
before = {t.name for t in threading.enumerate()}
from horovod_tpu_torch.telemetry import flight
rec = flight.configure(2)
assert rec is flight.NULL_FLIGHT and not rec.enabled
rec.record("enqueue", "x")
assert rec.snapshot() == [] and rec.dump("r") is None
assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
assert {t.name for t in threading.enumerate()} == before
print("OFF-OK")
"""

_FLIGHT_SIGTERM = """
import os, signal, sys
from horovod_tpu_torch.telemetry import flight
rec = flight.configure(2)
assert rec.enabled and signal.getsignal(signal.SIGTERM) is not \\
    signal.SIG_DFL
rec.record("dispatch", "grad.0", detail="allreduce x1 stream=0")
print(rec.path, flush=True)
os.kill(os.getpid(), signal.SIGTERM)
"""


def test_flight_off_leaves_no_handler_and_on_dumps_at_sigterm(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_FLIGHT="0",
               HOROVOD_FLIGHT_FILE=str(tmp_path / "flight.json"))
    out = subprocess.run([sys.executable, "-c", _FLIGHT_OFF], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "OFF-OK" in out.stdout, out.stderr
    env["HOROVOD_FLIGHT"] = "1"
    out = subprocess.run([sys.executable, "-c", _FLIGHT_SIGTERM], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -signal.SIGTERM, (out.returncode, out.stderr)
    path = out.stdout.strip()
    assert path == str(tmp_path / "flight.r2.json")
    with open(path) as f:
        dump = json.load(f)
    assert dump["rank"] == 2 and dump["reason"] == "SIGTERM"
    assert [(e["kind"], e["name"]) for e in dump["events"]] == [
        ("dispatch", "grad.0"), ("sigterm", "")]
