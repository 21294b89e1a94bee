"""The eager core's runtime features in 2- and 4-rank worlds: the port
against the JAX package on the CPU.

Per world size a port world and a JAX world run at once (each against
its own package's ``RendezvousServer``), both through
``tests/torch_runtime_battery.py``'s phases: dispatch streams
(``HOROVOD_NUM_STREAMS=3`` on the ring), metrics (``HOROVOD_METRICS=1``
with a file dump), a fingerprint divergence under ``strict`` (one name,
two shapes) and under ``cycle`` (two names), and the autotuner (the
pipeline, fused and algorithm sweeps and three Bayesian samples).

- Outputs and errors (type and text) are equal byte for byte, but for
  the 4-rank autotune phase: there the tuned fusion and algorithm change
  the order of the fp32 sums from run to run, in either package, so each
  output is held to numpy's float64 sum within ``AUTOTUNE_TOL`` x the
  sum of the inputs' magnitudes (a few fp32 roundings of four terms).
- Metric names, label sets and byte counters are equal; latencies are
  not compared.
- Every rank applies the same tuned values on the same cycle.
- A device-plane response stays on stream 0 at ``HOROVOD_NUM_STREAMS=2``
  (``tests/torch_device_plane_worker.py streams``, over gloo).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_reduce_battery as battery  # noqa: E402
import torch_runtime_battery as runtime  # noqa: E402

from horovod_tpu_torch.runner.network import RendezvousServer  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
# 8 fp32 roundings of a magnitude-sized partial sum.
AUTOTUNE_TOL = 8 * 2.0 ** -24


def _decode(rec: tuple) -> np.ndarray:
    dtype, shape, raw = rec
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


@pytest.fixture(scope="module", params=[2, 4], ids=["2rank", "4rank"])
def worlds(request, tmp_path_factory):
    """rank -> (port records, JAX records) of one world size; the two
    packages' worlds run at once."""
    size = request.param
    outdir = str(tmp_path_factory.mktemp(f"runtime{size}"))
    failures: list[str] = []
    threads = [threading.Thread(target=battery._run_world,
                                args=(side, "runtime", size, outdir,
                                      failures))
               for side in ("port", "ref")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, "\n".join(failures)
    recs = {}
    for r in range(size):
        pair = []
        for side in ("port", "ref"):
            with open(os.path.join(outdir, f"{side}_{r}.pkl"), "rb") as f:
                pair.append(pickle.load(f))
        recs[r] = tuple(pair)
    return size, recs


@pytest.mark.parametrize("phase", ["streams", "metrics", "fp_strict",
                                   "fp_cycle"])
def test_phase_equals_the_reference(worlds, phase):
    _, recs = worlds
    battery.assert_phase_equal(recs, phase, skip=runtime.TIMED)


def test_streams_spread_a_cycle_over_the_streams(worlds):
    size, recs = worlds
    for side in (0, 1):
        stream_bytes = [0, 0, 0]
        for rank in range(size):
            r = recs[rank][side]
            assert r["streams/dispatcher"] == ("streams", True, 3, 3, 3)
            assert r["streams/planes"] == ("planes", ["tcp", "basic"])
            for k, b in enumerate(r["streams/stream_bytes"][1]):
                stream_bytes[k] += b
            labels = set(r["streams/metric_stream_labels"][1])
            assert labels <= {"0", "1", "2"} and "0" in labels
            # No thread a cycle: only lazy sender lanes may start.
            assert r["streams/spawned"] == ("threads", [])
        # Responses of one cycle rode streams 1 and 2 too.
        assert stream_bytes[0] > 0 and stream_bytes[1] + stream_bytes[2] > 0


def test_metrics_count_the_payload(worlds):
    """The collective byte counters are the payloads' bytes, the dump
    holds every metric, and the names include the runtime's own."""
    size, recs = worlds
    for rank in range(size):
        port = recs[rank][0]
        counters = {(n, lab): v for n, lab, v in
                    port["metrics/byte_counters"][1]}
        ar = counters[("horovod_collective_bytes_total",
                       (("op", "allreduce"), ("plane", "tcp")))]
        assert ar == 2 * (4096 * 4 + 1000 * 4)
        names = dict(port["metrics/metric_names"][1])
        assert port["metrics/dump"] == ("dump", rank, sorted(names))
        for name in ("horovod_controller_cycle_ms",
                     "horovod_collective_busbw_mbps",
                     "horovod_tcp_send_queue_depth",
                     "horovod_rendezvous_kv_latency_ms",
                     "horovod_tcp_codec_leg_ms"):
            assert name in names, name
        if rank == 0:
            assert "horovod_controller_negotiation_lag_ms" in names
            assert ("horovod_rank_cycle_ms" in names) == (size > 1)


@pytest.mark.parametrize("phase", ["fp_strict", "fp_cycle"])
def test_divergence_is_structured_on_every_rank(worlds, phase):
    size, recs = worlds
    for rank in range(size):
        for side in (0, 1):
            r = recs[rank][side]
            kind, exc, text = r[f"{phase}/diverged"]
            assert kind == "error" and exc == "HorovodInternalError"
            assert text.startswith("Collective fingerprint divergence at "
                                   "op #"), text
            assert r[f"{phase}/after"][0] == "float32"
            _, enabled, dumps, dumped = r[f"{phase}/flight"]
            assert enabled
            if rank == 0:
                # The coordinator dumps the ring; its tail names the op.
                assert dumps == 1
                assert dumped[:3] == (0, text, "fingerprint-divergence")
                assert dumped[3] == text[:200] and dumped[4]
            else:
                assert dumps == 0 and dumped is None


def test_autotune_converges_alike_on_every_rank(worlds):
    size, recs = worlds
    for side in (0, 1):
        tuned = [recs[r][side]["autotune/tuned"] for r in range(size)]
        assert all(t == tuned[0] for t in tuned), tuned
        # The same tuned values reach every rank on the same cycle.
        applied = [recs[r][side]["autotune/applied"] for r in range(size)]
        assert all(a == applied[0] for a in applied), applied
        assert len(applied[0][1]) >= 10
        applied = tuned[0][1]
        assert applied["active_streams"] in (1, 2)
        assert len(set(applied["segment_bytes"])) == 1
        assert applied["algo"][0] in ("ring", "auto")
        assert 1.0 <= applied["cycle_time_ms"] <= 25.0
        assert (1 << 20) <= applied["fusion_threshold"] <= (1 << 28)
        assert recs[0][side]["autotune/tuner"] == ("tuner", True, True,
                                                   True)
        for r in range(1, size):
            assert recs[r][side]["autotune/tuner"] == ("tuner", True, False,
                                                       False)
        _, header, events = recs[0][side]["autotune/autotune_log"]
        assert header == "timestamp,fusion_threshold,cycle_time_ms," \
                         "score,event"
        for prefix in ("pipeline-winner-", "fused-winner-",
                       "algo-winner-", "converged"):
            assert any(e.startswith(prefix) for e in events), prefix


def test_autotune_outputs(worlds):
    """2 ranks: the outputs are the JAX world's bit for bit (a sum of two
    is the same in any order).  4 ranks: both packages within
    AUTOTUNE_TOL of numpy."""
    size, recs = worlds
    if size == 2:
        battery.assert_phase_equal(recs, "autotune", skip=runtime.TIMED)
        return
    inputs = {k: [battery.draw(f"at{k}", r, runtime.AUTOTUNE_N)
                  .astype(np.float32).astype(np.float64)
                  for r in range(size)] for k in range(8)}
    for rank in range(size):
        for side in (0, 1):
            r = recs[rank][side]
            for i in range(runtime.AUTOTUNE_OPS):
                xs = inputs[i % 8]
                got = _decode(r[f"autotune/at{i}"]).astype(np.float64)
                want = np.sum(xs, axis=0)
                bound = AUTOTUNE_TOL * np.sum(np.abs(xs), axis=0)
                assert np.all(np.abs(got - want) <= bound), (rank, side, i)


def test_device_responses_stay_on_stream_zero(tmp_path):
    """The device plane (over gloo) at HOROVOD_NUM_STREAMS=2: its
    responses run only on the background thread or stream 0's worker,
    while the TCP plane's spread over both streams."""
    size = 2
    server = RendezvousServer()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "torch_device_plane_worker.py"),
         str(r), str(size), str(port), str(tmp_path), "streams"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    assert all(p.returncode == 0 for p in procs), outs
    host_threads = set()
    for r in range(size):
        with open(tmp_path / f"streams_{r}.pkl", "rb") as f:
            rec = pickle.load(f)
        _, device, host = rec["streams/threads"]
        assert device and set(device) <= {"hvd-background", "hvd-stream-0"}
        host_threads |= set(host)
        assert rec["streams/plane"] == ("plane", False, 2)
    assert host_threads <= {"hvd-background", "hvd-stream-0",
                            "hvd-stream-1"}
    assert "hvd-stream-1" in host_threads
