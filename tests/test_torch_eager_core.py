"""The eager core's single-process parts against the JAX package's: the
wire bytes of every message, the controller (tensor queue, response cache,
stall inspector, fusion) over ``LocalTransport`` fed the same sequence,
the timeline's events, the native kernels against their plain versions
and the reference's quantizer, a world of one, and the refusals."""
from __future__ import annotations

import json
import os
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.common import controller as jctl
from horovod_tpu.common import message as jmsg
from horovod_tpu.common import response_cache as jcache
from horovod_tpu.common import stall_inspector as jstall
from horovod_tpu.common import tensor_queue as jtq
from horovod_tpu.common import timeline as jtl
from horovod_tpu.common.dtypes import DataType as JDataType
from horovod_tpu.common.wire import FEATURES_ALL, proto_features
from horovod_tpu.compress import CompressionCodec
import importlib
from horovod_tpu_torch import native
from horovod_tpu_torch.common import controller as tctl
from horovod_tpu_torch.common import message as tmsg
from horovod_tpu_torch.common import response_cache as tcache
from horovod_tpu_torch.common import stall_inspector as tstall
from horovod_tpu_torch.common import tensor_queue as ttq
from horovod_tpu_torch.common import timeline as ttl
from horovod_tpu_torch.common.dtypes import DataType as TDataType

jquant = importlib.import_module("horovod_tpu.compress.quantize")
JAX = dict(msg=jmsg, ctl=jctl, cache=jcache, stall=jstall, tq=jtq, tl=jtl,
           dt=JDataType)
PORT = dict(msg=tmsg, ctl=tctl, cache=tcache, stall=tstall, tq=ttq, tl=ttl,
            dt=TDataType)


# --- wire ---------------------------------------------------------------------
def _requests(m, dt):
    R = m["msg"].Request
    T = m["msg"].RequestType
    return [R(request_rank=r % 3, request_type=t, tensor_type=dt(r % 11),
              tensor_name=f"t{r}.é", root_rank=r - 1, device=r % 2 - 1,
              tensor_shape=(r, 3, 1) if r % 2 else (), prescale_factor=0.5,
              postscale_factor=1.0 / 3.0, codec=r % 5,
              codec_block_size=64 * (r % 2), sp_spec="dp,None" * (r % 2))
            for r, t in enumerate(T)]


def _responses(m, dt):
    R = m["msg"].Response
    T = m["msg"].ResponseType
    return [R(response_type=t, tensor_names=[f"a{i}", "b"][:1 + i % 2],
              error_message="bad" * (t == T.ERROR), devices=[0, -1],
              tensor_sizes=[i, 2 * i + 1], tensor_type=dt(i % 11),
              prescale_factor=2.0, postscale_factor=0.125,
              last_joined_rank=i - 2, root_rank=i % 3, grouped=bool(i % 2),
              codec=i % 5, codec_block_size=32, trace_cycle=i,
              trace_seq=2 * i, sp_spec="tp" * (i % 2))
            for i, t in enumerate(T)]


def _lists(m):
    reqs = m["msg"].RequestList(
        requests=_requests(m, m["dt"]), shutdown=True, fp_seq=7,
        fp_digest=2 ** 63 + 5, fp_tail_seqs=[1, 2],
        fp_tail_digests=[3, 4], fp_tail_descs=["x", "y"], tm_cycles=3,
        tm_cycle_ms=1.5, tm_sync_wait_ms=0.25, tm_queue_depth=9)
    resps = m["msg"].ResponseList(
        responses=_responses(m, m["dt"]), shutdown=False,
        tuned_fusion_threshold=1 << 20, tuned_cycle_time_ms=2.5,
        tuned_codec=1, tuned_segment_bytes=4096, tuned_num_streams=2,
        tuned_fused=1, tuned_algo=2, tuned_tree_threshold=65536)
    return reqs, resps


@pytest.mark.parametrize("features", [FEATURES_ALL, proto_features(1),
                                      proto_features(2)],
                         ids=["proto3", "proto1", "proto2"])
def test_every_message_encodes_to_the_same_bytes(features):
    jreqs, jresps = _lists(JAX)
    treqs, tresps = _lists(PORT)
    assert treqs.to_bytes(features) == jreqs.to_bytes(features)
    assert tresps.to_bytes(features) == jresps.to_bytes(features)
    # Each package decodes the other's bytes to its own equal message.
    back = tmsg.RequestList.from_bytes(jreqs.to_bytes(features), features)
    assert back.to_bytes(features) == treqs.to_bytes(features)
    back = jmsg.ResponseList.from_bytes(tresps.to_bytes(features), features)
    assert back.to_bytes(features) == jresps.to_bytes(features)
    assert [r.tensor_names for r in back.responses] == \
        [r.tensor_names for r in tresps.responses]


# --- controller, queue, cache and stall inspector ---------------------------
def _tensor(side, shape, dtype="float32"):
    if side is PORT:
        return torch.zeros(shape, dtype=getattr(torch, dtype))
    return np.zeros(shape, dtype)


def _controller_transcript(side, monkeypatch, clock) -> list:
    """Drive one package's Controller over LocalTransport through a fixed
    sequence of submissions; record every cycle's responses, the cache's
    positions and the stall inspector's verdicts."""
    m = side
    tq = m["tq"].TensorQueue()
    cache = m["cache"].ResponseCache(4)
    stall = m["stall"].StallInspector()
    ctl = m["ctl"].Controller(rank=0, size=1,
                              transport=m["ctl"].LocalTransport(),
                              tensor_queue=tq, response_cache=cache,
                              stall_inspector=stall)
    R, T, D = m["msg"].Request, m["msg"].RequestType, m["dt"]
    out = []

    def submit(name, rtype=T.ALLREDUCE, shape=(8,), dtype=D.FLOAT32,
               root=-1, group=None):
        e = m["tq"].TensorTableEntry(tensor_name=name,
                                     tensor=_tensor(side, shape))
        r = R(request_rank=0, request_type=rtype, tensor_type=dtype,
              tensor_name=name, root_rank=root, tensor_shape=shape)
        out.append(("add", tq.add_to_tensor_queue(e, r).type.name))

    def cycle():
        rl = ctl.compute_response_list()
        out.append([(r.response_type.name, list(r.tensor_names),
                     list(r.tensor_sizes), r.tensor_type.name, r.grouped,
                     r.root_rank, r.error_message) for r in rl.responses])
        out.append(("cache", cache.positions(), cache.num_active_bits()))
        for r in rl.responses:
            for n in r.tensor_names:
                if tq.has_tensor_entry(n):
                    tq.pop_tensor_entry(n)

    for step in range(3):
        for i in range(5):                    # fused up to the threshold
            submit(f"g{i}", shape=(8 * (i + 1),))
        submit("h16", dtype=D.FLOAT16)
        submit("ag0", T.ALLGATHER, shape=(2, 3))
        submit("ag1", T.ALLGATHER, shape=(1, 3))
        submit("bc", T.BROADCAST, root=0)
        cycle()
    submit("g0")
    submit("g0")                              # duplicate name in flight
    cycle()
    ctl.group_table.register_group(["p", "q"])
    submit("p")
    cycle()                                   # the group waits for q
    submit("q", shape=(3,))
    cycle()
    for i in range(6):                        # evicts from a 4-entry cache
        submit(f"e{i}")
        cycle()
    # Stall inspector: a tensor only this rank submitted, past the
    # warning time, on a fake clock.
    stall.record_uncached_tensor("lonely", 0)
    clock[0] += 120.0
    out.append(("stall", stall.should_check(),
                stall.check_for_stalled_tensors(2)))
    return out


def test_controller_gives_the_reference_responses_and_cache_bits(
        monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "320")
    monkeypatch.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "100")
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    port = _controller_transcript(PORT, monkeypatch, clock)
    clock[0] = 1000.0
    ref = _controller_transcript(JAX, monkeypatch, clock)
    assert port == ref
    fused = [r for cyc in port if isinstance(cyc, list) for r in cyc
             if len(r[1]) > 1]
    assert fused, "the sequence must fuse some responses"


# --- timeline -----------------------------------------------------------------
def _timeline_events(side, path) -> list:
    tl = side["tl"].Timeline(str(path), mark_cycles=True, rank=0)
    tl.set_clock_sync(12.5, 3.0)
    T = side["msg"].RequestType
    for name in ("a", "b"):
        tl.queue_start(name)
        tl.negotiate_start(name, T.ALLREDUCE)
    tl.mark_cycle()
    for name in ("a", "b"):
        tl.negotiate_end(name, trace="1.0")
        tl.activity_start(name, "ALLREDUCE", stream=0, trace="1.0")
    entries = [side["tq"].TensorTableEntry(tensor_name=n) for n in "ab"]
    tl.activity_start_all(entries, "MEMCPY_IN_FUSION_BUFFER")
    tl.activity_end_all(entries)
    tl.counter("tensor_queue_depth", {"depth": 2})
    for name in ("a", "b"):
        tl.activity_end(name)
        tl.queue_end(name, trace="1.0")
    tl.stop()
    with open(path) as f:
        events = json.load(f)
    return [(e.get("name"), e.get("ph"), e.get("cat"),
             {k: v for k, v in (e.get("args") or {}).items()
              if k not in ("ts", "start_us")})
            for e in events]


def test_timeline_writes_the_reference_events(tmp_path):
    port = _timeline_events(PORT, tmp_path / "port.json")
    ref = _timeline_events(JAX, tmp_path / "ref.json")
    assert port == ref
    names = {e[0] for e in port}
    assert {"NEGOTIATE_ALLREDUCE", "ALLREDUCE",
            "MEMCPY_IN_FUSION_BUFFER"} <= names


# --- native kernels -------------------------------------------------------------
def _both(monkeypatch, fn):
    """fn() natively, then with the plain versions."""
    monkeypatch.delenv("HOROVOD_TPU_DISABLE_NATIVE", raising=False)
    a = fn()
    monkeypatch.setenv("HOROVOD_TPU_DISABLE_NATIVE", "1")
    b = fn()
    monkeypatch.delenv("HOROVOD_TPU_DISABLE_NATIVE")
    return a, b


def test_native_builds_into_the_build_dir():
    lib = native.load()
    assert native.loaded() and lib.hvd_abi_version() == 1
    assert os.path.exists(native.library_path())
    assert native.library_path().endswith(f"_{native.cpu_tag()}.so")


def test_native_build_failure_raises_with_the_compiler_output(
        monkeypatch, tmp_path):
    bad = tmp_path / "kernels.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed") as err:
        native.load()
    assert "error" in str(err.value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.uint8])
def test_pack_unpack_equal_plain(monkeypatch, dtype):
    g = torch.Generator().manual_seed(0)
    sizes = [5, 0, 17, 3]
    parts = [(torch.randn(n, generator=g) * 50).to(dtype) for n in sizes]
    parts[1] = None

    def run():
        out = native.pack(parts, sizes, torch.empty(sum(sizes),
                                                    dtype=dtype))
        outs = [torch.empty(n, dtype=dtype) for n in sizes]
        native.unpack(out, outs)
        return out, outs

    (a, a_outs), (b, b_outs) = _both(monkeypatch, run)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    for x, y in zip(a_outs, b_outs):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    assert torch.equal(a[5:22], parts[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scale_equals_plain(monkeypatch, dtype):
    x = torch.randn(1001, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64).to(dtype)
    a, b = _both(monkeypatch, lambda: native.scale_(x.clone(), 1.0 / 3.0))
    assert torch.equal(a, b)


@pytest.mark.parametrize("codec", [CompressionCodec.INT8,
                                   CompressionCodec.UINT4])
@pytest.mark.parametrize("n,block", [(1000, 64), (257, 32), (7, 256)])
def test_quantizer_equals_plain_and_the_reference(monkeypatch, codec, n,
                                                  block):
    """qencode/qdecode, natively and plain, against
    ``horovod_tpu/compress/quantize.py`` bitwise."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.uniform(0.1, 10)).astype(np.float32)
    x[n // 2] = x[n // 3]             # a repeated value, a flat-ish block
    pack4 = codec == CompressionCodec.UINT4
    levels = 16 if pack4 else 256
    ref_q = jquant.quantize(x, codec, block)
    ref_wire = jquant.to_bytes(ref_q)
    ref_out = jquant.dequantize(ref_q)
    acc0 = rng.standard_normal(n).astype(np.float32)

    def run():
        wire = torch.zeros(native.wire_nbytes(n, block, pack4),
                           dtype=torch.uint8)
        native.qencode(torch.from_numpy(x), block, levels, pack4, wire)
        dec = native.qdecode(wire, n, block, pack4,
                             torch.empty(n, dtype=torch.float32), False)
        acc = native.qdecode(wire, n, block, pack4,
                             torch.from_numpy(acc0.copy()), True)
        return wire.numpy().tobytes(), dec.numpy(), acc.numpy()

    (wa, da, aa), (wb, db, ab) = _both(monkeypatch, run)
    assert wa == wb == ref_wire
    assert da.tobytes() == db.tobytes() == ref_out.tobytes()
    want_acc = acc0 + ref_out
    assert aa.tobytes() == ab.tobytes() == want_acc.tobytes()


def test_adasum_helpers_equal_plain(monkeypatch):
    g = torch.Generator().manual_seed(2)
    a = torch.randn(333, generator=g, dtype=torch.float64)
    b = torch.randn(333, generator=g, dtype=torch.float64)
    (na, nb) = _both(monkeypatch, lambda: native.dot_norms(a, b))
    assert na == nb
    sa, sb = _both(monkeypatch,
                   lambda: native.scaled_add_(a.clone(), b, 0.75, -1.25))
    assert torch.equal(sa, sb)


def _ring_allreduce_threads(xs: list[torch.Tensor], use_native: bool):
    """Run TcpCollectives.allreduce in one thread per rank over an
    in-process rendezvous; returns each rank's result and whether the
    native ring ran."""
    from horovod_tpu_torch.backend.tcp import TcpCollectives
    from horovod_tpu_torch.runner.network import (PeerMesh,
                                                  RendezvousClient,
                                                  RendezvousServer)
    size = len(xs)
    server = RendezvousServer()
    port = server.start()
    results: list = [None] * size
    errors: list = []
    scope = f"ring{use_native}{time.time_ns()}"

    def rank_main(r):
        try:
            kv = RendezvousClient("127.0.0.1", port, 30.0)
            mesh = PeerMesh(r, size, kv, scope=scope, timeout=30.0)
            coll = TcpCollectives(mesh, algo="ring")
            results[r] = (coll.allreduce(xs[r]), coll.last_native)
            mesh.close()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    server.stop()
    assert not errors, errors
    return results


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int64, torch.bfloat16])
def test_ring_allreduce_equals_the_python_ring(monkeypatch, dtype):
    """The native ring over socket fds against the plain version (the
    Python ring of backend/tcp.py), 3 ranks, uneven chunks: bitwise."""
    g = torch.Generator().manual_seed(3)
    xs = [(torch.randn(1001, generator=g) * 100).to(dtype)
          for _ in range(3)]
    monkeypatch.delenv("HOROVOD_TPU_DISABLE_NATIVE", raising=False)
    nat = _ring_allreduce_threads(xs, True)
    monkeypatch.setenv("HOROVOD_TPU_DISABLE_NATIVE", "1")
    plain = _ring_allreduce_threads(xs, False)
    for (a, ran_native), (b, ran_plain) in zip(nat, plain):
        assert ran_native and not ran_plain
        assert torch.equal(a, b)
        assert a.dtype == dtype
    assert torch.equal(nat[0][0], nat[2][0])


# --- a world of one and the refusals -------------------------------------------
@pytest.fixture
def solo(monkeypatch):
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    hvd.init()
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32", "uint8", "bool"])
def test_world_of_one_returns_each_input(solo, dtype):
    """BasicBackend: every collective hands back its input (scaled by the
    factors, as the JAX package's world of one does)."""
    x = torch.arange(12).reshape(3, 4) % 5
    x = x.to(getattr(torch, dtype))
    assert solo.size() == 1 and solo.rank() == 0
    for out in (solo.allreduce(x, op=solo.Sum, name="ar"),
                solo.allreduce(x, name="avg"),
                solo.allgather(x, name="ag"),
                solo.broadcast(x, 0, name="bc"),
                solo.reducescatter(x, op=solo.Sum, name="rs"),
                solo.synchronize(solo.allreduce_async(x, op=solo.Sum,
                                                      name="as")),
                solo.alltoall(x, name="a2a")):
        assert out.dtype == x.dtype and torch.equal(out, x)
        assert out.data_ptr() != x.data_ptr()
    outs = solo.grouped_allreduce([x, x[:1]], op=solo.Sum, name="g")
    assert torch.equal(outs[0], x) and torch.equal(outs[1], x[:1])
    rows, splits = solo.alltoall(x, splits=[3], name="a2a_s")
    assert torch.equal(rows, x) and splits.tolist() == [3]
    if dtype == "float32":
        want = torch.from_numpy(np.asarray(x.numpy() * np.float32(2.5)))
        assert torch.equal(solo.allreduce(x, op=solo.Sum, name="pre",
                                          prescale_factor=2.5), want)
    h = solo.allreduce_async(x, op=solo.Sum, name="poll")
    solo.synchronize(h)
    assert solo.poll(h)
    solo.barrier()
    assert solo.join() == 0
    assert solo.broadcast_object({"k": [1]}) == {"k": [1]}
    assert solo.allgather_object(3) == [3]


def test_world_of_one_scales_integers_like_the_reference(solo):
    """Average of int64 in a world of one multiplies by the float64 factor
    and truncates, as numpy does (torch alone would go through float32)."""
    x = torch.tensor([2 ** 40 + 3, -(2 ** 35) - 1, 7], dtype=torch.int64)
    got = solo.allreduce(x, op=solo.Sum, name="i64",
                         postscale_factor=1.0 / 3.0)
    want = (x.numpy() * (1.0 / 3.0)).astype(np.int64)
    assert got.numpy().tolist() == want.tolist()
    b = torch.tensor([1.5, 2.25, -3.0], dtype=torch.bfloat16)
    got = solo.allreduce(b, op=solo.Sum, name="b16", prescale_factor=0.1)
    ref = (np.asarray([1.5, 2.25, -3.0], ml_dtypes.bfloat16)
           .astype(np.float32) * 0.1).astype(ml_dtypes.bfloat16)
    assert got.view(torch.int16).numpy().tobytes() == \
        ref.view(np.int16).tobytes()


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_SAN", "1"),
    ("HOROVOD_ELASTIC", "1"),
    ("HOROVOD_XLA_OPERATIONS", "1"),
])
def test_unported_knobs_raise(monkeypatch, knob, value):
    monkeypatch.setenv(knob, value)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item"):
        hvd.init()
    assert not hvd.is_initialized()


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_FAULT_TOLERANCE", "1"),
    ("HOROVOD_CHAOS", "fail:op=0,count=1"),
])
def test_failure_knobs_are_live(monkeypatch, knob, value):
    """The fault-tolerance knobs the port once refused now init.  In a
    world of one, fault tolerance forms no monitor (as in the
    reference); a chaos ``fail`` turns the first collective into the
    structured error and the next runs clean from the response cache."""
    from horovod_tpu_torch import core, resilience
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(knob, value)
    hvd.init()
    try:
        if knob == "HOROVOD_CHAOS":
            assert core.global_state().chaos is resilience.chaos.active()
            with pytest.raises(hvd.HorovodInternalError, match="chaos"):
                hvd.allreduce(torch.ones(4), op=hvd.Sum, name="cf")
        else:
            assert resilience.active_state() is None
        for _ in range(3):
            out = hvd.allreduce(torch.ones(4), op=hvd.Sum, name="cf")
            assert out.tolist() == [1.0] * 4
    finally:
        hvd.shutdown()
        monkeypatch.delenv(knob)
        resilience.chaos.configure(0)


_STREAMS_RANK = """
import sys, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import core
hvd.init()
st = core.global_state()
out = hvd.allreduce(torch.ones(3), op=hvd.Sum, name="s")
print(st.stream_dispatcher is not None, st.stream_dispatcher.num_streams,
      len(st.op_managers), st.active_streams, out.tolist())
hvd.shutdown()
"""


def _streams_world_of_two() -> list[str]:
    """Two ranks at HOROVOD_NUM_STREAMS=2 (a world of one has no
    dispatcher, in the reference too); each prints what it formed."""
    import subprocess
    import sys

    from horovod_tpu_torch.runner.network import RendezvousServer
    server = RendezvousServer()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(HOROVOD_SIZE="2", HOROVOD_NUM_STREAMS="2",
               HOROVOD_SHM_OPERATIONS="0",
               HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
               HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
               HOROVOD_RENDEZVOUS_EPOCH=f"streams{time.time_ns()}",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(__file__)),
                    env.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _STREAMS_RANK],
                              env=dict(env, HOROVOD_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    assert all(p.returncode == 0 for p in procs), outs
    return [o.strip().splitlines()[-1] for o in outs]


@pytest.mark.parametrize("knob,value", [
    ("HOROVOD_NUM_STREAMS", "2"),
    ("HOROVOD_AUTOTUNE", "1"),
    ("HOROVOD_FINGERPRINT", "cycle"),
    ("HOROVOD_METRICS", "on"),
    ("HOROVOD_METRICS_PORT", "0"),
    ("HOROVOD_FLIGHT", "1"),
])
def test_runtime_knobs_are_live(monkeypatch, knob, value):
    """Each runtime knob the port once refused now inits, runs an
    allreduce and shows its feature working: a stream dispatcher, an
    active autotuner, a folding fingerprint tracker, a recording metrics
    registry, a bound exporter that answers a scrape, a recording flight
    ring."""
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if knob == "HOROVOD_NUM_STREAMS":
        for line in _streams_world_of_two():
            assert line == "True 2 2 2 [2.0, 2.0, 2.0]", line
        return
    from horovod_tpu_torch import core, telemetry
    if knob == "HOROVOD_METRICS_PORT":
        # The exporter serves when the registry records: a free port.
        from horovod_tpu_torch.runner.network import free_port
        value = str(free_port())
        monkeypatch.setenv("HOROVOD_METRICS", "1")
    monkeypatch.setenv(knob, value)
    hvd.init()
    try:
        st = core.global_state()
        out = hvd.allreduce(torch.arange(4.0), op=hvd.Sum, name="live")
        assert out.tolist() == [0.0, 1.0, 2.0, 3.0]
        if knob == "HOROVOD_AUTOTUNE":
            pm = st.parameter_manager
            assert pm is not None and pm._active and not pm._done
            assert pm._steps >= 1 or pm._warmup_left < 3
        elif knob == "HOROVOD_FINGERPRINT":
            fp = st.controller.fingerprint
            assert fp.enabled and not fp.strict and fp.seq == 1
            assert fp.snapshot()[2][0].descriptor == \
                "ALLREDUCE|live|FLOAT32|4|0/0"
        elif knob == "HOROVOD_METRICS":
            assert st.telemetry.enabled and telemetry.metrics() is \
                st.telemetry
            snap = {(m["name"], tuple(sorted(m["labels"].items()))): m
                    for m in st.telemetry.snapshot()["metrics"]}
            assert snap[("horovod_basic_ops_total", ())]["value"] == 1.0
            key = ("horovod_collective_bytes_total",
                   (("op", "allreduce"), ("plane", "basic")))
            assert snap[key]["value"] == 16.0
        elif knob == "HOROVOD_METRICS_PORT":
            from urllib import request as urlrequest
            from horovod_tpu_torch.telemetry import MetricsExporter
            ex = next(r for r in st.resources
                      if isinstance(r, MetricsExporter))
            assert ex.port == int(value)
            with urlrequest.urlopen(
                    f"http://127.0.0.1:{ex.port}/metrics", timeout=10) as r:
                text = r.read().decode()
            assert "horovod_basic_ops_total 1\n" in text
        else:
            kinds = [(e["kind"], e["name"])
                     for e in st.flight.snapshot()]
            assert st.flight.enabled
            assert kinds[-3:] == [("enqueue", "live"), ("dispatch", "live"),
                                  ("done", "live")]
    finally:
        hvd.shutdown()
    if knob == "HOROVOD_METRICS_PORT":
        assert not any(t.name == "hvd-metrics"
                       for t in threading.enumerate())


def test_defaults_of_unported_knobs_do_not_raise(monkeypatch, solo):
    for knob, value in (("HOROVOD_NUM_STREAMS", "1"),
                        ("HOROVOD_COMPRESSION", "none"),
                        ("HOROVOD_FINGERPRINT", "off"),
                        ("HOROVOD_FLIGHT", "0")):
        monkeypatch.setenv(knob, value)
    hvd.shutdown()
    hvd.init()
    assert hvd.allreduce(torch.ones(2), op=hvd.Sum).tolist() == [1.0, 1.0]


def test_unported_calls_raise(solo):
    x = torch.ones(3)
    # Adasum and the wire codecs are ported: at one rank they return the
    # input, as the reference's basic plane does.
    assert solo.allreduce(x, op=solo.Adasum).tolist() == [1.0] * 3
    assert solo.allreduce(x, compression="int8").tolist() == [1.0] * 3
    for call in (lambda: solo.allreduce(x, op=solo.Min),
                 lambda: solo.allreduce(x, op=solo.Max),
                 lambda: solo.run(print),
                 lambda: hvd.core.reinit_world(rank=0, size=1, epoch="1")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    from horovod_tpu_torch.runner.network import RendezvousServer
    with pytest.raises(NotImplementedError, match="item 12"):
        RendezvousServer(wal_dir="/nonexistent")
    with pytest.raises(TypeError):
        solo.allreduce(np.ones(3))
    assert not solo.nccl_built() and solo.tcp_built() and solo.gloo_built()


def test_rendezvous_kv_matches_the_reference():
    """The port's KV server answers the reference's client, and the
    reference's server the port's, with the same digests."""
    from horovod_tpu.runner.network import RendezvousClient as JClient
    from horovod_tpu.runner.network import RendezvousServer as JServer
    from horovod_tpu_torch.runner.network import (RendezvousClient,
                                                  RendezvousServer)
    digests = []
    for server_cls, client_cls in ((RendezvousServer, JClient),
                                   (JServer, RendezvousClient)):
        server = server_cls()
        port = server.start()
        kv = client_cls("127.0.0.1", port, 10.0)
        kv.put("s", "a", b"1")
        kv.put_many([("s", "b", b"2"), ("t", "c", b"3")])
        assert kv.claim("s", "n", "task0") == 0
        assert kv.claim("s", "n", "task1") == 1
        assert kv.claim("s", "n", "task0") == 0
        assert kv.wait("s", "b", 5.0) == b"2"
        assert kv.get_scope("s") == {"a": b"1", "b": b"2"}
        kv.delete("t")
        assert kv.get("t", "c") is None
        digests.append(server.kv_digest())
        server.stop()
    assert digests[0] == digests[1]


def test_peer_sockets_interoperate_with_the_reference():
    """A port PeerMesh and a reference PeerMesh form one 2-rank mesh
    (the same HELLO and framing) and exchange frames."""
    from horovod_tpu.runner.network import PeerMesh as JMesh
    from horovod_tpu.runner.network import RendezvousClient as JClient
    from horovod_tpu_torch.runner.network import (PeerMesh,
                                                  RendezvousClient,
                                                  RendezvousServer)
    server = RendezvousServer()
    port = server.start()
    got: dict = {}

    def side(rank, mesh_cls, client_cls):
        mesh = mesh_cls(rank, 2, client_cls("127.0.0.1", port, 10.0),
                        scope="mix", timeout=10.0)
        mesh.send(1 - rank, f"from {rank}".encode())
        got[rank] = bytes(mesh.recv(1 - rank))
        got[f"proto{rank}"] = (mesh.negotiated_proto,
                               mesh.negotiated_features)
        mesh.close()

    threads = [threading.Thread(target=side, args=(0, PeerMesh,
                                                   RendezvousClient)),
               threading.Thread(target=side, args=(1, JMesh, JClient))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    server.stop()
    assert got[0] == b"from 1" and got[1] == b"from 0"
    assert got["proto0"] == got["proto1"]
