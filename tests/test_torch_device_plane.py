"""The device plane (``backend/nccl.py``) over a gloo group, in 2- and
4-rank worlds on the CPU, and its routing and refusals in the core.

``tests/torch_device_plane_worker.py`` forms each world's process group
through ``parallel.multihost`` with gloo in place of NCCL, drives
``NcclBackend`` on CPU tensors standing in for CUDA ones, and then runs
the same collectives on the same inputs through the TCP ring.  Every
operation and dtype is held against numpy and against the TCP plane:
integers exactly (16-bit integers and bool, which NCCL lacks, reduce in
int32 and come back with numpy's wrapping and logical-or sums), floats
exactly at 2 ranks, where a sum of two adds commutatively; at 4 ranks
the ranks add in another order, so fp32 within 4·2⁻²⁴·Σ|x| (fp64 within
4·2⁻⁵³·Σ|x|) of the exact sum, and 16-bit floats within one ulp of the
fp32 sum in rank order, rounded once.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu_torch.backend.base import (CollectiveBackend, byte_view,
                                            dim0_row_bounds,
                                            is_device_response)
from horovod_tpu_torch.common.dtypes import DataType
from horovod_tpu_torch.common.message import (Request, RequestType,
                                              Response, ResponseType)
from horovod_tpu_torch.runner.network import RendezvousServer

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
import torch_device_plane_worker as W  # noqa: E402
from torch_sigterm import restore_sigterm  # noqa: F401

WORLD_TIMEOUT = 120.0
HALF = ("float16", "bfloat16")
EPS = {"float32": 2.0 ** -24, "float64": 2.0 ** -53}


def _run_world(size: int, outdir: str, failures: list) -> None:
    server = RendezvousServer()
    port = server.start()
    env = dict(os.environ)
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_FUSION_THRESHOLD",
                "HOROVOD_NCCL_OPERATIONS"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "torch_device_plane_worker.py"),
         str(r), str(size), str(port), outdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=WORLD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failures.append(f"rank {r} of {size}: timeout")
            if p.returncode != 0:
                failures.append(f"rank {r} of {size} rc={p.returncode}:\n"
                                + out.decode(errors="replace")[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()


@pytest.fixture(scope="module")
def all_worlds(tmp_path_factory):
    """size -> rank -> records; both worlds run at once."""
    outdir = {size: str(tmp_path_factory.mktemp(f"plane{size}"))
              for size in (2, 4)}
    failures: list[str] = []
    threads = [threading.Thread(target=_run_world,
                                args=(size, outdir[size], failures))
               for size in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, "\n".join(failures)
    recs = {}
    for size in (2, 4):
        recs[size] = {}
        for r in range(size):
            with open(os.path.join(outdir[size], f"plane_{r}.pkl"),
                      "rb") as f:
                recs[size][r] = pickle.load(f)
    return recs


@pytest.fixture(params=[2, 4], ids=["2rank", "4rank"])
def world(request, all_worlds):
    return request.param, all_worlds[request.param]


# --- numpy's result of each case ---------------------------------------------
def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy() \
            .view(ml_dtypes.bfloat16)
    return t.contiguous().numpy()


def _from_record(rec: tuple) -> np.ndarray:
    name, shape, raw = rec
    dt = ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)
    return np.frombuffer(raw, dtype=dt).reshape(shape)


def _scale(x: np.ndarray, f: float, dt: str) -> np.ndarray:
    """The reference's scale: 16-bit floats in fp32 rounded once,
    integers by the float64 factor truncated, bool and-ed."""
    if f == 1.0:
        return x
    if dt == "bool":
        return x & bool(f)
    if dt in HALF:
        return (x.astype(np.float32) * np.float32(f)).astype(x.dtype)
    if x.dtype.kind in "iu":
        return (x.astype(np.float64) * f).astype(x.dtype)
    return x * x.dtype.type(f)


def _sum(xs: list[np.ndarray], dt: str) -> np.ndarray:
    """numpy's sum in rank order: wrapping integers, logical-or bools,
    16-bit floats in fp32 rounded once."""
    if dt == "bool":
        return np.logical_or.reduce(xs)
    wide = [x.astype(np.float32) for x in xs] if dt in HALF else xs
    acc = wide[0].copy()
    with np.errstate(over="ignore"):
        for x in wide[1:]:
            acc = acc + x
    return acc.astype(xs[0].dtype)


def _reduce(case, size: int, rank_inputs, pick=lambda a: a):
    """(numpy's result, fp64 exact result, Σ|x|) of a sum-type case."""
    dt = case[2]
    pre, post = W.factors(case, size)
    xs = [_scale(_np(rank_inputs(r)), pre, dt) for r in range(size)]
    want = pick(_scale(_sum(xs, dt), post, dt))
    exact = pick(np.sum([x.astype(np.float64) for x in xs], axis=0) * post) \
        if dt not in ("bool",) else None
    mag = pick(np.sum([np.abs(x.astype(np.float64)) for x in xs], axis=0)
               * abs(post)) if dt != "bool" else None
    return want, exact, mag


def _expected(case, rank: int, size: int) -> list[tuple]:
    """Per entry of the case: (numpy's result, exact, Σ|x|), where the
    last two are None for data movement."""
    name, op, dt, _ = case
    ins = {r: W.case_inputs(case, r, size) for r in range(size)}
    if op in ("allreduce", "allreduce_fused"):
        return [_reduce(case, size, lambda r, i=i: ins[r][i])
                for i in range(len(ins[rank]))]
    if op.startswith("reducescatter"):
        n = ins[rank][0].shape[0]
        b = dim0_row_bounds(n, size)
        return [_reduce(case, size, lambda r: ins[r][0],
                        pick=lambda a: a[b[rank]:b[rank + 1]])]
    if op.startswith("allgather"):
        return [(np.concatenate([_np(ins[r][i]) for r in range(size)]),
                 None, None) for i in range(len(ins[rank]))]
    if op == "broadcast":
        return [(_np(ins[size - 1][0]), None, None)]
    # alltoall: the rows every rank sent to this one, in rank order.
    rows = []
    for r in range(size):
        sp = W.splits(r, size)
        lo = sum(sp[:rank])
        rows.append(_np(ins[r][0])[lo:lo + sp[rank]])
    return [(np.concatenate(rows), None, None)]


def _ulp16(x: np.ndarray, dt: str) -> np.ndarray:
    a = np.abs(x.astype(np.float64))
    if dt == "float16":
        return np.spacing(a.astype(np.float16)).astype(np.float64)
    e = np.floor(np.log2(np.maximum(a, 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _check(got: np.ndarray, want, exact, mag, dt: str, size: int,
           what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    if exact is None or size == 2 or dt not in ("float16", "bfloat16",
                                                "float32", "float64"):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    g = got.astype(np.float64)
    if dt in HALF:
        bound = _ulp16(want, dt)
        err = np.abs(g - want.astype(np.float64))
    else:
        bound = 4 * EPS[dt] * mag
        err = np.abs(g - exact)
    assert (err <= bound).all(), (what, float(err.max()))


@pytest.mark.parametrize("dtype", W.DTYPES)
def test_plane_equals_numpy(world, dtype):
    size, recs = world
    for case in W.cases(size):
        if case[2] != dtype:
            continue
        for rank in range(size):
            got = recs[rank][f"plane/{case[0]}"]
            want = _expected(case, rank, size)
            assert len(got) == len(want), case[0]
            for i, (g, (w, exact, mag)) in enumerate(zip(got, want)):
                _check(_from_record(g), w, exact, mag, dtype, size,
                       f"{case[0]}[{i}] rank {rank}")
            if case[1] == "alltoall":
                assert recs[rank][f"plane/{case[0]}/recv"][1] == \
                    [W.splits(r, size)[rank] for r in range(size)]


@pytest.mark.parametrize("dtype", W.DTYPES)
def test_plane_equals_the_tcp_plane(world, dtype):
    """Exact where the sum is order-free; else both within the bounds of
    the exact sum (test_plane_equals_numpy holds the plane to them, and
    this the TCP plane)."""
    size, recs = world
    for case in W.cases(size):
        if case[2] != dtype:
            continue
        for rank in range(size):
            plane = recs[rank][f"plane/{case[0]}"]
            tcp = recs[rank][f"tcp/{case[0]}"]
            order_free = size == 2 or dtype not in (
                "float16", "bfloat16", "float32", "float64") or \
                not case[1].startswith(("allreduce", "reducescatter"))
            if order_free:
                assert plane == tcp, (case[0], rank)
                continue
            want = _expected(case, rank, size)
            for g, (w, exact, mag) in zip(tcp, want):
                _check(_from_record(g), w, exact, mag, dtype, size,
                       f"tcp {case[0]} rank {rank}")


def test_routing_and_refusals(world):
    size, recs = world
    for rank in range(size):
        r = recs[rank]
        assert r["plane/size"] == ("int", size)
        # CPU response, a joined rank in a CPU world, a barrier: none is
        # the device plane's.
        assert r["plane/routing"] == ("routing", [False, False, False])
        assert r["tcp/planes"] == ("planes", ["tcp", "basic"])
        kind, exc, msg = r["refuse/mixed"]
        assert exc == "HorovodInternalError" and \
            "Mismatched CPU/GPU device selection" in msg, msg
        kind, exc, msg = r["refuse/cuda_no_plane"]
        assert exc == "HorovodInternalError" and "No enabled backend" in msg
        assert r["refuse/check_mine"][1] == "RuntimeError"
        assert "device plane" in r["refuse/check_mine"][2]
        assert r["refuse/check_other"][1] == "ValueError"
        # The world survives every refusal.
        assert _from_record(r["refuse/after"]).tolist() == [size] * 3


def test_ranks_sharing_one_card_keep_the_host_planes(world):
    """Every rank sees the same single card: the plane does not form,
    CPU tensors ride the TCP ring, and the knob at 1 raises everywhere."""
    size, recs = world
    for rank in range(size):
        r = recs[rank]
        assert r["onecard/planes"] == ("planes", ["tcp", "basic"])
        assert r["onecard/card"] == ("int", 0)
        assert _from_record(r["onecard/sum"]).tolist() == \
            [float(sum(range(size)))] * 3
        kind, exc, msg = r["onecard/required"]
        assert exc == "RuntimeError" and "share a card" in msg, msg


# --- in-process: the controller, the chain and the host-only helpers ---------
def _controller(size: int = 2):
    from horovod_tpu_torch.common.controller import (Controller,
                                                     LocalTransport)
    from horovod_tpu_torch.common.tensor_queue import TensorQueue
    return Controller(rank=0, size=size, transport=LocalTransport(),
                      tensor_queue=TensorQueue())


def _request(rank: int, name: str, device: int) -> Request:
    return Request(request_rank=rank, request_type=RequestType.ALLREDUCE,
                   tensor_type=DataType.FLOAT32, tensor_name=name,
                   device=device, tensor_shape=(4,))


@pytest.mark.parametrize("devices,error", [
    ((-1, 0), True), ((0, -1), True), ((-1, -1), False), ((0, 1), False),
    ((3, 3), False)])
def test_controller_checks_the_device_kind(devices, error):
    """Upstream Horovod's check: CPU on one rank and a card on another
    is an error response; cards of different indices are not."""
    ctl = _controller(len(devices))
    for rank, device in enumerate(devices):
        ctl._handle_request(_request(rank, "t", device))
    resp = ctl._construct_response(["t"])
    assert (resp.response_type == ResponseType.ERROR) == error
    if error:
        assert "Mismatched CPU/GPU device selection" in resp.error_message
    else:
        assert resp.devices == list(devices)


def test_fusion_keeps_cpu_and_card_apart():
    ctl = _controller(2)
    for name, dev in (("c0", -1), ("g0", 0), ("c1", -1), ("g1", 0)):
        for rank in range(2):
            ctl._handle_request(_request(rank, name, dev if dev < 0
                                         else rank))
    parts = [ctl._construct_response([n]) for n in ("c0", "g0", "c1", "g1")]
    fused = ctl.fuse_responses(parts)
    assert [r.tensor_names for r in fused] == [["c0", "c1"], ["g0", "g1"]]
    assert [is_device_response(r) for r in fused] == [False, True]


def test_host_planes_decline_device_responses():
    from horovod_tpu_torch.backend.basic import BasicBackend
    from horovod_tpu_torch.backend.nccl import NcclBackend
    from horovod_tpu_torch.backend.tcp import TcpBackend
    device = Response(response_type=ResponseType.ALLREDUCE,
                      tensor_names=["t"], devices=[0, 1],
                      tensor_type=DataType.FLOAT32, tensor_sizes=[4])
    host = Response(response_type=ResponseType.ALLREDUCE,
                    tensor_names=["t"], devices=[-1, -1],
                    tensor_type=DataType.FLOAT32, tensor_sizes=[4])
    tcp = TcpBackend(types.SimpleNamespace(size=2))
    plane = NcclBackend(types.SimpleNamespace(size=2, device="cpu"))
    assert [tcp.enabled(r, []) for r in (device, host)] == [False, True]
    assert [plane.enabled(r, []) for r in (device, host)] == [True, False]
    assert not BasicBackend(2).enabled(device, [])
    # Adasum of CUDA tensors is the device plane's (it runs the VHDD on
    # the card); the host planes decline it as any device response.
    adasum = Response(response_type=ResponseType.ADASUM,
                      tensor_names=["t"], devices=[0, 1],
                      tensor_type=DataType.FLOAT32, tensor_sizes=[4])
    assert plane.enabled(adasum, []) and not tcp.enabled(adasum, [])


def test_host_helpers_refuse_a_tensor_off_the_host():
    from horovod_tpu_torch.backend.base import add_
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="never staged through the host"):
        byte_view(meta)
    with pytest.raises(ValueError, match="never staged through the host"):
        add_(torch.empty(4, dtype=torch.uint16, device="meta"),
             torch.empty(4, dtype=torch.uint16, device="meta"))
    # A one-element tensor with a stride of 2 (a sparse tensor's
    # transposed indices) still gives its bytes.
    odd = torch.tensor([[5]]).as_strided((1, 1), (1, 2))
    assert bytes(byte_view(odd)) == (5).to_bytes(8, "little")


def test_fusion_buffers_are_per_device():
    b = CollectiveBackend.fusion_buffers.fget(types.SimpleNamespace())
    cpu = b.get("pack", torch.float32, 8)
    meta = b.get("pack", torch.float32, 8, torch.device("meta"))
    assert cpu.device.type == "cpu" and meta.device.type == "meta"
    assert b.owns(cpu)


def test_knob_and_policy(monkeypatch):
    import torch.distributed as dist
    from horovod_tpu_torch.common import config
    from horovod_tpu_torch.parallel import multihost
    assert config.NCCL_OPERATIONS.name == "HOROVOD_NCCL_OPERATIONS"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("HOROVOD_NCCL_OPERATIONS", raising=False)
    assert not multihost.should_init(2)        # auto: no card here
    assert multihost.local_card(0) is None
    monkeypatch.setenv("HOROVOD_NCCL_OPERATIONS", "1")
    assert not multihost.should_init(1)
    assert not multihost.should_init(2)        # the world raises, later
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert multihost.should_init(2, local_rank=1)
    assert multihost.local_card(1) == 0        # one card: every rank's
    monkeypatch.setenv("HOROVOD_NCCL_OPERATIONS", "0")
    assert not multihost.should_init(2)
    assert not multihost.is_initialized()


@pytest.mark.parametrize("cards,per_process,formed", [
    (1, False, False),      # two ranks, one card both see
    (1, True, True),        # each process sees only its own card
    (2, False, True),       # a card per local rank
    (0, False, False),      # no card at all
])
def test_ranks_agree_on_their_cards(monkeypatch, cards, per_process,
                                    formed):
    """``agree_on_cards`` over a real rendezvous KV, one thread per rank:
    the plane forms only when every rank offers a card of its own, and
    every rank reaches the same verdict."""
    from horovod_tpu_torch.parallel import multihost
    from horovod_tpu_torch.runner.network import RendezvousClient
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(
        multihost, "_card_identity",
        lambda index: (threading.current_thread().name if per_process
                       else "") + f"card{index}")
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_EPOCH",
                       f"agree{cards}{per_process}")
    server = RendezvousServer()
    port = server.start()
    verdicts = {}

    def rank(r):
        kv = RendezvousClient("127.0.0.1", port, 30.0)
        verdicts[r] = multihost.agree_on_cards(
            r, 2, kv, multihost.local_card(r), timeout=30.0)

    threads = [threading.Thread(target=rank, args=(r,), name=f"p{r}")
               for r in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        server.stop()
    assert len(verdicts) == 2 and verdicts[0] == verdicts[1]
    assert (verdicts[0] is None) == formed, verdicts[0]


def test_world_of_one_takes_a_card_tensor_check():
    """At one rank a CUDA tensor on this rank's card passes the check
    (the basic plane keeps it there); another card's does not."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import core
    hvd.init()
    try:
        core.check_device(torch.device("cuda", 0))
        core.check_device(torch.device("cpu"))
        with pytest.raises(ValueError, match="cuda:0"):
            core.check_device(torch.device("cuda", 1))
        with pytest.raises(ValueError, match="unsupported device"):
            hvd.allreduce(torch.ones(2, device="meta"))
        assert core.global_state().op_manager.backends[0].name == "basic"
    finally:
        hvd.shutdown()
