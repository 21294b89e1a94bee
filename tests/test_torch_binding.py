"""The port's torch binding (``horovod_tpu_torch.torch``) against the JAX
package's (``horovod_tpu.torch``), in 2- and 4-rank worlds on the CPU.

Both sizes of both packages run at once, each world against its own
package's ``RendezvousServer``, running
``tests/torch_binding_worker.py`` on the shm plane and on the TCP ring:
the cases of ``tests/mp_worker.py``'s torch, grid, sparse and SyncBatchNorm
batteries, and ``DistributedOptimizer`` over SGD and AdamW, one and two
backward passes a step, the fp16 and bf16 compressors and a predivide
factor, three steps each, on the MLP of
``examples/pytorch_synthetic_benchmark.py`` and on gpt_tiny.  Every
output and every parameter must be equal byte for byte.  The 4-rank
worlds run unfused (the worker says why); the reference's bf16
compressor goes through its own bfloat16 conversion (the worker's
``_route_reference_bf16``).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import threading

import pytest
import torch

from horovod_tpu.runner.network import RendezvousServer as RefServer
from horovod_tpu_torch.runner.network import RendezvousServer
from torch_sigterm import restore_sigterm  # noqa: F401

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_binding_worker.py")
_SERVERS = {"port": RendezvousServer, "ref": RefServer}
WORLD_TIMEOUT = 150.0
PHASES = ("shm", "ring")
BATTERIES = ("torch", "grid", "sparse", "syncbn", "optimizer_mlp",
             "optimizer_gpt")


def _run_world(side: str, size: int, outdir: str, failures: list) -> None:
    server = _SERVERS[side]()
    port = server.start()
    env = dict(os.environ)
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_TIMELINE",
                "HOROVOD_FUSION_THRESHOLD"):
        env.pop(var, None)
    env["HOROVOD_RENDEZVOUS_EPOCH"] = f"bind{side}{size}"
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, side, str(r), str(size), str(port),
         outdir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(size)]
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=WORLD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failures.append(f"{side} rank {r}: timeout")
            if p.returncode != 0:
                failures.append(f"{side} rank {r} rc={p.returncode}:\n"
                                + out.decode(errors="replace")[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()


@pytest.fixture(scope="module")
def all_worlds(tmp_path_factory):
    """size -> rank -> (port records, reference records); the four
    worlds (two sizes, two packages) run at once."""
    outdir = {size: str(tmp_path_factory.mktemp(f"binding{size}"))
              for size in (2, 4)}
    failures: list[str] = []
    threads = [threading.Thread(target=_run_world,
                                args=(side, size, outdir[size], failures))
               for size in (2, 4) for side in ("port", "ref")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, "\n".join(failures)
    recs: dict[int, dict] = {}
    for size in (2, 4):
        recs[size] = {}
        for r in range(size):
            with open(os.path.join(outdir[size], f"port_{r}.pkl"),
                      "rb") as f:
                port = pickle.load(f)
            with open(os.path.join(outdir[size], f"ref_{r}.pkl"),
                      "rb") as f:
                ref = pickle.load(f)
            recs[size][r] = (port, ref)
    return recs


@pytest.fixture(params=[2, 4], ids=["2rank", "4rank"])
def worlds(request, all_worlds):
    return request.param, all_worlds[request.param]


@pytest.mark.parametrize("battery", BATTERIES)
@pytest.mark.parametrize("phase", PHASES)
def test_binding_equals_reference_bitwise(worlds, phase, battery):
    size, recs = worlds
    prefix = f"{phase}/{battery}/"
    for rank, (port, ref) in recs.items():
        p = {k: v for k, v in port.items() if k.startswith(prefix)}
        j = {k: v for k, v in ref.items() if k.startswith(prefix)}
        assert p, (rank, prefix)
        assert sorted(p) == sorted(j), (rank, set(p) ^ set(j))
        bad = sorted(k for k in p if p[k] != j[k])
        assert not bad, (size, rank, bad)


def test_replicas_agree(worlds):
    """Every rank ends every training case with the same parameters."""
    size, recs = worlds
    port0 = recs[0][0]
    keys = [k for k in port0 if "/optimizer_" in k or "/dp_" in k]
    assert keys
    for rank in range(1, size):
        assert {k: recs[rank][0][k] for k in keys} == \
            {k: port0[k] for k in keys}, rank


def test_all_is_the_reference_bindings():
    import horovod_tpu.torch as ref
    import horovod_tpu_torch.torch as port
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert hasattr(port, name), name


def test_unported_parts_raise():
    """The Adasum optimizer and the quantized compressors are ported (the
    reduction features' tests hold them against the reference): they
    build, and the compressors pass the tensor through to the planes."""
    import horovod_tpu_torch.torch as hvt
    hvt.init()
    try:
        model = torch.nn.Linear(3, 2)
        sgd = torch.optim.SGD(model.parameters(), lr=0.1)
        assert isinstance(hvt.DistributedOptimizer(sgd, op=hvt.Adasum),
                          torch.optim.SGD)
        for comp in (hvt.Compression.int8, hvt.Compression.uint4, "int8"):
            hvt.DistributedOptimizer(sgd, compression=comp)
            c = hvt.Compression.resolve(comp)
            y, ctx = c.compress(torch.ones(2))
            assert torch.equal(c.decompress(y, ctx), torch.ones(2))
            assert c.wire_codec in ("int8", "uint4")
        x = torch.ones(2)
        assert hvt.Compression.bf16.compress(x)[0].dtype == torch.bfloat16
        assert hvt.Compression.fp16.decompress(
            *hvt.Compression.fp16.compress(x)).dtype == torch.float32
    finally:
        hvt.shutdown()


def test_world_of_one_keeps_the_local_step():
    """At one rank no hook registers (as in the reference): the wrapped
    optimizer steps on the local gradient, and broadcast_parameters,
    broadcast_optimizer_state and SyncBatchNorm run on the basic plane."""
    import torch.nn.functional as F

    import horovod_tpu_torch.torch as hvt
    hvt.init()
    try:
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 2)
        twin = torch.nn.Linear(4, 2)
        twin.load_state_dict(model.state_dict())
        opt = hvt.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            compression=hvt.Compression.bf16)
        plain = torch.optim.AdamW(twin.parameters(), lr=0.1)
        hvt.broadcast_parameters(model.state_dict(), root_rank=0)
        x = torch.randn(3, 4)
        for m, o in ((model, opt), (twin, plain)):
            m(x).square().sum().backward()
            o.step()
            o.zero_grad()
        hvt.broadcast_optimizer_state(opt, root_rank=0)
        for p, q in zip(model.parameters(), twin.parameters()):
            assert torch.equal(p, q)
        bn = hvt.SyncBatchNorm(3)
        y = torch.randn(5, 3, 2)
        ref = F.batch_norm(y, torch.zeros(3), torch.ones(3), bn.weight,
                           bn.bias, True, 0.1, 1e-5)
        assert torch.equal(bn(y), ref)
    finally:
        hvt.shutdown()
