"""The torch binding's Adasum optimizer and quantized compressors against
the JAX package's, in 2- and 4-rank worlds on the CPU.

A world of each package runs at each size, one after another, each
against its own package's ``RendezvousServer``, running
``tests/torch_binding_reduce_worker.py`` on the shm plane and on the TCP
ring: ``DistributedOptimizer(op=Adasum)`` over SGD and Adam (named and
unnamed parameters, one and two backward passes a step, the fp16
compressor) and the gradient optimizer with ``Compression.int8`` and
``uint4``, 3 steps each from the same numpy-drawn weights.  Every
parameter must be equal byte for byte.  At one rank the Adasum optimizer
is the wrapped optimizer's own step, and Adasum refuses the quantized
compressors, as in the reference.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys

import pytest
import torch

from horovod_tpu.runner.network import RendezvousServer as RefServer
from horovod_tpu_torch.runner.network import RendezvousServer

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "torch_binding_reduce_worker.py")
sys.path.insert(0, _HERE)
import torch_binding_reduce_worker as W  # noqa: E402
from torch_sigterm import restore_sigterm  # noqa: F401
from torch_world_lock import world_locked

_SERVERS = {"port": RendezvousServer, "ref": RefServer}
WORLD_TIMEOUT = 150.0


@world_locked("size")
def _run_world(side: str, size: int, outdir: str, failures: list) -> None:
    server = _SERVERS[side]()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["HOROVOD_RENDEZVOUS_EPOCH"] = f"bred{side}{size}"
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
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
def worlds(tmp_path_factory):
    """size -> rank -> (port records, JAX records); one world after
    another (the test files share the host with timing tests)."""
    failures: list[str] = []
    dirs = {s: str(tmp_path_factory.mktemp(f"bred{s}")) for s in (2, 4)}
    for size, d in dirs.items():
        for side in ("port", "ref"):
            _run_world(side, size, d, failures)
    assert not failures, "\n".join(failures)
    out = {}
    for s, d in dirs.items():
        out[s] = {}
        for r in range(s):
            pair = []
            for side in ("port", "ref"):
                with open(os.path.join(d, f"{side}_{r}.pkl"), "rb") as f:
                    pair.append(pickle.load(f))
            out[s][r] = tuple(pair)
    return out


def _cases(battery: str, cases) -> list[str]:
    return [f"{battery}/{k}-{p}-{c}-{'named' if n else 'unnamed'}"
            for k, p, c, n in cases]


CASES = _cases("adasum", W.ADASUM_CASES) + _cases("codec", W.CODEC_CASES)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("phase", list(W.PHASES))
@pytest.mark.parametrize("case", CASES)
def test_parameters_equal_the_reference_bitwise(worlds, size, phase, case):
    for rank, (port, ref) in worlds[size].items():
        prefix = f"{phase}/{case}/"
        p = {k: v for k, v in port.items() if k.startswith(prefix)}
        j = {k: v for k, v in ref.items() if k.startswith(prefix)}
        assert p and sorted(p) == sorted(j), (rank, set(p) ^ set(j))
        bad = sorted(k for k in p if p[k] != j[k])
        assert not bad, (rank, bad)


@pytest.mark.parametrize("size", [2, 4])
def test_ranks_end_with_the_same_parameters(worlds, size):
    port0 = worlds[size][0][0]
    for rank in range(1, size):
        assert worlds[size][rank][0] == port0, rank


def test_adasum_optimizer_at_one_rank_and_its_refusals():
    """At one rank no hook registers and step() is the wrapped step;
    Adasum refuses int8/uint4, a predivide factor and groups."""
    import horovod_tpu_torch.torch as hvt
    hvt.init()
    try:
        model, twin = W.make_model(), W.make_model()
        opt = hvt.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters(), op=hvt.Adasum)
        plain = torch.optim.Adam(twin.parameters(), lr=1e-2)
        for step in range(2):
            x, y = W.make_batch(0, step, 0)
            for m, o in ((model, opt), (twin, plain)):
                torch.nn.functional.mse_loss(m(x), y).backward()
                o.step()
                o.zero_grad()
        for p, q in zip(model.parameters(), twin.parameters()):
            assert torch.equal(p, q)
        sgd = torch.optim.SGD(model.parameters(), lr=0.1)
        for comp in (hvt.Compression.int8, hvt.Compression.uint4):
            with pytest.raises(ValueError, match="quantized compression"):
                hvt.DistributedOptimizer(sgd, op=hvt.Adasum,
                                         compression=comp)
        with pytest.raises(ValueError, match="predivide"):
            hvt.DistributedOptimizer(sgd, op=hvt.Adasum,
                                     gradient_predivide_factor=2.0)
        with pytest.raises(ValueError, match="groups"):
            hvt.DistributedOptimizer(sgd, op=hvt.Adasum, groups=2)
        with pytest.raises(AssertionError, match="not supported"):
            with opt.skip_synchronize():
                pass
    finally:
        hvt.shutdown()
