"""The port's eager Horovod core against the JAX package's, in 2- and
4-rank worlds on the CPU.

Each world size spawns one world of each package at once, each against its
own package's ``RendezvousServer``: ``tests/torch_eager_worker.py`` (the
port, CPU torch tensors) and ``tests/torch_eager_ref_worker.py`` (the JAX
package's eager API on numpy).  Both run ``tests/torch_eager_battery.py``
on the TCP ring, the TCP tree, halving-doubling and the torus (4 ranks;
in 2 every schedule is the ring) and the shm plane of the default
environment, then a stall world.  Every
output, its dtype and shape, and the type and text of every error must be
equal byte for byte: the same schedules add in the same order, 16-bit
floats accumulate in fp32 and scale like numpy, integers scale by the
float64 factor and truncate.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import threading

import pytest

from horovod_tpu.runner.network import RendezvousServer as RefServer
from horovod_tpu_torch.runner.network import RendezvousServer
from torch_world_lock import world_locked

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKERS = {"port": os.path.join(_HERE, "torch_eager_worker.py"),
            "ref": os.path.join(_HERE, "torch_eager_ref_worker.py")}
_SERVERS = {"port": RendezvousServer, "ref": RefServer}
WORLD_TIMEOUT = 150.0


@world_locked("size")
def _run_world(side: str, size: int, outdir: str, failures: list) -> None:
    server = _SERVERS[side]()
    port = server.start()
    env = dict(os.environ)
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE",
                "HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_TIMELINE"):
        env.pop(var, None)
    env["HOROVOD_RENDEZVOUS_EPOCH"] = f"{side}{size}"
    # One compute thread a rank: the worlds share the host's cores.
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, _WORKERS[side], str(r), str(size), str(port),
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


@pytest.fixture(scope="module", params=[2, 4], ids=["2rank", "4rank"])
def worlds(request, tmp_path_factory):
    """rank -> (port records, JAX records) of one world size."""
    size = request.param
    outdir = str(tmp_path_factory.mktemp(f"eager{size}"))
    failures: list[str] = []
    threads = [threading.Thread(target=_run_world,
                                args=(side, size, outdir, failures))
               for side in ("port", "ref")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failures, "\n".join(failures)
    recs = {}
    for r in range(size):
        with open(os.path.join(outdir, f"port_{r}.pkl"), "rb") as f:
            port = pickle.load(f)
        with open(os.path.join(outdir, f"ref_{r}.pkl"), "rb") as f:
            ref = pickle.load(f)
        recs[r] = (port, ref)
    return size, outdir, recs


def _phase(recs: dict, phase: str) -> dict:
    return {k: v for k, v in recs.items() if k.startswith(phase + "/")}


@pytest.mark.parametrize("phase", ["ring", "tree", "rhd", "torus", "shm",
                                   "stall"])
def test_outputs_equal_the_reference_bitwise(worlds, phase):
    size, _, recs = worlds
    if size == 2 and phase in ("tree", "rhd", "torus"):
        phase = "ring"   # two ranks: every schedule is the ring
    for rank, (port, ref) in recs.items():
        p, j = _phase(port, phase), _phase(ref, phase)
        assert p, (rank, phase)
        assert sorted(p) == sorted(j), (rank, set(p) ^ set(j))
        bad = {k: (p[k], j[k]) for k in p if p[k] != j[k]}
        assert not bad, (rank, phase, bad)


def test_planes_served_as_in_the_reference(worlds):
    size, _, recs = worlds
    for rank, (port, _) in recs.items():
        assert port["ring/planes"] == ("planes", ["tcp", "basic"])
        assert port["shm/planes"] == ("planes", ["shm", "tcp", "basic"])
        assert port["shm/shm_ops"] == ("int", True)
        if size > 2:
            assert port["tree/planes"] == ("planes", ["tcp", "basic"])
            assert port["rhd/algo"] == ("algo", "rhd")
            assert port["torus/algo"] == ("algo", "torus")


def test_errors_and_stall_are_structured(worlds):
    """Shape, dtype, group, root, splits and duplicate-name errors come
    back as the reference's exception types with its text, the world
    survives them, and a one-sided collective ends the world."""
    size, _, recs = worlds
    port, _ = recs[0]
    for key in ("err_shape", "err_dtype", "err_group_shape",
                "err_ag_shape", "err_bc_root", "err_dup"):
        kind, exc_type, _msg = port[f"ring/{key}"]
        assert kind == "error" and exc_type == "HorovodInternalError", key
    assert port["ring/err_a2a_splits"][1] == "ValueError"
    assert port["ring/after_errors"][0] == "float32"
    assert port["stall/lonely"][:2] == ("error", "HorovodInternalError")
    for rank in range(1, size):
        assert recs[rank][0]["stall/idle_saw_shutdown"] == ("int", True)


def _timeline_events(path: str) -> set:
    with open(path) as f:
        text = f.read().strip()
    if not text.endswith("]"):
        text = text.rstrip(",\n") + "]"
    return {(e.get("name"), e.get("ph"), e.get("cat"))
            for e in json.loads(text) if e.get("ph") != "M"}


def test_timeline_events_match_the_reference(worlds):
    """The shm phase's timeline: every rank writes its own file, the JSON
    parses, and it holds the reference's event names and phases."""
    size, outdir, _ = worlds
    for rank in range(size):
        suffix = "" if rank == 0 else f".r{rank}"
        port = _timeline_events(os.path.join(
            outdir, f"timeline_port{suffix}.json"))
        ref = _timeline_events(os.path.join(
            outdir, f"timeline_ref{suffix}.json"))
        names = {n for n, _, _ in port}
        assert any(str(n).startswith("NEGOTIATE") for n in names), names
        assert "SHM_ALLREDUCE" in names and "ALLREDUCE" in names, names
        assert port == ref, (rank, port ^ ref)
