"""One worker of an elastic world, started by an elastic launcher:

    python torch_elastic_worker.py SIDE

SIDE is ``port`` (``horovod_tpu_torch``) or ``ref`` (``horovod_tpu``,
torch mode only).  The environment picks the scenario, as the reference's
``tests/elastic_worker.py`` does:

- ``TEST_ELASTIC_OUT``    directory for the markers;
- ``TEST_ELASTIC_MODE``   ``counter`` (an ``ObjectState`` epoch counter and
  one allreduce an epoch, the reference's worker) or ``torch`` (a seeded
  ``nn.Linear`` and SGD with momentum under ``TorchState`` through
  ``DistributedOptimizer``);
- ``TEST_ELASTIC_TARGET`` epochs to finish;
- ``TEST_ELASTIC_FAIL_HOST`` / ``_FAIL_EPOCH``  the "host" that hard-exits at
  that epoch (a node failure);
- ``TEST_ELASTIC_GROW_FILE`` / ``_GROW_EPOCH`` / ``_GROW_HOST``  the
  discovery script's host file, which rank 0 extends with GROW_HOST at
  that epoch and then commits until the driver's notification turns into
  a ``HostsUpdatedInterrupt``.

Every collective of the counter mode runs through ``run_with_recovery``
(``HOROVOD_ON_FAILURE`` decides; ``shrink`` re-raises into the elastic
loop); a ``RanksFailedError`` it sees is recorded.  Each worker that
finishes writes ``done.<host>.<local_rank>`` (JSON: epochs, size, rank,
the failed-rank sets seen, the reset and first-resumed-step wall times,
and in torch mode the final parameters' bytes in hex).  A worker about to
fail stamps ``fault.<host>`` first.  ``run_fn`` is the function
``hvd.run`` pickles in the programmatic scenario.

``run_scenario(name, out)`` runs one whole world in ``out`` through the
package's launcher (a subprocess, its group killed past
``WORLD_TIMEOUT``) and checks it: ``happy``, ``node-failure``, ``grow``,
``shrink``, ``run`` (``hvd.run`` under the elastic driver), and
``torch-ref``/``torch-port`` (the TorchState worlds).  It returns the wall
time, the time from the fault to the first resumed step, the markers and
the problems found (none when the world did what it should);
``tests/test_torch_elastic_integration.py`` and ``chip_smoke.py``'s
elastic phase both call it.
"""
from __future__ import annotations

import glob
import importlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

SIDE = sys.argv[1] if __name__ == "__main__" else "port"
MODE = os.environ.get("TEST_ELASTIC_MODE", "counter")
OUT_DIR = os.environ.get("TEST_ELASTIC_OUT", "")
TARGET = int(os.environ.get("TEST_ELASTIC_TARGET", "5"))
FAIL_HOST = os.environ.get("TEST_ELASTIC_FAIL_HOST", "")
FAIL_EPOCH = int(os.environ.get("TEST_ELASTIC_FAIL_EPOCH", "2"))
GROW_FILE = os.environ.get("TEST_ELASTIC_GROW_FILE", "")
GROW_EPOCH = int(os.environ.get("TEST_ELASTIC_GROW_EPOCH", "1"))
GROW_HOST = os.environ.get("TEST_ELASTIC_GROW_HOST", "127.0.0.1:1")
GROW_WAIT_S = 30.0

TRACE = {"failed_sets": [], "faults": [], "resets": [], "first_steps": []}


def _hostname() -> str:
    return os.environ.get("HOROVOD_HOSTNAME", "")


def _stamp(kind: str) -> None:
    with open(os.path.join(OUT_DIR, f"{kind}.{_hostname()}"), "w") as f:
        f.write(repr(time.time()))


def _on_reset() -> None:
    TRACE["resets"].append(time.time())


def _guarded(hvd, fn):
    """``fn`` under ``HOROVOD_ON_FAILURE``, noting a RanksFailedError."""
    try:
        return hvd.run_with_recovery(fn)
    except hvd.RanksFailedError as exc:
        TRACE["faults"].append(time.time())
        TRACE["failed_sets"].append(sorted(exc.failed_ranks))
        raise


def counter_world():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import ObjectState, run

    @run
    def train(state):
        if TRACE["resets"] and len(TRACE["first_steps"]) < \
                len(TRACE["resets"]):
            TRACE["first_steps"].append(time.time())
        grow_deadline = None
        while state.epoch < TARGET:
            if _hostname() == FAIL_HOST and state.epoch == FAIL_EPOCH:
                _stamp("fault")
                os._exit(17)   # a sudden node death
            if GROW_FILE and hvd.size() == 1 and state.epoch >= GROW_EPOCH:
                # Rank 0 adds a host, then keeps committing until the
                # driver's notification interrupts every rank at once.
                if grow_deadline is None:
                    with open(GROW_FILE, "a") as f:
                        f.write(GROW_HOST + "\n")
                    _stamp("fault")
                    grow_deadline = time.monotonic() + GROW_WAIT_S
                if time.monotonic() > grow_deadline:
                    raise RuntimeError("no host-update interrupt after the "
                                       "discovery script grew")
                time.sleep(0.1)
                state.commit()
                continue
            out = _guarded(hvd, lambda: hvd.allreduce(
                torch.ones(4) * (state.epoch + 1), op=hvd.Sum,
                name="step"))
            expected = float((state.epoch + 1) * hvd.size())
            if out.tolist() != [expected] * 4:
                raise AssertionError((out, expected))
            state.epoch += 1
            state.commit()
        return state.epoch

    state = ObjectState(epoch=0)
    state.register_reset_callbacks([_on_reset])
    return hvd, train(state)


def _batch(epoch: int, rank: int):
    rng = np.random.default_rng(1000 * epoch + rank)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    return x, y


def _join(run_module, worker_module, hvd) -> bool:
    """Take this slot's first assignment from the driver and init, as the
    reference's ``elastic_run_worker`` does for a function that builds its
    optimizer (which needs the world's size) before ``hvd.elastic.run``.
    False when the slot is not part of the world."""
    manager = worker_module.notification_manager
    manager.init()
    if manager.has_driver:
        assignment = manager.get_assignment(0)
        if assignment is None:
            return False
        run_module._apply_assignment(assignment)
    hvd.init()
    return True


def torch_world(side: str):
    package = "horovod_tpu" if side == "ref" else "horovod_tpu_torch"
    hvd = importlib.import_module(f"{package}.torch")
    TorchState = importlib.import_module(f"{package}.torch.elastic") \
        .TorchState
    # By module path: the package's ``run`` function hides the module.
    run_module = importlib.import_module(f"{package}.elastic.run")
    worker_module = importlib.import_module(f"{package}.elastic.worker")
    run = run_module.run
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4)
    base = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)

    @run
    def train(state):
        if TRACE["resets"] and len(TRACE["first_steps"]) < \
                len(TRACE["resets"]):
            TRACE["first_steps"].append(time.time())
        while state.epoch < TARGET:
            x, y = _batch(state.epoch, hvd.rank())
            state.optimizer.zero_grad()
            loss = torch.nn.functional.mse_loss(state.model(x), y)
            loss.backward()
            state.optimizer.step()
            # A named collective an epoch: the chaos spec's target.
            hvd.allreduce(loss.detach(), name=f"loss.{state.epoch}")
            state.epoch += 1
            state.commit()
        return state.epoch

    if not _join(run_module, worker_module, hvd):
        return hvd, None, model
    opt = hvd.DistributedOptimizer(
        base, named_parameters=model.named_parameters())
    state = TorchState(model, opt, epoch=0)
    state.register_reset_callbacks([_on_reset])
    return hvd, train(state), model


def main() -> int:
    torch.set_num_threads(1)
    if MODE == "torch":
        hvd, result, model = torch_world(SIDE)
    else:
        hvd, result = counter_world()
        model = None
    if result is None:
        return 0   # dropped from the world: clean exit
    record = {"epochs": result, "size": hvd.size(), "rank": hvd.rank(),
              **TRACE}
    if model is not None:
        record["params"] = {k: v.detach().numpy().tobytes().hex()
                            for k, v in model.state_dict().items()}
    marker = os.path.join(
        OUT_DIR, f"done.{_hostname()}.{os.environ.get('HOROVOD_LOCAL_RANK')}")
    with open(marker, "w") as f:
        json.dump(record, f)
    return 0


def run_fn(scale: float):
    """The programmatic scenario: ``hvd.run`` pickles this by reference."""
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init()
    try:
        out = hvd.allreduce(torch.ones(4) * scale, op=hvd.Sum,
                            name="elastic_fn")
        return {"rank": hvd.rank(), "size": hvd.size(),
                "sum": float(out[0]),
                "marker": os.environ.get("TEST_ELASTIC_RUN_MARKER")}
    finally:
        hvd.shutdown()



# ---------------------------------------------------------------------------
# The scenarios, each a whole world under a launcher
# ---------------------------------------------------------------------------
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD_TIMEOUT = 90.0
FAULT_TIMEOUT = 3.0
SCENARIOS = ("happy", "node-failure", "grow", "shrink", "run")


def _env(out: str, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=os.pathsep.join(
        [REPO, TESTS, os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
        CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu",
        TEST_ELASTIC_OUT=out,
        HOROVOD_FLIGHT_FILE=os.path.join(out, "flight.json"))
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(cmd: list[str], env: dict) -> tuple[int, str]:
    """Run ``cmd`` in its own session; kill its whole group if it
    outlives ``WORLD_TIMEOUT`` (rc None then)."""
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=WORLD_TIMEOUT)
        return proc.returncode, text
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        return None, text


def _markers(out: str) -> dict[str, dict]:
    found = {}
    for path in sorted(glob.glob(os.path.join(out, "done.*"))):
        with open(path) as f:
            found[os.path.basename(path)[len("done."):]] = json.load(f)
    return found


def _expect(problems: list, what: str, got, want) -> None:
    if got != want:
        problems.append(f"{what}: {got!r}, not {want!r}")


def run_scenario(name: str, out: str) -> dict:
    """Run scenario ``name`` in directory ``out`` and check it."""
    out = str(out)
    side = "ref" if name == "torch-ref" else "port"
    package = "horovod_tpu" if side == "ref" else "horovod_tpu_torch"
    worker = [sys.executable, os.path.abspath(__file__), side]
    common = ["--elastic-timeout", "60"]
    extra: dict = {}
    if name == "happy":
        argv = ["-np", "2", "--min-np", "2", "-H", "localhost:2"]
        extra = dict(TEST_ELASTIC_TARGET=3)
    elif name == "node-failure":
        argv = ["-np", "2", "--min-np", "1", "--max-np", "2",
                "-H", "localhost:1,127.0.0.1:1"]
        extra = dict(TEST_ELASTIC_TARGET=5, TEST_ELASTIC_FAIL_HOST="127.0.0.1",
                     TEST_ELASTIC_FAIL_EPOCH=2)
    elif name == "grow":
        hostfile = os.path.join(out, "hosts.txt")
        with open(hostfile, "w") as f:
            f.write("localhost:1\n")
        script = os.path.join(out, "discover.sh")
        with open(script, "w") as f:
            f.write(f"#!/bin/sh\ncat {hostfile}\n")
        os.chmod(script, 0o755)
        argv = ["--min-np", "1", "--max-np", "2",
                "--host-discovery-script", script]
        extra = dict(TEST_ELASTIC_TARGET=3, TEST_ELASTIC_GROW_FILE=hostfile,
                     TEST_ELASTIC_GROW_EPOCH=1,
                     TEST_ELASTIC_GROW_HOST="127.0.0.1:1")
    elif name == "shrink":
        # ObjectState.sync is two broadcasts, then each epoch one
        # allreduce and the commit's host-update allreduce: collective 6
        # is epoch 2's.
        argv = ["-np", "3", "--min-np", "2", "--max-np", "3",
                "-H", "localhost:1,127.0.0.1:1,127.0.0.2:1"]
        extra = dict(TEST_ELASTIC_TARGET=5, HOROVOD_FAULT_TOLERANCE=1,
                     HOROVOD_FAULT_TIMEOUT=FAULT_TIMEOUT,
                     HOROVOD_ON_FAILURE="shrink", HOROVOD_SHM_OPERATIONS=0,
                     HOROVOD_CHAOS="kill:rank=2,op=6,sig=9")
    elif name in ("torch-ref", "torch-port"):
        # One failed collective (loss.2) on every rank, once.
        argv = ["-np", "2", "--min-np", "2", "-H", "localhost:2"]
        extra = dict(TEST_ELASTIC_MODE="torch", TEST_ELASTIC_TARGET=4,
                     HOROVOD_CHAOS="fail:name=loss.2,rank=*")
    elif name != "run":
        raise ValueError(f"no scenario {name!r}")
    env = _env(out, **extra)
    t0 = time.time()
    if name == "run":
        code = ("import json, horovod_tpu_torch as hvd\n"
                "from torch_elastic_worker import run_fn\n"
                "res = hvd.run(run_fn, args=(3.0,), hosts='localhost:2',\n"
                "              min_np=2, max_np=2, elastic_timeout=60.0,\n"
                "              env={'TEST_ELASTIC_RUN_MARKER':\n"
                "                   'propagated'})\n"
                "print('RESULT', json.dumps(res))\n")
        rc, text = _run([sys.executable, "-c", code], env)
    else:
        rc, text = _run([sys.executable, "-m", f"{package}.runner.launch",
                         *argv, *common, *worker], env)
    seconds = time.time() - t0
    problems: list[str] = []
    result = {"scenario": name, "seconds": seconds, "rc": rc,
              "fault_to_recovery_s": None}
    if rc != 0:
        problems.append(f"{name}: launcher rc {rc}: {text[-3000:]}")
        return {**result, "problems": problems}
    markers = _markers(out)
    result["markers"] = {k: {f: m[f] for f in ("epochs", "size", "rank",
                                                "failed_sets")}
                         for k, m in markers.items()}

    def check_world(want_keys, epochs, size, resets):
        _expect(problems, f"{name} markers", sorted(markers), want_keys)
        _expect(problems, f"{name} ranks",
                sorted(m["rank"] for m in markers.values()),
                list(range(len(want_keys))))
        for key, m in markers.items():
            _expect(problems, f"{name} {key} epochs/size",
                    (m["epochs"], m["size"]), (epochs, size))
            if resets is not None:
                _expect(problems, f"{name} {key} resets",
                        len(m["resets"]), resets)

    def recovery(fault: float | None) -> None:
        firsts = [m["first_steps"][0] for m in markers.values()
                  if m["first_steps"]]
        if fault is not None and firsts:
            result["fault_to_recovery_s"] = max(firsts) - fault

    def stamp() -> float | None:
        paths = glob.glob(os.path.join(out, "fault.*"))
        if not paths:
            problems.append(f"{name}: no fault stamp")
            return None
        with open(paths[0]) as f:
            return float(f.read())

    if name == "happy":
        check_world(["localhost.0", "localhost.1"], 3, 2, 0)
    elif name == "node-failure":
        check_world(["localhost.0"], 5, 1, 1)       # only the survivor
        recovery(stamp())
    elif name == "grow":
        check_world(["127.0.0.1.0", "localhost.0"], 3, 2, None)
        first = markers.get("localhost.0", {})
        _expect(problems, "grow: the first worker's resets",
                len(first.get("resets", [])), 1)
        _expect(problems, "grow: the joiner's rank",
                markers.get("127.0.0.1.0", {}).get("rank"), 1)
        recovery(stamp())
    elif name == "shrink":
        check_world(["127.0.0.1.0", "localhost.0"], 5, 2, 1)
        for key, m in markers.items():
            # Rank 2 is named on every survivor (the reference's kill
            # battery's assertion); a survivor still waiting when the
            # other tears its meshes down for the re-rendezvous names
            # that one too.
            if len(m["failed_sets"]) != 1 or 2 not in m["failed_sets"][0]:
                problems.append(f"shrink {key}: failed sets "
                                f"{m['failed_sets']}")
        faults = [m["faults"][0] for m in markers.values() if m["faults"]]
        recovery(min(faults) if faults else None)
    elif name == "run":
        line = [x for x in text.splitlines() if x.startswith("RESULT ")]
        got = json.loads(line[-1][7:]) if line else {}
        _expect(problems, "run results", got, {
            str(r): {"rank": r, "size": 2, "sum": 6.0,
                     "marker": "propagated"} for r in range(2)})
    else:
        check_world(["localhost.0", "localhost.1"], 4, 2, 1)
        params = [m["params"] for m in markers.values()]
        if len(params) == 2 and params[0] != params[1]:
            problems.append(f"{name}: the ranks' parameters differ")
        result["params"] = params[0] if params else None
    return {**result, "problems": problems}


if __name__ == "__main__":
    sys.exit(main())
