"""One rank of a port world running a fault-tolerance battery:

    python torch_resilience_worker.py BATTERY RANK SIZE PORT OUTDIR

The batteries are the reference's (``tests/mp_worker.py``
``battery_resilience_kill``, ``_retry``, ``_freeze`` and ``_off``) on
``horovod_tpu_torch`` and CPU torch tensors, with the same environment
(``ENV``; the fault timeout is ``FAULT_TIMEOUT`` here) and the same
assertions.  Each rank prints its verdict line; an assertion fails the
rank's exit code.  It imports torch and the port only.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

import torch

FAULT_TIMEOUT = 3.0

# battery -> its environment, as the reference's mp_worker sets it.  The
# TCP plane and the flat ring are pinned so the socket-level deadlines
# are the ones exercised and the chaos targets name real ring edges.
COMMON = {"HOROVOD_SHM_OPERATIONS": "0",
          "HOROVOD_TREE_THRESHOLD_BYTES": "0",
          "HOROVOD_FLIGHT_FILE": "{outdir}/flight.json"}
ENV = {
    "kill": {"HOROVOD_FAULT_TOLERANCE": "1",
             "HOROVOD_FAULT_TIMEOUT": str(FAULT_TIMEOUT),
             # A real SIGKILL mid-allreduce at global collective index 3.
             "HOROVOD_CHAOS": "kill:rank=2,op=3,sig=9"},
    "retry": {"HOROVOD_FAULT_TOLERANCE": "1",
              "HOROVOD_FAULT_TIMEOUT": str(FAULT_TIMEOUT),
              "HOROVOD_ON_FAILURE": "retry",
              # Hold rank 1's first data-mesh send to rank 2 past the
              # deadline on attempt 0; count=1 lets the retry run clean.
              "HOROVOD_CHAOS": "delay:rank=1,mesh=data,peer=2,send=0,"
                               f"ms={int(3 * FAULT_TIMEOUT * 1e3)},count=1"},
    "freeze": {"HOROVOD_FAULT_TOLERANCE": "1",
               "HOROVOD_FAULT_TIMEOUT": str(FAULT_TIMEOUT),
               "HOROVOD_CHAOS": "freeze:rank=1,op=1,"
                                f"ms={int(3 * FAULT_TIMEOUT * 1e3)}"},
    "off": {},
}


def _ones(n: int) -> torch.Tensor:
    return torch.ones(n, dtype=torch.float32)


def battery_kill(hvd, rank: int, size: int) -> str:
    """Every survivor raises RanksFailedError naming rank 2 within 2x the
    fault timeout, and its flight dump's tail is the in-flight op."""
    from horovod_tpu_torch.telemetry import flight
    small = _ones(8)
    for i in range(3):   # collectives 0..2: world healthy
        out = hvd.allreduce(small, op=hvd.Sum, name=f"warm{i}")
        assert torch.equal(out, torch.full((8,), float(size))), out
    t0 = time.monotonic()
    try:
        for i in range(50):   # collective 3 kills rank 2 pre-dispatch
            hvd.allreduce(small, op=hvd.Sum, name=f"after{i}")
    except hvd.RanksFailedError as e:
        elapsed = time.monotonic() - t0
        assert 2 in e.failed_ranks, e
        assert elapsed < 2 * FAULT_TIMEOUT, (elapsed, FAULT_TIMEOUT)
        rec = flight.recorder()
        assert rec.enabled and rec.dumps >= 1, (rec.enabled, rec.dumps)
        # The controller's poison and the data plane both dump; the
        # other may still be rewriting the file.
        for _ in range(40):
            try:
                with open(rec.last_dump_path) as f:
                    payload = json.load(f)
                break
            except ValueError:
                time.sleep(0.05)
        else:
            raise AssertionError(f"flight dump at {rec.last_dump_path} "
                                 f"never became valid JSON")
        assert payload["rank"] == rank
        events = payload["events"]
        kinds = [ev["kind"] for ev in events]
        assert "ranks-failed" in kinds, kinds
        dispatched = [i for i, ev in enumerate(events)
                      if ev["kind"] == "dispatch"
                      and ev["name"].startswith("after")]
        assert dispatched, kinds
        last = events[dispatched[-1]]
        assert last["trace"], last
        assert not any(ev["kind"] == "done" and ev["name"] == last["name"]
                       for ev in events[dispatched[-1]:]), events[-4:]
        return (f"survivor {rank}: RanksFailedError("
                f"{sorted(e.failed_ranks)}) in {elapsed:.2f}s "
                f"op={e.op!r} phase={e.phase!r} in-flight={last['name']}")
    raise AssertionError("collectives kept succeeding after chaos kill")


def battery_retry(hvd, rank: int, size: int) -> str:
    """Attempt 0 misses its deadline on every rank; the retry policy
    rebuilds every channel under a new epoch and the re-run is exact."""
    from horovod_tpu_torch.resilience import policy
    ones = _ones(16)
    out = hvd.run_with_recovery(
        lambda: hvd.allreduce(ones, op=hvd.Sum, name="retry0"),
        policy="retry", max_retries=3, base_backoff=0.2)
    assert torch.equal(out, torch.full((16,), float(size))), out
    assert policy.last_attempts >= 2, \
        f"chaos delay never triggered a retry ({policy.last_attempts})"
    assert "~r" in os.environ["HOROVOD_RENDEZVOUS_EPOCH"]
    # The rebuilt world is fully healthy.
    out = hvd.allreduce(ones * (rank + 1), op=hvd.Sum, name="after_retry")
    want = float(sum(r + 1 for r in range(size)))
    assert torch.equal(out, torch.full((16,), want)), out
    return (f"rank {rank}: retry converged after {policy.last_attempts} "
            f"attempt(s) in epoch {os.environ['HOROVOD_RENDEZVOUS_EPOCH']}")


def battery_freeze(hvd, rank: int, size: int) -> str:
    """A wedged rank (PID alive, heartbeat thread beating) is caught by
    the per-op deadline: rank 0 raises RanksFailedError naming rank 1
    within 2x the timeout, and rank 1 is a suspect, not confirmed dead."""
    from horovod_tpu_torch import resilience
    small = _ones(4)
    hvd.allreduce(small, op=hvd.Sum, name="fwarm")   # collective 0
    if rank == 1:
        # Frozen pre-dispatch of collective 1; whatever the world looks
        # like when it thaws, a structured error is acceptable.
        try:
            hvd.allreduce(small, op=hvd.Sum, name="frozen")
            hvd.allreduce(small, op=hvd.Sum, name="thawed")
        except hvd.HorovodInternalError as e:
            return f"thawed rank: structured error after freeze: {e}"
        return "thawed rank: no error"
    t0 = time.monotonic()
    try:
        hvd.allreduce(small, op=hvd.Sum, name="frozen")
        hvd.allreduce(small, op=hvd.Sum, name="thawed")
    except hvd.RanksFailedError as e:
        elapsed = time.monotonic() - t0
        assert 1 in e.failed_ranks, e
        assert elapsed < 2 * FAULT_TIMEOUT, (elapsed, FAULT_TIMEOUT)
        state = resilience.active_state()
        assert not state.confirmed_dead({1}), \
            "the frozen rank's heartbeat stopped: it was declared dead"
        return f"rank {rank}: wedged peer converted in {elapsed:.2f}s"
    raise AssertionError("frozen peer never converted to an error")


def battery_off(hvd, rank: int, size: int) -> str:
    """No monitor thread, no chaos engine, no socket timeouts and no
    resilience state on any mesh or channel."""
    from horovod_tpu_torch import core, resilience

    def heartbeat_threads():
        return [t.name for t in threading.enumerate()
                if "heartbeat" in t.name]

    assert resilience.active_state() is None
    assert resilience.chaos.active() is None
    assert core._global.chaos is None
    assert not heartbeat_threads()
    for coll in core._global.tcp_collectives:
        mesh = coll.mesh
        assert mesh._resilience is None and mesh._chaos is None
        for ch in mesh._channels.values():
            assert ch._res is None
            t = ch.sock.gettimeout()
            assert t is None or t >= 10.0, \
                f"off mode must not install poll timeouts (got {t})"
    out = hvd.allreduce(_ones(8), op=hvd.Sum, name="off0")
    assert torch.equal(out, torch.full((8,), float(size))), out
    assert not heartbeat_threads()
    return f"rank {rank}: off mode clean"


BATTERIES = {"kill": battery_kill, "retry": battery_retry,
             "freeze": battery_freeze, "off": battery_off}


def main(battery: str, rank: int, size: int, port: int,
         outdir: str) -> int:
    torch.set_num_threads(1)
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        del os.environ[k]
    os.environ.update({k: v.format(outdir=outdir)
                       for k, v in {**COMMON, **ENV[battery]}.items()})
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                      HOROVOD_RENDEZVOUS_EPOCH=f"{battery}{size}")
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        print(BATTERIES[battery](hvd, rank, size), flush=True)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  int(sys.argv[4]), sys.argv[5]))
