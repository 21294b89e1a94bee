"""Programmatic launch: ``horovod_tpu_torch.run(func, np=N, ...)``.

The port's copy of ``horovod_tpu/runner/run_api.py``.  Upstream
horovod/runner/__init__.py:92-210 — run a Python function on N worker
processes (instead of shelling out to a training script) and return the
per-rank results.  Local slots fork worker processes; remote slots run
the same pickled function over ssh through the
:mod:`horovod_tpu_torch.runner.run_worker` bootstrap, with results
returning via the rendezvous KV store (upstream's run_func KV server,
runner/launch.py:528-618).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import shlex
import socket
import subprocess
import sys
import threading
import traceback
from typing import Any, Callable, Sequence

from .hosts import (get_host_assignments, host_ids_env, is_local_host,
                    parse_hosts,
                    ssh_argv)
from .launch import rendezvous_env
from .network import RendezvousClient, RendezvousServer

# Module alias so tests can substitute a local shell for the ssh binary.
_ssh_argv = ssh_argv


def _run_elastic(func: Callable, args: Sequence, kwargs: dict, *,
                 np: int | None, hosts: str | None, env: dict | None,
                 min_np: int | None,
                 max_np: int | None, host_discovery_script: str | None,
                 reset_limit: int | None, elastic_timeout: float,
                 start_timeout: float, slots: int | None
                 ) -> dict[int, Any]:
    """Programmatic elastic launch: the pickled fn is seeded into the
    rendezvous KV; elastic_run_worker bootstraps fetch + execute it under
    the driver (reference: runner/__init__.py elastic branch)."""
    import pickle

    from ..elastic.launcher import launch_elastic
    from .launch import parse_args

    # Full CLI-default namespace (args_to_env reads every tuning attr),
    # then overlay the programmatic params.
    launch_args = parse_args(["placeholder-command"])
    for attr, value in (("num_proc", np), ("hosts", hosts),
                        ("min_np", min_np), ("max_np", max_np),
                        ("host_discovery_script", host_discovery_script),
                        ("reset_limit", reset_limit),
                        ("elastic_timeout", elastic_timeout),
                        ("start_timeout", start_timeout),
                        ("slots", slots)):
        setattr(launch_args, attr, value)
    command = [sys.executable, "-m",
               "horovod_tpu_torch.runner.elastic_run_worker"]
    payload = pickle.dumps((func, tuple(args), dict(kwargs)))
    rc, outcomes, world = launch_elastic(
        launch_args, command, payload=payload, collect_results=True,
        extra_env=env)
    failures = {rank: value for rank, (ok, value) in outcomes.items()
                if not ok}
    if failures:
        raise RuntimeError(
            "elastic run(func) worker failures:\n" + "\n".join(
                f"[rank {r}] {tb}" for r, tb in sorted(failures.items())))
    if rc != 0:
        raise RuntimeError(f"elastic run(func) failed with rc={rc}")
    missing = sorted(set(range(world)) - set(outcomes))
    if missing:
        # A worker that died without publishing (e.g. SIGKILL) must not
        # silently vanish from the result dict.
        raise RuntimeError(
            f"elastic run(func): ranks {missing} of the final "
            f"{world}-rank world returned no result (worker died before "
            "publishing?)")
    return {rank: value for rank, (ok, value) in outcomes.items()}


def _worker_main(fn_payload, slot_env: dict, conn) -> None:
    try:
        import pickle
        os.environ.update(slot_env)
        func, args, kwargs = pickle.loads(fn_payload)
        result = func(*args, **kwargs)
        conn.send((True, result))
    except BaseException:  # noqa: BLE001 - ship traceback to the parent
        conn.send((False, traceback.format_exc()))
    finally:
        conn.close()


def _launch_remote(slot_env: dict, hostname: str, payload: bytes,
                   procs: dict, rank: int) -> int:
    """Run the bootstrap on a remote host: env rides the command line,
    the pickled function rides stdin.  The Popen registers in ``procs``
    so the caller can kill it on error paths."""
    exports = " ".join(f"{k}={shlex.quote(str(v))}"
                       for k, v in slot_env.items())
    script = (f"env {exports} {shlex.quote(sys.executable)} "
              f"-m horovod_tpu_torch.runner.run_worker")
    proc = subprocess.Popen(_ssh_argv(hostname, script),
                            stdin=subprocess.PIPE,
                            stdout=sys.stdout.fileno(),
                            stderr=sys.stderr.fileno())
    procs[rank] = proc
    proc.communicate(payload)
    return proc.returncode


def run(func: Callable, args: Sequence = (), kwargs: dict | None = None,
        np: int | None = None, hosts: str | None = None,
        env: dict | None = None, use_gloo: bool = True,
        start_timeout: float = 120.0,
        min_np: int | None = None, max_np: int | None = None,
        host_discovery_script: str | None = None,
        reset_limit: int | None = None,
        elastic_timeout: float | None = None,
        slots: int | None = None) -> list[Any] | dict[int, Any]:
    """Run ``func(*args, **kwargs)`` on every slot of ``hosts`` (default:
    ``np`` local processes) with the full eager runtime initialized
    (rendezvous, controller, data plane); returns results ordered by rank.
    Remote hosts need this package importable and ssh reachability, the
    same contract as the reference's ``horovod.run``.

    Elastic mode (reference: runner/__init__.py:92-210): pass ``min_np``/
    ``max_np``/``host_discovery_script`` to run under the elastic driver —
    workers are respawned across membership changes and ``func`` decides
    its own fault-tolerance via ``hvd.elastic.run``. Returns
    {final_rank: result} (the world can end a different size than it
    started)."""
    import pickle

    kwargs = kwargs or {}
    if min_np is not None or max_np is not None \
            or host_discovery_script is not None:
        return _run_elastic(func, args, kwargs, np=np, hosts=hosts,
                            env=env, min_np=min_np, max_np=max_np,
                            host_discovery_script=host_discovery_script,
                            reset_limit=reset_limit,
                            elastic_timeout=(600.0 if elastic_timeout
                                             is None else elastic_timeout),
                            start_timeout=start_timeout, slots=slots)
    stray = {name: value for name, value in
             (("reset_limit", reset_limit),
              ("elastic_timeout", elastic_timeout),
              ("slots", slots)) if value is not None}
    if stray:
        raise ValueError(
            f"{sorted(stray)} only apply to elastic mode — also pass "
            "min_np/max_np or host_discovery_script, or drop them.")
    host_list = parse_hosts(hosts) if hosts else None
    world = np or (sum(h.slots for h in host_list) if host_list else 1)
    if host_list is None:
        host_list = parse_hosts(f"localhost:{world}")
    slot_infos = get_host_assignments(host_list, world)
    any_remote = any(not is_local_host(s.hostname) for s in slot_infos)

    server = RendezvousServer()
    port = server.start()
    # Remote workers must reach the rendezvous/KV server over the network;
    # local-only runs stay on loopback.
    addr = socket.gethostbyname(socket.gethostname()) if any_remote \
        else "127.0.0.1"
    payload = pickle.dumps((func, tuple(args), dict(kwargs)))

    ctx = mp.get_context("spawn")
    procs, conns = [], []          # local slots
    remote_threads, remote_rcs = [], {}
    remote_procs: dict[int, subprocess.Popen] = {}
    remote_ranks: list[int] = []
    try:
        host_ids = host_ids_env(slot_infos)
        for slot in slot_infos:
            slot_env = dict(env or {})
            slot_env.update(slot.to_env())
            slot_env["HOROVOD_HOST_IDS"] = host_ids
            slot_env.update(rendezvous_env(addr, port, start_timeout))
            if is_local_host(slot.hostname):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=_worker_main,
                                args=(payload, slot_env, child),
                                daemon=True)
                p.start()
                child.close()
                procs.append((slot.rank, p))
                conns.append((slot.rank, parent))
            else:
                remote_ranks.append(slot.rank)

                def _remote(slot_env=slot_env, hostname=slot.hostname,
                            rank=slot.rank):
                    try:
                        remote_rcs[rank] = _launch_remote(
                            slot_env, hostname, payload, remote_procs,
                            rank)
                    except Exception:  # noqa: BLE001
                        remote_rcs[rank] = -1
                        traceback.print_exc()

                t = threading.Thread(target=_remote, daemon=True,
                                     name="hvd-remote-launch")
                t.start()
                remote_threads.append(t)

        results: list[Any] = [None] * len(slot_infos)
        errors: list[str] = []
        for rank, conn in conns:
            if conn.poll(start_timeout + 600):
                ok, value = conn.recv()
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
            else:
                errors.append(f"rank {rank}: no result (timeout)")
        kv = RendezvousClient("127.0.0.1", port, timeout=30.0) \
            if remote_ranks else None
        for rank in remote_ranks:
            # Poll the KV for the result, but fail FAST when the remote
            # launch already died without posting one (ssh exit 255, bad
            # python, import failure before the bootstrap's try block).
            import time as _time
            deadline = _time.time() + start_timeout + 600
            blob = None
            while _time.time() < deadline:
                blob = kv.get("runfunc", str(rank))
                if blob is not None:
                    break
                rc = remote_rcs.get(rank)
                if rc is not None and rc != 0:
                    errors.append(f"rank {rank} (remote): launch exited "
                                  f"rc={rc} with no result")
                    break
                _time.sleep(0.25)
            else:
                errors.append(f"rank {rank} (remote): no result (timeout)")
            if blob is not None:
                ok, value = pickle.loads(blob)
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank} (remote):\n{value}")
        for _, p in procs:
            p.join(timeout=30)
        for t in remote_threads:
            t.join(timeout=30)
        if errors:
            raise RuntimeError("horovod_tpu_torch.run() worker failures:\n"
                               + "\n".join(errors))
        return results
    finally:
        for _, p in procs:
            if p.is_alive():
                p.terminate()
        for proc in remote_procs.values():
            if proc.poll() is None:
                proc.terminate()
        server.stop()
