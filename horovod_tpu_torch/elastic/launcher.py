"""Elastic launch: wires the rendezvous server, the RPC service and the
elastic driver to per-slot worker processes.

The port's copy of ``horovod_tpu/elastic/launcher.py``.

Upstream: horovod/runner/gloo_run.py:287-323 launch_gloo_elastic.
"""
from __future__ import annotations

import os
import sys
from collections import OrderedDict

from ..common import config as _config
from ..common.logging import logger
from ..runner.hosts import SlotInfo, parse_hosts
from ..runner import safe_shell_exec
from ..runner.launch import PROG
from .discovery import FixedHostDiscovery, HostDiscoveryScript
from .driver import ElasticDriver
from .rpc import SECRET_ENV, RpcServer, make_secret
from .worker import DRIVER_ADDR_ENV, DRIVER_PORT_ENV

from ..runner.hosts import is_local_host as _is_local  # noqa: E402


def _make_discovery(args):
    if getattr(args, "host_discovery_script", None):
        return HostDiscoveryScript(args.host_discovery_script,
                                   default_slots=getattr(args, "slots", None)
                                   or 1)
    hosts = getattr(args, "hosts", None)
    if not hosts:
        raise ValueError(
            "elastic run requires --host-discovery-script or -H/--hosts")
    fixed = OrderedDict((h.hostname, h.slots) for h in parse_hosts(hosts))
    return FixedHostDiscovery(fixed)


def _driver_address(discovery, network_interface: str | None = None) -> str:
    hosts = discovery.find_available_hosts_and_slots()
    if all(_is_local(h) for h in hosts):
        return "127.0.0.1"
    if network_interface:
        # --network-interface pins the advertised NIC on multi-NIC head
        # nodes (same contract as the static launch path).
        from ..runner.driver_service import candidate_addresses
        return candidate_addresses(network_interface)[0]
    import socket
    return socket.getfqdn()


def launch_elastic(args, command: list[str], *,
                   payload: bytes | None = None,
                   collect_results: bool = False,
                   extra_env: dict | None = None):
    """Drive an elastic world of `command` workers.

    With ``payload``/``collect_results`` (the programmatic
    ``run(func, min_np=...)`` path), the pickled function is seeded into
    the rendezvous KV for elastic_run_worker bootstraps to fetch, and the
    per-final-rank outcomes are read back before teardown; returns
    ``(rc, results, final_world_size)`` then, plain ``rc`` otherwise.
    ``extra_env`` adds user variables to every worker (the static path's
    ``env=`` contract)."""
    discovery = _make_discovery(args)
    secret = make_secret()

    min_np = args.min_np or args.num_proc or 1
    max_np = args.max_np
    driver = ElasticDriver(
        discovery, min_np=min_np, max_np=max_np,
        timeout=args.elastic_timeout if getattr(args, "elastic_timeout",
                                                None) is not None else 600.0,
        reset_limit=getattr(args, "reset_limit", None), secret=secret,
        verbose=bool(getattr(args, "verbose", False)))

    addr = _driver_address(discovery,
                           getattr(args, "network_interface", None))
    from ..runner.launch import start_rendezvous
    rendezvous_servers, addr_spec, rendezvous_port = \
        start_rendezvous(addr)
    rendezvous = rendezvous_servers[0]
    if payload is not None:
        from ..runner.elastic_run_worker import PAYLOAD_SCOPE
        rendezvous.put(PAYLOAD_SCOPE, "blob", payload)
    rpc = RpcServer(driver, secret)

    from ..runner.launch import args_to_env
    base_env = dict(os.environ)
    # Inherited world/round state (e.g. launching from inside a prior
    # worker) would make fresh workers wait for an epoch that never
    # forms or adopt a stale rank.
    for stale in ("HOROVOD_RENDEZVOUS_EPOCH", "HOROVOD_RANK",
                  "HOROVOD_SIZE", "HOROVOD_HOST_IDS"):
        base_env.pop(stale, None)
    base_env.update(extra_env or {})
    base_env.update(args_to_env(args))
    base_env.update({
        "HOROVOD_CONTROLLER": "tcp",
        "HOROVOD_GLOO_TIMEOUT_SECONDS":
            str(getattr(args, "start_timeout", None) or 30),
    })

    def create_worker(slot: SlotInfo) -> int:
        env = dict(base_env)
        env.update({
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_HOSTNAME": slot.hostname,
            "HOROVOD_LOCAL_RANK": str(slot.local_rank),
            "HOROVOD_GLOO_RENDEZVOUS_ADDR": addr_spec,
            "HOROVOD_GLOO_RENDEZVOUS_PORT": str(rendezvous_port),
            DRIVER_ADDR_ENV: addr,
            DRIVER_PORT_ENV: str(rpc.port),
            SECRET_ENV: secret,
        })
        if _is_local(slot.hostname):
            return safe_shell_exec.execute(list(command), env=env,
                                           index=slot.rank)
        import shlex

        from ..runner.hosts import ssh_argv
        # The HMAC secret travels over ssh stdin (`read -r`), never argv —
        # argv is world-readable in the remote host's process list.
        exports = " ".join(
            f"{k}={shlex.quote(str(v))}" for k, v in env.items()
            if k.startswith("HOROVOD_") and k != SECRET_ENV)
        remote = " ".join(shlex.quote(c) for c in command)
        script = (f"read -r {SECRET_ENV} && export {SECRET_ENV} && "
                  f"env {exports} {remote}")
        return safe_shell_exec.execute(
            ssh_argv(slot.hostname, script), env=env, index=None,
            stdin_data=(secret + "\n").encode())

    def _done(rc: int):
        if not collect_results:
            return rc
        # Read per-final-rank outcomes BEFORE the rendezvous stops; keys
        # are epoch-qualified so a stale result from an earlier round's
        # incarnation of a rank is never misattributed to the final round
        # (it would otherwise defeat the caller's "ranks returned no
        # result" guard).  A result may legitimately sit one or more
        # epochs BEHIND the final round — a worker's success can race the
        # final round forming — so earlier epochs are accepted when the
        # publishing slot provably IS the final round's slot for that
        # rank and that slot's process exited cleanly.
        import pickle

        from ..runner.elastic_run_worker import RESULT_SCOPE
        world = driver.world_size()
        final_epoch = driver.current_epoch
        slots = driver.final_slots()
        exit_codes = {name: code
                      for name, (code, _) in driver.get_results().items()}
        fn_results = {}
        for rank in range(world):
            # Bounded lookback: the success-vs-round-formation race spans
            # adjacent rounds, and acceptance needs the final round's
            # exact slot anyway — scanning all history would make
            # teardown O(epochs x world) HTTP gets for ranks that died
            # without publishing.
            for epoch in range(final_epoch, max(final_epoch - 3, 0), -1):
                blob = rendezvous.get(RESULT_SCOPE, f"{epoch}:{rank}")
                if blob is None:
                    continue
                outcome, slot = pickle.loads(blob)
                if epoch == final_epoch or (
                        slot == slots.get(rank)
                        and exit_codes.get(slot, 1) == 0):
                    fn_results[rank] = outcome
                break   # nearer epochs take precedence; stop at first hit
        return rc, fn_results, world

    autoscaler = None
    try:
        try:
            driver.start(args.num_proc or min_np, create_worker)
            if _config.AUTOSCALE.get():
                # Autoscale policy loop (statesync/autoscale.py): the
                # driver-side controller scrapes rank 0's metrics
                # endpoint and moves the target world size with
                # hysteresis; decisions are counters + flight events.
                from ..statesync.autoscale import (AutoscaleController,
                                                   AutoscalePolicy,
                                                   http_source)
                port = _config.METRICS_PORT.get()
                bind = _config.METRICS_BIND.get() or "127.0.0.1"
                if port > 0:
                    autoscaler = AutoscaleController(
                        driver, http_source(f"http://{bind}:{port}/"),
                        AutoscalePolicy(min_np, max_np or min_np * 4))
                    autoscaler.start()
                else:
                    logger.warning(
                        "HOROVOD_AUTOSCALE=1 needs HOROVOD_METRICS_PORT "
                        "(the controller scrapes rank 0's exposition "
                        "endpoint); autoscale disabled")
            driver.join()
            driver.wait_for_workers_exit()
        except (TimeoutError, ValueError) as exc:
            sys.stderr.write(f"{PROG} elastic: {exc}\n")
            return _done(1)
        finally:
            if autoscaler is not None:
                autoscaler.stop()
            driver.shutdown()
            rpc.close()

        if driver.reset_limit_exceeded:
            sys.stderr.write(f"{PROG} elastic: reset limit exceeded\n")
            return _done(1)
        if driver.resume_failed:
            sys.stderr.write(
                f"{PROG} elastic: job could not resume after failure "
                "(insufficient surviving slots)\n")
            return _done(1)
        results = driver.get_results()
        failures = [name for name, (code, _) in results.items()
                    if code != 0]
        if failures and len(failures) == len(results):
            logger.error("all workers failed: %s", ", ".join(failures))
            return _done(1)
        return _done(0)
    finally:
        for srv in rendezvous_servers:
            srv.stop()
