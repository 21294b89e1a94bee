"""`horovodrun`-equivalent CLI launcher: ``horovodrun-tpu-torch``.

The port's copy of ``horovod_tpu/runner/launch.py`` (upstream
horovod/runner/launch.py): parse flags, map the perf/debug knobs onto
``HOROVOD_*`` env vars (upstream common/util/config_parser.py), compute
rank assignments from the host list, start the rendezvous KV server, and
exec one worker per slot with its env block (upstream
runner/gloo_run.py:133-272). Remote hosts go through ssh; localhost slots
exec directly. `--min-np/--max-np/--host-discovery-script` switches to the
elastic driver.

The flags are the reference's: the ssh starter, the mpirun and jsrun
starters (``--use-mpi``, ``--use-jsrun``, with LSF host discovery;
``mpi_run.py``, ``js_run.py``) and the replicated control plane
(``HOROVOD_RENDEZVOUS_REPLICAS`` with ``HOROVOD_RENDEZVOUS_WAL_DIR``;
``controlplane.py``).  Not ported: the fleet controller (``--fleet``
raises ``NotImplementedError`` naming ROADMAP queue A item 12).

Usage:
    python -m horovod_tpu_torch.runner.launch -np 4 python train.py
    horovodrun-tpu-torch -np 8 -H host1:4,host2:4 python train.py
"""
from __future__ import annotations

import argparse
import os
import shlex
import signal
import sys
import threading

from ..common.logging import logger
from . import safe_shell_exec
from .hosts import (get_host_assignments, host_ids_env, is_local_host,
                    parse_host_files, parse_hosts, SlotInfo)
from .network import RendezvousServer

PROG = "horovodrun-tpu-torch"
LOCAL_HOSTS = ("localhost", "127.0.0.1", "0.0.0.0")
_ITEM_12 = "ROADMAP queue A item 12"


def _is_local(hostname: str) -> bool:
    return hostname in LOCAL_HOSTS or is_local_host(hostname)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="Launch a horovod_tpu_torch distributed training job.")
    parser.add_argument("-v", "--version", action="version",
                        version=_version())
    parser.add_argument("-np", "--num-proc", type=int, default=None,
                        help="Total number of training processes.")
    parser.add_argument("-H", "--hosts", default=None,
                        help='Host list, e.g. "host1:4,host2:4".')
    parser.add_argument("--hostfile", default=None,
                        help='Hostfile with "hostname slots=N" lines.')
    parser.add_argument("--network-interface", default=None,
                        help="NIC(s) for the control plane (sets "
                        "HOROVOD_GLOO_IFACE).")
    parser.add_argument("--ssh-port", type=int, default=None)
    parser.add_argument("--ssh-identity-file", default=None)
    starter = parser.add_mutually_exclusive_group()
    starter.add_argument("--use-gloo", action="store_true",
                         help="Force the rendezvous/ssh process starter "
                         "(the default; disables jsrun auto-detection).")
    starter.add_argument("--use-mpi", action="store_true",
                         help="Start workers through mpirun; ranks adopt "
                         "their identity from the OMPI/PMIx env.")
    starter.add_argument("--use-jsrun", action="store_true",
                         help="Start workers through jsrun (LSF).")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--disable-cache", action="store_true",
                        help="Disable the response cache.")
    parser.add_argument("--start-timeout", type=float, default=600.0)
    parser.add_argument("--check-build", action="store_true",
                        help="Print the build/backend matrix and exit.")

    elastic = parser.add_argument_group("elastic")
    elastic.add_argument("--min-np", type=int, default=None)
    elastic.add_argument("--max-np", type=int, default=None)
    elastic.add_argument("--host-discovery-script", default=None,
                         help="Script printing 'host:slots' lines; polled "
                         "for membership changes.")
    elastic.add_argument("--reset-limit", type=int, default=None)
    elastic.add_argument("--slots", type=int, default=None,
                         help="Default slots per host for discovery-script "
                         "lines without an explicit :slots suffix.")
    elastic.add_argument("--elastic-timeout", type=float, default=600.0,
                         help="Seconds to wait for min-np slots / a new "
                         "rendezvous round.")

    tuning = parser.add_argument_group("tuning")
    tuning.add_argument("--fusion-threshold-mb", type=int, default=None)
    tuning.add_argument("--cycle-time-ms", type=float, default=None)
    tuning.add_argument("--cache-capacity", type=int, default=None)
    tuning.add_argument("--hierarchical-allreduce", action="store_true")
    tuning.add_argument("--hierarchical-allgather", action="store_true")
    tuning.add_argument("--autotune", action="store_true")
    tuning.add_argument("--autotune-log-file", default=None)

    fleet = parser.add_argument_group("fleet")
    fleet.add_argument("--fleet", action="store_true",
                       help=f"The train+serve fleet controller ({_ITEM_12}).")
    fleet.add_argument("--fleet-publish-steps", type=int, default=None,
                       help="Trainer param-snapshot publish cadence in "
                       "steps (0 disables).")
    fleet.add_argument("--fleet-interval", type=float, default=None,
                       help="Fleet controller gauge-poll/decision "
                       "interval in seconds.")

    debug = parser.add_argument_group("debug")
    debug.add_argument("--timeline-filename", default=None)
    debug.add_argument("--timeline-mark-cycles", action="store_true")
    debug.add_argument("--no-stall-check", action="store_true")
    debug.add_argument("--stall-check-warning-time-seconds", type=float,
                       default=None)
    debug.add_argument("--stall-check-shutdown-time-seconds", type=float,
                       default=None)
    debug.add_argument("--log-level", default=None,
                       choices=["trace", "debug", "info", "warning",
                                "error", "fatal"])
    debug.add_argument("--config-file", default=None,
                       help="YAML file with the above options.")

    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Training command to run on every slot.")
    args = parser.parse_args(argv)
    if args.config_file:
        _apply_config_file(args, parser)
    return args


def _version() -> str:
    from .. import __version__
    return f"{PROG} {__version__}"


def _apply_config_file(args, parser) -> None:
    """YAML config support (upstream launch.py:513-517 +
    config_parser.py). A file value applies unless the CLI flag was
    explicitly given (i.e. the arg still holds its parser default)."""
    import yaml
    with open(args.config_file) as f:
        cfg = yaml.safe_load(f) or {}
    for key, value in cfg.items():
        attr = key.replace("-", "_")
        if hasattr(args, attr) and \
                getattr(args, attr) == parser.get_default(attr):
            setattr(args, attr, value)


def args_to_env(args) -> dict[str, str]:
    """Map CLI flags → HOROVOD_* env (upstream config_parser.py)."""
    env: dict[str, str] = {}

    def set_if(cond, name, value):
        if cond:
            env[name] = str(value)

    set_if(args.fusion_threshold_mb is not None, "HOROVOD_FUSION_THRESHOLD",
           (args.fusion_threshold_mb or 0) * 1024 * 1024)
    set_if(args.cycle_time_ms is not None, "HOROVOD_CYCLE_TIME",
           args.cycle_time_ms)
    set_if(args.cache_capacity is not None, "HOROVOD_CACHE_CAPACITY",
           args.cache_capacity)
    set_if(args.disable_cache, "HOROVOD_CACHE_CAPACITY", 0)
    set_if(args.hierarchical_allreduce, "HOROVOD_HIERARCHICAL_ALLREDUCE", 1)
    set_if(args.hierarchical_allgather, "HOROVOD_HIERARCHICAL_ALLGATHER", 1)
    set_if(args.autotune, "HOROVOD_AUTOTUNE", 1)
    set_if(args.autotune_log_file is not None, "HOROVOD_AUTOTUNE_LOG",
           args.autotune_log_file)
    set_if(args.timeline_filename is not None, "HOROVOD_TIMELINE",
           args.timeline_filename)
    set_if(args.timeline_mark_cycles, "HOROVOD_TIMELINE_MARK_CYCLES", 1)
    set_if(args.no_stall_check, "HOROVOD_STALL_CHECK_DISABLE", 1)
    set_if(args.stall_check_warning_time_seconds is not None,
           "HOROVOD_STALL_CHECK_TIME_SECONDS",
           args.stall_check_warning_time_seconds)
    set_if(args.stall_check_shutdown_time_seconds is not None,
           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
           args.stall_check_shutdown_time_seconds)
    set_if(args.log_level is not None, "HOROVOD_LOG_LEVEL", args.log_level)
    set_if(args.network_interface is not None, "HOROVOD_GLOO_IFACE",
           args.network_interface)
    # getattr: programmatic callers (elastic driver, run_api) build the
    # Namespace by hand and may predate the fleet group.
    set_if(getattr(args, "fleet", False), "HOROVOD_FLEET", 1)
    fleet_publish = getattr(args, "fleet_publish_steps", None)
    set_if(fleet_publish is not None,
           "HOROVOD_FLEET_PUBLISH_STEPS", fleet_publish)
    fleet_interval = getattr(args, "fleet_interval", None)
    set_if(fleet_interval is not None, "HOROVOD_FLEET_INTERVAL_S",
           fleet_interval)
    return env


def check_build(out=sys.stdout) -> None:
    """Print the build matrix (upstream launch.py:522-523,
    util.py:137-186)."""
    from .. import eager
    rows = [
        ("NCCL device plane", eager.nccl_built()),
        ("TCP data plane", eager.tcp_built()),
        ("Gloo-compatible control plane", eager.gloo_built()),
        ("MPI", eager.mpi_built()),
    ]
    frameworks = []
    for name, mod in (("PyTorch", "horovod_tpu_torch.torch"),):
        try:
            __import__(mod)
            frameworks.append((name, True))
        except ImportError:
            frameworks.append((name, False))
    out.write(f"{_version()}\n\nAvailable frameworks:\n")
    for name, ok in frameworks:
        out.write(f"    [{'X' if ok else ' '}] {name}\n")
    out.write("\nAvailable backends:\n")
    for name, ok in rows:
        out.write(f"    [{'X' if ok else ' '}] {name}\n")


def rendezvous_env(addr: str, port: int,
                   start_timeout: float) -> dict[str, str]:
    """The env block every worker needs to reach the control plane —
    shared by the ssh, jsrun, elastic and programmatic launch paths so
    the contract can't drift between them.  ``addr`` may be a single
    host or a comma-separated ``host:port`` seed list (replicated control
    plane): ``RendezvousClient`` parses both."""
    return {
        "HOROVOD_GLOO_RENDEZVOUS_ADDR": addr,
        "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port),
        "HOROVOD_CONTROLLER": "tcp",
        "HOROVOD_GLOO_TIMEOUT_SECONDS": str(start_timeout),
    }


def start_rendezvous(advertised_addr: str):
    """Start the rendezvous control plane: one plain in-memory server
    by default, or, under ``HOROVOD_RENDEZVOUS_REPLICAS`` > 0 with
    ``HOROVOD_RENDEZVOUS_WAL_DIR`` set, a WAL-backed primary plus N
    standby replicas that survive coordinator death (standby promotion
    on lease lapse, ``controlplane.py``).  Returns ``(servers,
    addr_spec, port)``; pass ``addr_spec`` (a seed list when
    replicated) to :func:`rendezvous_env` and stop every server at
    teardown."""
    from ..common import config as _config

    replicas = _config.RENDEZVOUS_REPLICAS.get()
    wal_dir = _config.RENDEZVOUS_WAL_DIR.get()
    if replicas > 0 and wal_dir:
        from .controlplane import start_replica_set
        servers, endpoints = start_replica_set(
            replicas, wal_dir, host=advertised_addr)
        return servers, ",".join(endpoints), servers[0].port
    if replicas > 0:
        logger.warning(
            "HOROVOD_RENDEZVOUS_REPLICAS=%d needs "
            "HOROVOD_RENDEZVOUS_WAL_DIR (the replica set shares the "
            "durable log); starting a single un-replicated server",
            replicas)
    server = RendezvousServer()
    port = server.start()
    return [server], advertised_addr, port


def _ssh_command(slot: SlotInfo, command: list[str], env: dict[str, str],
                 args) -> str:
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
    inner = f"cd {shlex.quote(os.getcwd())} > /dev/null 2>&1 ; " \
            f"env {exports} {' '.join(shlex.quote(c) for c in command)}"
    ssh = ["ssh", "-o", "PasswordAuthentication=no",
           "-o", "StrictHostKeyChecking=no"]
    if args.ssh_port:
        ssh += ["-p", str(args.ssh_port)]
    if args.ssh_identity_file:
        ssh += ["-i", args.ssh_identity_file]
    ssh += [slot.hostname, inner]
    return " ".join(shlex.quote(s) if i >= len(ssh) - 1 else s
                    for i, s in enumerate(ssh))


def _refuse_fleet(args) -> None:
    """The reference's fleet controller, which this package does not
    have."""
    if getattr(args, "fleet", False):
        raise NotImplementedError(f"--fleet (the fleet controller) is "
                                  f"{_ITEM_12}")


def launch_static(args, command: list[str]) -> int:
    """Static (non-elastic) launch (upstream gloo_run.py launch_gloo)."""
    from . import js_run
    _refuse_fleet(args)
    if args.hostfile:
        args.hosts = parse_host_files(args.hostfile)
    if args.hosts is None and js_run.using_lsf():
        # Inside an LSF job the allocation IS the host list (upstream
        # launch.py _check_all_hosts_ssh_successful / lsf default hosts).
        args.hosts = js_run.lsf_hosts_string()
    hosts = parse_hosts(args.hosts) if args.hosts else None
    if getattr(args, "use_mpi", False):
        return launch_mpi(args, command)
    if getattr(args, "use_jsrun", False):
        if hosts is None:
            sys.stderr.write(f"{PROG}: --use-jsrun needs -H or an LSF "
                             f"allocation\n")
            return 2
        return js_run.launch_jsrun(args, command)
    if hosts is not None and not getattr(args, "use_gloo", False) and \
            js_run.using_lsf() and js_run.jsrun_available() and \
            not all(_is_local(h.hostname) for h in hosts):
        # jsrun is the process starter on LSF clusters (ssh is usually
        # disabled between compute nodes there); control plane unchanged.
        return js_run.launch_jsrun(args, command)
    np = args.num_proc or (sum(h.slots for h in hosts) if hosts else 1)
    if hosts is None:
        hosts = parse_hosts(f"localhost:{np}")
    slots = get_host_assignments(hosts, np)

    rendezvous_addr = _advertised_address(
        hosts, getattr(args, "network_interface", None))
    servers, addr_spec, port = start_rendezvous(rendezvous_addr)

    base_env = dict(os.environ)
    base_env.update(args_to_env(args))
    base_env.update(rendezvous_env(addr_spec, port,
                                   args.start_timeout))
    # Full rank→host map for topology-aware ring orders (hosts.py).
    base_env["HOROVOD_HOST_IDS"] = host_ids_env(slots)

    exit_codes = [None] * len(slots)
    # Workers run from launcher threads, so signal forwarding must go
    # through a termination event watched inside execute() — the main
    # thread's handler can't reach children started off-main-thread.
    terminate = threading.Event()

    def _run_slot(i: int, slot: SlotInfo) -> None:
        env = dict(base_env)
        env.update(slot.to_env())
        if _is_local(slot.hostname):
            exit_codes[i] = safe_shell_exec.execute(
                command, env=env, index=slot.rank, events=[terminate])
        else:
            remote = _ssh_command(slot, command, env, args)
            exit_codes[i] = safe_shell_exec.execute(
                remote, env=base_env, index=slot.rank, events=[terminate])

    threads = [threading.Thread(target=_run_slot, args=(i, s),
                                daemon=True, name=f"hvd-slot-{i}")
               for i, s in enumerate(slots)]
    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _on_signal(sig, _frame):
            terminate.set()
        for sig in (signal.SIGINT, signal.SIGTERM):
            prev_handlers[sig] = signal.signal(sig, _on_signal)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    except KeyboardInterrupt:
        terminate.set()
        for t in threads:
            t.join(timeout=2 * safe_shell_exec.GRACEFUL_TERMINATION_TIME_S)
        raise
    finally:
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        for srv in servers:
            srv.stop()
    failures = [(s.rank, c) for s, c in zip(slots, exit_codes) if c != 0]
    if failures:
        sys.stderr.write(f"{PROG}: ranks failed: {failures}\n")
        return 1
    return 0


def control_plane_env(args, hosts, port: int,
                      layout: str | None = None) -> dict[str, str]:
    """Worker env block for starters that launch all ranks in one shot
    (mpirun, jsrun): tuning knobs + rendezvous coordinates, plus the host
    layout for rank adoption when the starter cannot hand out per-rank
    env. One definition so the contract can't drift between starters."""
    env = args_to_env(args)
    env.update(rendezvous_env(
        _advertised_address(hosts, getattr(args, "network_interface",
                                           None)),
        port, args.start_timeout))
    if layout:
        from .js_run import JSRUN_HOSTS_ENV
        env[JSRUN_HOSTS_ENV] = layout
    return env


def launch_mpi(args, command: list[str]) -> int:
    """Static launch through mpirun (upstream mpi_run.py / launch.py
    --use-mpi): ONE mpirun invocation starts every rank; mpirun cannot
    hand out per-rank env, so workers adopt their identity from the
    OMPI/PMIx vars plus the exported host layout (the same adoption path
    jsrun uses, ``js_run.adopt_jsm_env``) and dial back to the
    rendezvous server started here.  MPI is the process starter only:
    the control plane stays TCP and the data plane the port's."""
    from .mpi_run import build_mpi_command, mpi_available

    if not mpi_available():
        sys.stderr.write(f"{PROG}: --use-mpi but mpirun is not on PATH\n")
        return 2
    hosts_str = args.hosts or f"localhost:{args.num_proc or 1}"
    hosts = parse_hosts(hosts_str)
    np = args.num_proc or sum(h.slots for h in hosts)

    server = RendezvousServer()
    port = server.start()
    env = dict(os.environ)
    env.update(control_plane_env(args, hosts, port, layout=hosts_str))
    cmd = build_mpi_command(command, np=np, hosts=hosts_str, env=env,
                            ssh_port=args.ssh_port)
    if args.verbose:
        print(" ".join(cmd))
    try:
        return safe_shell_exec.execute(cmd, env=env)
    finally:
        server.stop()


def _advertised_address(hosts, network_interface: str | None = None) -> str:
    """Address the workers should dial for rendezvous: loopback for pure
    local runs; the pinned NIC's address when ``--network-interface`` is
    given (upstream driver_service NIC selection); else this host's
    primary address."""
    if all(_is_local(h.hostname) for h in hosts):
        return "127.0.0.1"
    if network_interface:
        from .driver_service import candidate_addresses
        return candidate_addresses(network_interface)[0]
    import socket
    return socket.getfqdn()


def launch_elastic(args, command: list[str]) -> int:
    _refuse_fleet(args)
    from ..elastic.launcher import launch_elastic as _launch
    return _launch(args, command)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.check_build:
        check_build()
        return 0
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        sys.stderr.write(f"{PROG}: no training command given\n")
        return 2
    if args.host_discovery_script or args.min_np is not None:
        return launch_elastic(args, command)
    return launch_static(args, command)


if __name__ == "__main__":
    sys.exit(main())
