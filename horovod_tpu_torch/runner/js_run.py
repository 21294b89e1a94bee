"""jsrun/LSF launcher for Spectrum-LSF clusters.

The port's copy of ``horovod_tpu/runner/js_run.py`` (upstream
horovod/runner/js_run.py and horovod/runner/util/lsf.py): on LSF
clusters ``horovodrun-tpu-torch`` discovers the allocation and launches
one worker per slot through ``jsrun`` with an explicit-resource (ERF)
rankfile instead of ssh.

As in the reference, (a) the allocation is read from LSF's own
environment (``LSB_MCPU_HOSTS`` / ``LSB_DJOB_HOSTFILE``) instead of IBM
CSM's inventory, (b) ``jsrun`` is the *process starter* only, the
control plane staying the port's rendezvous/TCP stack exactly like the
ssh launcher, and (c) each worker adopts its rank from the JSM/PMIx
environment (``JSM_NAMESPACE_RANK`` et al., OMPI and PMI too) and maps
it onto the ``HOROVOD_*`` env contract at ``init()``.
"""
from __future__ import annotations

import os
import shutil

from .hosts import SlotInfo

#: Override knob: explicit compute-host list ("h1:4,h2:4") taking
#: precedence over env parsing, for allocations whose batch node cannot be
#: told apart heuristically.
COMPUTE_HOSTS_ENV = "HOROVOD_LSF_COMPUTE_HOSTS"
#: Override knob: cores bound per slot in the generated ERF rankfile.
CPU_PER_SLOT_ENV = "HOROVOD_JSRUN_CPU_PER_SLOT"
#: Set by launch_jsrun for every rank: the full "h1:4,h2:2" layout, so
#: workers can compute local/cross ranks with the same host-assignment
#: math as the ssh launcher (jsrun cannot hand out per-rank env).
JSRUN_HOSTS_ENV = "HOROVOD_JSRUN_HOSTS"


def using_lsf(env: dict | None = None) -> bool:
    """True when running inside an LSF job (reference: lsf.py:35-37)."""
    return "LSB_JOBID" in (env if env is not None else os.environ)


def jsrun_available(env: dict | None = None) -> bool:
    """True if the ``jsrun`` starter is on PATH (reference:
    js_run.py:27-29)."""
    path = (env if env is not None else os.environ).get("PATH")
    return shutil.which("jsrun", path=path) is not None


def lsf_hosts_string(env: dict | None = None, *,
                     include_launch_node: bool = False) -> str | None:
    """Derive "h1:4,h2:4" from the LSF environment.

    Sources, in order: the :data:`COMPUTE_HOSTS_ENV` override,
    ``LSB_DJOB_HOSTFILE`` (one line per slot), ``LSB_MCPU_HOSTS``
    ("host slots host slots ..."), ``LSB_HOSTS`` (one name per slot).

    LSF prepends the batch/launch node to the allocation; the reference
    filters it out via CSM's compute-node inventory (lsf.py:72-75).
    Without CSM the heuristic is: when several distinct hosts are present
    and the FIRST carries exactly one slot while every other carries more,
    it is the launch node and is dropped (override with
    ``include_launch_node=True`` or the env knob).

    Known limitation: one-task-per-node allocations (``span[ptile=1]``)
    make every host carry one slot, so the batch node is indistinguishable
    from the env alone and is kept — pass ``-H`` explicitly or set
    :data:`COMPUTE_HOSTS_ENV` for such jobs.
    """
    env = env if env is not None else os.environ
    override = env.get(COMPUTE_HOSTS_ENV)
    if override:
        return override

    # Aggregate total slots per hostname, preserving first-seen order —
    # cyclic task distributions repeat hostnames non-consecutively.
    counts: dict[str, int] = {}

    def _add(name: str, slots: int = 1) -> None:
        counts[name] = counts.get(name, 0) + slots

    hostfile = env.get("LSB_DJOB_HOSTFILE")
    if hostfile and os.path.exists(hostfile):
        with open(hostfile) as f:
            for ln in f:
                if ln.strip():
                    _add(ln.strip())
    elif env.get("LSB_MCPU_HOSTS"):
        toks = env["LSB_MCPU_HOSTS"].split()
        for i in range(0, len(toks), 2):
            _add(toks[i], int(toks[i + 1]))
    elif env.get("LSB_HOSTS"):
        for name in env["LSB_HOSTS"].split():
            _add(name)
    if not counts:
        return None
    pairs = list(counts.items())

    if (not include_launch_node and len(pairs) > 1
            and pairs[0][1] == 1
            and all(slots > 1 for _, slots in pairs[1:])):
        pairs = pairs[1:]
    return ",".join(f"{name}:{slots}" for name, slots in pairs)


def generate_jsrun_rankfile(slots: list[SlotInfo], *,
                            cores_per_slot: int | None = None,
                            path: str) -> str:
    """Write an explicit-resource (ERF) rankfile binding each rank to a
    disjoint logical-CPU range on its host (reference: js_run.py:96-146,
    which splits cores evenly per experiment).

    The reference derives cores-per-slot from CSM + remote lscpu; neither
    exists here and the *launch* node's cpu_count says nothing
    about the compute nodes, so the count must come from the caller or
    :data:`CPU_PER_SLOT_ENV` — guessing would mis-pin every rank.  No
    accelerator resources are declared: cards are not scheduled by
    jsrun; each rank takes ``cuda:<local_rank>`` at runtime.
    """
    if cores_per_slot is None:
        env_val = os.environ.get(CPU_PER_SLOT_ENV)
        if not env_val:
            raise ValueError(
                "ERF rankfile generation needs the compute-node cores per "
                f"slot: set {CPU_PER_SLOT_ENV} (the launch node's CPU "
                "count is not a usable proxy for the compute nodes).")
        cores_per_slot = int(env_val)
    with open(path, "w") as f:
        f.write("overlapping_rs: allow\ncpu_index_using: logical\n\n")
        for s in slots:
            start = s.local_rank * cores_per_slot
            f.write(f"rank: {s.rank}: {{ hostname: {s.hostname}; "
                    f"cpu: {{{start}-{start + cores_per_slot - 1}}} }}\n")
    return path


def build_jsrun_command(command: list[str], *,
                        np: int | None = None,
                        rs_per_host: int | None = None,
                        rankfile: str | None = None,
                        env_overrides: dict[str, str] | None = None,
                        output_filename: str | None = None) -> list[str]:
    """Build the ``jsrun`` argv (reference: js_run.py:72-82, minus the
    MPI --smpiargs plumbing — the data plane here is not MPI).

    Two placement modes: an ERF ``rankfile`` (explicit CPU pinning, needs
    the compute-node core count), or resource-set flags ``np`` +
    ``rs_per_host`` (one task per resource set; jsrun divides each host's
    CPUs evenly, no core-count knowledge needed — the default).
    """
    cmd = ["jsrun"]
    if rankfile is not None:
        cmd += ["--erf_input", rankfile]
    else:
        # --bind none: jsrun's default gives each resource set ONE CPU;
        # unbound tasks match the ssh launcher's unpinned behavior.
        # --launch_distribution packed: consecutive ranks fill each host
        # in turn — the same host-major order get_host_assignments uses,
        # so rank adoption from JSRUN_HOSTS_ENV matches real placement.
        cmd += ["--nrs", str(np), "--tasks_per_rs", "1",
                "--rs_per_host", str(rs_per_host), "--bind", "none",
                "--launch_distribution", "packed"]
    if output_filename:
        cmd += ["--stdio_stdout", output_filename,
                "--stdio_stderr", output_filename]
    for name in sorted(env_overrides or {}):
        cmd += ["-E", f"{name}={env_overrides[name]}"]
    return cmd + list(command)


def adopt_jsm_env(env: dict | None = None) -> bool:
    """Map JSM/PMIx rank identity onto the ``HOROVOD_*`` env contract.

    jsrun cannot hand each rank a distinct environment the way the ssh
    launcher does (hosts.py SlotInfo.to_env); instead JSM exports
    ``JSM_NAMESPACE_{RANK,SIZE}`` (PMIx fallbacks: ``PMIX_RANK``,
    OMPI_COMM_WORLD_*) per task, and :func:`launch_jsrun` exports the full
    host layout in :data:`JSRUN_HOSTS_ENV` — so every worker derives its
    local/cross ranks from the SAME ``get_host_assignments`` math the ssh
    launcher uses, which stays correct for non-uniform slot counts.

    Called at ``init()``; a no-op unless the JSM identity is present and
    ``HOROVOD_RANK`` is not already set.  Returns True when the contract
    was populated.
    """
    env = env if env is not None else os.environ
    if "HOROVOD_RANK" in env:
        return False
    def _first(*names):
        for name in names:
            if name in env:
                return env[name]
        return None

    # JSM (jsrun), OpenMPI, PMIx, and Hydra/PMI (MPICH, Intel MPI).
    rank = _first("JSM_NAMESPACE_RANK", "OMPI_COMM_WORLD_RANK",
                  "PMIX_RANK", "PMI_RANK")
    size = _first("JSM_NAMESPACE_SIZE", "OMPI_COMM_WORLD_SIZE",
                  "PMI_SIZE")
    if rank is None or size is None:
        return False
    if JSRUN_HOSTS_ENV not in env \
            and "HOROVOD_GLOO_RENDEZVOUS_ADDR" not in env:
        # JSM/OMPI/PMIx identity WITHOUT one of our launchers'
        # control-plane env: a bare `mpirun`/`jsrun` of a script where
        # each process expects an independent size-1 world — adopting a
        # multi-rank world with no rendezvous to form it would only turn
        # working scripts into init-time failures.
        return False
    rank, size = int(rank), int(size)
    hosts_string = env.get(JSRUN_HOSTS_ENV)
    if hosts_string:
        from .hosts import get_host_assignments, host_ids_env, parse_hosts
        assignments = get_host_assignments(parse_hosts(hosts_string), size)
        slot = assignments[rank]
        jsm_local = env.get("JSM_NAMESPACE_LOCAL_RANK")
        if jsm_local is not None and int(jsm_local) != slot.local_rank:
            # jsrun placed this task somewhere other than the host-major
            # order the layout math assumes — wrong local ranks would
            # double-bind cards. Fail loudly with the escape hatch.
            raise RuntimeError(
                f"jsrun placement mismatch: rank {rank} has JSM local "
                f"rank {jsm_local} but host-major layout expects "
                f"{slot.local_rank}; launch with {CPU_PER_SLOT_ENV} set "
                "(ERF rankfile pins placement explicitly).")
        env.update(slot.to_env())
        env["HOROVOD_HOST_IDS"] = host_ids_env(assignments)
        return True
    # Bare JSM/PMIx launch (no layout exported): rank/size and the local
    # identity are per-rank facts JSM provides directly.  The cross
    # topology is NOT derivable here — dividing size by a per-rank
    # local_size gives different answers on hosts with different slot
    # counts, and ranks disagreeing on cross_size hangs hierarchical
    # collectives.  Leaving cross unset (init defaults: 0 of 1) is
    # consistent from every rank's view and simply keeps hierarchical
    # paths off.
    local_rank = int(env.get("JSM_NAMESPACE_LOCAL_RANK",
                             env.get("OMPI_COMM_WORLD_LOCAL_RANK", rank)))
    local_size = int(env.get("JSM_NAMESPACE_LOCAL_SIZE",
                             env.get("OMPI_COMM_WORLD_LOCAL_SIZE", 0)) or 0)
    if local_size <= 0:
        local_size = size
    env.update({
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(local_rank),
        "HOROVOD_LOCAL_SIZE": str(local_size),
    })
    return True


def launch_jsrun(args, command: list[str]) -> int:
    """Static launch through jsrun: start the rendezvous server on the
    launch node, emit the ERF rankfile, and exec ONE jsrun covering every
    rank (reference: js_run.py:32-93)."""
    import tempfile

    from . import safe_shell_exec
    from .hosts import get_host_assignments, parse_hosts
    from .launch import control_plane_env
    from .network import RendezvousServer

    hosts = parse_hosts(args.hosts)
    np = args.num_proc or sum(h.slots for h in hosts)
    slots = get_host_assignments(hosts, np)

    server = RendezvousServer()
    port = server.start()
    overrides = control_plane_env(args, hosts, port, layout=args.hosts)
    # Placement: ERF pinning only when the compute-node core count is
    # known (the env knob); otherwise resource-set flags, where jsrun
    # itself splits each host's CPUs — requires uniform slots per host.
    rankfile = None
    slot_counts = {h.slots for h in hosts}
    try:
        if os.environ.get(CPU_PER_SLOT_ENV):
            fd, rankfile = tempfile.mkstemp(suffix=".erf")
            os.close(fd)
            generate_jsrun_rankfile(slots, path=rankfile)
            cmd = build_jsrun_command(
                command, rankfile=rankfile, env_overrides=overrides,
                output_filename=getattr(args, "output_filename", None))
        elif len(slot_counts) == 1:
            cmd = build_jsrun_command(
                command, np=np, rs_per_host=slot_counts.pop(),
                env_overrides=overrides,
                output_filename=getattr(args, "output_filename", None))
        else:
            raise RuntimeError(
                "jsrun launch with non-uniform slots per host needs an "
                f"ERF rankfile: set {CPU_PER_SLOT_ENV} to the "
                "compute-node cores per slot.")
        if args.verbose:
            print(" ".join(cmd))
        return safe_shell_exec.execute(cmd, env=dict(os.environ))
    finally:
        server.stop()
        if rankfile:
            try:
                os.unlink(rankfile)
            except OSError:
                pass
