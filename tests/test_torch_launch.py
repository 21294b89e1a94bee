"""The port's launcher (``horovod_tpu_torch/runner``: ``launch.py``,
``hosts.py``, ``driver_service.py``, ``run_api.py``) against the JAX
package's ``horovod_tpu/runner``, on the CPU.

- ``parse_args`` and ``args_to_env`` on the reference's
  ``tests/test_runner.py`` argv cases (and the rest of the flags): equal
  namespaces and equal environments;
- ``parse_hosts``, ``parse_host_files``, ``get_host_assignments``,
  ``host_ids_env``, ``SlotInfo.to_env`` and ``is_local_host`` on the
  reference's host strings, the heterogeneous ``cross_rank`` case too;
- the NIC probe of each package answered by the other's server;
- the starters: ``--use-mpi`` and ``--use-jsrun`` dispatched as the
  reference's (without their tool, exit 2), ``control_plane_env``, the
  replicated control plane of ``start_rendezvous``, ``js_run``'s LSF
  host discovery, rankfile, command and identity adoption and
  ``mpi_run``'s flavors and commands against the reference's on the same
  arguments (the reference's ``TestJsRun`` and ``TestMpiLauncher``), and
  a ``--use-mpi`` world of two port ranks through a stub ``mpirun``;
- what is refused: ``--fleet`` raises ``NotImplementedError`` naming
  ROADMAP item 12;
- a static 2-rank launch of a port worker that allreduces, a failing one,
  and ``hvd.run(fn, np=2)``.
"""
from __future__ import annotations

import io
import os
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu.runner import driver_service as jds
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu_torch.runner import driver_service as tds
from horovod_tpu_torch.runner import hosts as thosts
from horovod_tpu_torch.runner import launch as tlaunch
from torch_sigterm import restore_sigterm  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

ARGV = [
    ["-np", "2", "--fusion-threshold-mb", "32", "--cycle-time-ms", "5",
     "--timeline-filename", "/tmp/t.json", "--no-stall-check",
     "--log-level", "debug", "ls"],
    ["-np", "4", "-H", "a:2,b:2", "--disable-cache", "--cache-capacity",
     "16", "python", "train.py", "--lr", "0.1"],
    ["--hierarchical-allreduce", "--hierarchical-allgather", "--autotune",
     "--autotune-log-file", "/tmp/at.csv", "--timeline-mark-cycles",
     "--stall-check-warning-time-seconds", "30",
     "--stall-check-shutdown-time-seconds", "90", "true"],
    ["--min-np", "2", "--max-np", "4", "--host-discovery-script",
     "./d.sh", "--slots", "2", "--reset-limit", "3", "--elastic-timeout",
     "30", "--network-interface", "eth0", "--start-timeout", "20",
     "python", "t.py"],
    ["--fleet-publish-steps", "10", "--fleet-interval", "2.5",
     "--ssh-port", "2222", "--ssh-identity-file", "/k", "--verbose",
     "--use-gloo", "x"],
]


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a[:3]))
def test_args_and_env_match_the_reference(argv):
    ref, port = jlaunch.parse_args(argv), tlaunch.parse_args(argv)
    assert vars(port) == vars(ref)
    assert tlaunch.args_to_env(port) == jlaunch.args_to_env(ref)


def test_config_file_matches_the_reference(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent("""\
        fusion-threshold-mb: 16
        start-timeout: 60
        log-level: info
    """))
    argv = ["-np", "2", "--config-file", str(cfg), "--log-level", "error",
            "ls"]
    port = tlaunch.parse_args(argv)
    assert vars(port) == vars(jlaunch.parse_args(argv))
    assert port.fusion_threshold_mb == 16
    assert port.start_timeout == 60       # default overridden by file
    assert port.log_level == "error"      # CLI wins over file


def test_version_and_check_build():
    out = io.StringIO()
    tlaunch.check_build(out)
    text = out.getvalue()
    assert text.startswith("horovodrun-tpu-torch ")
    assert "[X] PyTorch" in text and "[X] TCP data plane" in text
    assert "[ ] MPI" in text and "JAX" not in text


HOST_CASES = [
    ("a:2,b:4", 6, None), ("justhost", 1, None), ("a:2,b:2", 4, None),
    ("a:1,b:2", 3, None), ("a:4", 2, 2), ("h:2", 2, None),
    ("a:3,b:1,c:2", 5, 6), ("localhost:1,127.0.0.1:1,127.0.0.2:1", 3, None),
]


@pytest.mark.parametrize("hosts,min_np,max_np", HOST_CASES)
def test_host_assignments_match_the_reference(hosts, min_np, max_np):
    ref_hosts, port_hosts = jhosts.parse_hosts(hosts), \
        thosts.parse_hosts(hosts)
    assert [vars(h) for h in port_hosts] == [vars(h) for h in ref_hosts]
    ref = jhosts.get_host_assignments(ref_hosts, min_np, max_np)
    port = thosts.get_host_assignments(port_hosts, min_np, max_np)
    assert [vars(s) for s in port] == [vars(s) for s in ref]
    assert [s.to_env() for s in port] == [s.to_env() for s in ref]
    assert thosts.host_ids_env(port) == jhosts.host_ids_env(ref)


def test_heterogeneous_cross_rank():
    # host b's local_rank-1 slot is the only one: cross_size 1.
    slots = thosts.get_host_assignments(thosts.parse_hosts("a:1,b:2"), 3)
    b1 = [s for s in slots if s.hostname == "b" and s.local_rank == 1][0]
    assert b1.cross_size == 1 and b1.cross_rank == 0
    a0 = [s for s in slots if s.hostname == "a"][0]
    assert a0.cross_size == 2 and a0.cross_rank == 0
    assert thosts.host_ids_env(slots) == "0,1,1"


def test_insufficient_slots_match_the_reference():
    msgs = []
    for mod in (jhosts, thosts):
        with pytest.raises(ValueError, match="only 2 slots") as info:
            mod.get_host_assignments(mod.parse_hosts("a:2"), 3)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_hostfile_and_local_hosts(tmp_path):
    f = tmp_path / "hostfile"
    f.write_text("# comment\nhost1 slots=2\nhost2 slots=4\nhost3\n")
    assert thosts.parse_host_files(str(f)) == \
        jhosts.parse_host_files(str(f)) == "host1:2,host2:4,host3:1"
    for name in ("localhost", "127.0.0.1", "127.0.0.2", "127.1.2.3",
                 "128.0.0.1", "hostA", "127.0.0"):
        assert thosts.is_local_host(name) == jhosts.is_local_host(name)
    assert thosts.ssh_argv("h", "echo a b") == jhosts.ssh_argv("h",
                                                               "echo a b")


@pytest.mark.parametrize("server_mod,probe_mod",
                         [(tds, jds), (jds, tds)], ids=["port-ref",
                                                        "ref-port"])
def test_probe_answers_across_packages(server_mod, probe_mod):
    server = server_mod.ProbeServer()
    try:
        got = probe_mod.probe(["127.0.0.1", "192.0.2.1"], server.port,
                              timeout=1.0)
    finally:
        server.close()
    assert got == ["127.0.0.1"]
    if server_mod is tds:
        # The port's close wakes the accept; the reference's waits out
        # its join's 5 s (ROADMAP C).
        assert not server._thread.is_alive()


def test_discover_common_interfaces_drops_a_decoy():
    def local_exec(hostname, argv):
        argv = list(argv)
        argv[-2] = argv[-2] + ",192.0.2.1"       # TEST-NET, unroutable
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=60, env=dict(os.environ,
                                                  PYTHONPATH=REPO))
        assert out.returncode == 0, out.stderr
        return out.stdout

    common = tds.discover_common_interfaces(["hostA"], local_exec,
                                            timeout=2.0)
    assert common and "192.0.2.1" not in common
    assert set(common) <= set(tds.candidate_addresses())


@pytest.mark.parametrize("argv,what", [
    (["--fleet", "-np", "2", "true"], "--fleet"),
])
def test_unported_starters_raise(argv, what):
    with pytest.raises(NotImplementedError, match="item 12") as info:
        tlaunch.main(argv)
    assert what in str(info.value)


@pytest.mark.parametrize("argv", [
    ["--use-mpi", "-np", "2", "true"],
    ["--use-jsrun", "-np", "2", "true"],
], ids=["use-mpi", "use-jsrun"])
def test_starters_without_their_tool_exit_2(argv, tmp_path, monkeypatch,
                                            capsys):
    """No ``mpirun`` on PATH, no LSF allocation and no ``-H``: both
    packages write why and exit 2."""
    monkeypatch.setenv("PATH", str(tmp_path))
    for k in ("LSB_JOBID", "LSB_MCPU_HOSTS", "LSB_HOSTS"):
        monkeypatch.delenv(k, raising=False)
    assert tlaunch.main(list(argv)) == 2
    ours = capsys.readouterr().err
    assert jlaunch.main(list(argv)) == 2
    theirs = capsys.readouterr().err
    assert ours.replace("horovodrun-tpu-torch", "X") == \
        theirs.replace("horovodrun-tpu", "X")


def test_use_mpi_with_min_np_is_elastic(monkeypatch):
    """``--use-mpi`` with ``--min-np`` takes the elastic path in both
    packages (the starter flag does not apply there)."""
    argv = ["--use-mpi", "--min-np", "1", "-H", "localhost:1", "true"]
    seen = {}
    for side, mod in (("port", tlaunch), ("ref", jlaunch)):
        monkeypatch.setattr(mod, "launch_elastic", lambda args, cmd, s=side:
                            seen.setdefault(s, (args.use_mpi, cmd)) and 0)
        monkeypatch.setattr(mod, "launch_static", lambda args, cmd:
                            pytest.fail("the static path"))
        assert mod.main(list(argv)) == 0
    assert seen["port"] == seen["ref"] == (True, ["true"])


@pytest.mark.parametrize("hosts,interface", [
    ("localhost:2", None), ("127.0.0.1:1,localhost:1", None)])
def test_control_plane_env_matches_the_reference(hosts, interface):
    argv = ["-np", "2", "--fusion-threshold-mb", "8", "--start-timeout",
            "45", "true"]
    env = tlaunch.control_plane_env(tlaunch.parse_args(argv),
                                    thosts.parse_hosts(hosts), 4711,
                                    layout=hosts)
    assert env == jlaunch.control_plane_env(
        jlaunch.parse_args(argv), jhosts.parse_hosts(hosts), 4711,
        layout=hosts)
    assert env["HOROVOD_JSRUN_HOSTS"] == hosts
    assert env["HOROVOD_GLOO_RENDEZVOUS_ADDR"] == "127.0.0.1"


def test_replicated_control_plane_starts(tmp_path, monkeypatch):
    """``HOROVOD_RENDEZVOUS_REPLICAS=2`` with a WAL directory: a primary
    and two standbys sharing the log, the seed list as the address, as
    the reference's ``start_rendezvous`` returns them; without the
    directory, one in-memory server (both packages)."""
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_REPLICAS", "2")
    shapes = {}
    for side, mod in (("port", tlaunch), ("ref", jlaunch)):
        monkeypatch.setenv("HOROVOD_RENDEZVOUS_WAL_DIR",
                           str(tmp_path / side))
        servers, addr, port = mod.start_rendezvous("127.0.0.1")
        try:
            shapes[side] = (len(servers), len(addr.split(",")),
                            [s.controlplane.role for s in servers])
            assert port == servers[0].port
            assert addr == ",".join(f"127.0.0.1:{s.port}" for s in servers)
        finally:
            for s in servers:
                s.stop()
        monkeypatch.delenv("HOROVOD_RENDEZVOUS_WAL_DIR")
        servers, addr, port = mod.start_rendezvous("127.0.0.1")
        try:
            assert (len(servers), addr) == (1, "127.0.0.1")
            assert servers[0].controlplane is None
        finally:
            servers[0].stop()
    assert shapes["port"] == shapes["ref"] == \
        (3, 3, ["primary", "standby", "standby"])
    monkeypatch.setenv("PATH", str(tmp_path))
    assert tlaunch.launch_mpi(tlaunch.parse_args(["true"]), ["true"]) == 2


# --- js_run (the reference's TestJsRun) -------------------------------------
LSF_ENVS = [
    {"LSB_MCPU_HOSTS": "batch1 1 c1 4 c2 4"},
    {"LSB_MCPU_HOSTS": "c1 4"},
    {"LSB_MCPU_HOSTS": "a 1 b 1"},
    {"LSB_HOSTS": "batch1 c1 c1 c2 c2"},
    {"LSB_MCPU_HOSTS": "c1 4", "HOROVOD_LSF_COMPUTE_HOSTS": "x:8"},
    {},
]


@pytest.mark.parametrize("env", LSF_ENVS)
@pytest.mark.parametrize("launch_node", [False, True])
def test_lsf_hosts_match_the_reference(env, launch_node):
    from horovod_tpu.runner import js_run as jjs
    from horovod_tpu_torch.runner import js_run as tjs
    got = tjs.lsf_hosts_string(dict(env), include_launch_node=launch_node)
    assert got == jjs.lsf_hosts_string(dict(env),
                                       include_launch_node=launch_node)
    assert tjs.using_lsf(env) is jjs.using_lsf(env)
    if env.get("LSB_MCPU_HOSTS") == "batch1 1 c1 4 c2 4":
        assert got == ("batch1:1,c1:4,c2:4" if launch_node else
                       "c1:4,c2:4")


@pytest.mark.parametrize("lines", ["batch1\nc1\nc1\nc2\nc2\n",
                                   "batch1\nc1\nc2\nc1\nc2\n"])
def test_lsf_hostfile_matches_the_reference(tmp_path, lines):
    from horovod_tpu.runner import js_run as jjs
    from horovod_tpu_torch.runner import js_run as tjs
    hf = tmp_path / "djob"
    hf.write_text(lines)
    env = {"LSB_DJOB_HOSTFILE": str(hf), "LSB_JOBID": "1"}
    assert tjs.lsf_hosts_string(env) == jjs.lsf_hosts_string(env) == \
        "c1:2,c2:2"


@pytest.mark.parametrize("hosts,np,cores", [("c1:2,c2:2", 4, 4),
                                            ("c1:4,c2:2", 6, 3),
                                            ("c1:1", 1, 16)])
def test_jsrun_rankfile_matches_the_reference(tmp_path, hosts, np, cores):
    from horovod_tpu.runner import js_run as jjs
    from horovod_tpu_torch.runner import js_run as tjs
    texts = []
    for mod, hmod in ((tjs, thosts), (jjs, jhosts)):
        slots = hmod.get_host_assignments(hmod.parse_hosts(hosts), np)
        path = mod.generate_jsrun_rankfile(
            slots, cores_per_slot=cores, path=str(tmp_path / "rf.erf"))
        texts.append(open(path).read())
    assert texts[0] == texts[1]
    assert "cpu_index_using: logical" in texts[0]


def test_jsrun_rankfile_requires_explicit_cores(tmp_path, monkeypatch):
    from horovod_tpu_torch.runner import js_run as tjs
    monkeypatch.delenv(tjs.CPU_PER_SLOT_ENV, raising=False)
    slots = thosts.get_host_assignments(thosts.parse_hosts("c1:2"), 2)
    with pytest.raises(ValueError, match="cores per"):
        tjs.generate_jsrun_rankfile(slots, path=str(tmp_path / "rf.erf"))
    monkeypatch.setenv(tjs.CPU_PER_SLOT_ENV, "2")
    text = open(tjs.generate_jsrun_rankfile(
        slots, path=str(tmp_path / "rf.erf"))).read()
    assert "rank: 1: { hostname: c1; cpu: {2-3} }" in text


@pytest.mark.parametrize("kw", [
    dict(rankfile="rf.erf", env_overrides={"HOROVOD_GLOO_RENDEZVOUS_PORT":
                                           "1234"},
         output_filename="out.log"),
    dict(np=8, rs_per_host=4),
    dict(np=2, rs_per_host=1, env_overrides={"B": "2", "A": "1"}),
])
def test_jsrun_command_matches_the_reference(kw):
    from horovod_tpu.runner import js_run as jjs
    from horovod_tpu_torch.runner import js_run as tjs
    cmd = tjs.build_jsrun_command(["python", "train.py"], **kw)
    assert cmd == jjs.build_jsrun_command(["python", "train.py"], **kw)
    assert cmd[0] == "jsrun" and cmd[-2:] == ["python", "train.py"]


ADOPT_ENVS = [
    {"JSM_NAMESPACE_RANK": "5", "JSM_NAMESPACE_SIZE": "8",
     "JSM_NAMESPACE_LOCAL_RANK": "1", "JSM_NAMESPACE_LOCAL_SIZE": "4",
     "HOROVOD_GLOO_RENDEZVOUS_ADDR": "10.0.0.1"},
    {"JSM_NAMESPACE_RANK": "2", "JSM_NAMESPACE_SIZE": "4"},
    {"HOROVOD_RANK": "0", "JSM_NAMESPACE_RANK": "5",
     "JSM_NAMESPACE_SIZE": "8"},
    {},
    {"JSM_NAMESPACE_RANK": "4", "JSM_NAMESPACE_SIZE": "6",
     "HOROVOD_JSRUN_HOSTS": "c1:4,c2:2"},
    {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4"},
    {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2",
     "HOROVOD_GLOO_RENDEZVOUS_ADDR": "10.0.0.1"},
    {"PMI_RANK": "3", "PMI_SIZE": "4", "HOROVOD_JSRUN_HOSTS": "h:4",
     "OMPI_COMM_WORLD_LOCAL_RANK": "3"},
    {"JSM_NAMESPACE_RANK": "1", "JSM_NAMESPACE_SIZE": "4",
     "JSM_NAMESPACE_LOCAL_RANK": "0", "HOROVOD_JSRUN_HOSTS": "c1:2,c2:2"},
]


@pytest.mark.parametrize("env", ADOPT_ENVS)
def test_adopt_jsm_env_matches_the_reference(env):
    from horovod_tpu.runner import js_run as jjs
    from horovod_tpu_torch.runner import js_run as tjs
    out = []
    for mod in (tjs, jjs):
        e = dict(env)
        try:
            out.append((mod.adopt_jsm_env(e), e))
        except RuntimeError as exc:
            out.append(("raised", str(exc)))
    assert out[0] == out[1]


def test_init_adopts_the_ompi_identity(monkeypatch):
    """``core.init`` adopts the identity before it resolves the world:
    ``OMPI_COMM_WORLD_*`` and the exported layout give rank 0 of a world
    of one here."""
    import horovod_tpu_torch as hvd
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "0")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "1")
    monkeypatch.setenv("HOROVOD_JSRUN_HOSTS", "localhost:1")
    before = set(os.environ)
    hvd.init()
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank()) == (0, 1, 0)
        assert os.environ["HOROVOD_RANK"] == "0"
        assert os.environ["HOROVOD_HOST_IDS"] == "0"
    finally:
        hvd.shutdown()
        for k in set(os.environ) - before:   # what the adoption set
            del os.environ[k]


def test_lsf_allocation_dispatches_to_jsrun(tmp_path, monkeypatch):
    """Inside an LSF job with ``jsrun`` on PATH and remote hosts, the
    static launch takes jsrun and the allocation's hosts, as the
    reference's does; ``--use-gloo`` keeps the ssh starter."""
    from horovod_tpu.runner import js_run as jjs
    from horovod_tpu_torch.runner import js_run as tjs
    stub = tmp_path / "jsrun"
    stub.write_text("#!/bin/sh\nexit 0\n")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path) + os.pathsep +
                       os.environ["PATH"])
    monkeypatch.setenv("LSB_JOBID", "7")
    monkeypatch.setenv("LSB_MCPU_HOSTS", "batch1 1 c1 2 c2 2")
    seen = {}
    for side, js in (("port", tjs), ("ref", jjs)):
        monkeypatch.setattr(js, "launch_jsrun", lambda args, cmd, s=side:
                            seen.setdefault(s, (args.hosts, cmd)) and 0)
    assert tlaunch.main(["-np", "4", "python", "t.py"]) == 0
    assert jlaunch.main(["-np", "4", "python", "t.py"]) == 0
    assert seen["port"] == seen["ref"] == ("c1:2,c2:2", ["python", "t.py"])


# --- mpi_run (the reference's TestMpiLauncher) ------------------------------
@pytest.mark.parametrize("flavor", ["openmpi", "spectrum", "unknown",
                                    "mpich", "intel"])
@pytest.mark.parametrize("kw", [
    dict(np=2, hosts="h1:1,h2:1"),
    dict(np=4, ssh_port=2222, extra_mpi_args="--tag-output -v"),
])
def test_mpi_command_matches_the_reference(flavor, kw):
    from horovod_tpu.runner import mpi_run as jmpi
    from horovod_tpu_torch.runner import mpi_run as tmpi
    env = {"HOROVOD_RANK": "0", "HOROVOD_CYCLE_TIME": "5",
           "PATH": "/bin", "OTHER": "x"}
    cmd = tmpi.build_mpi_command(["python", "x.py"], env=env,
                                 mpi_flavor=flavor, **kw)
    assert cmd == jmpi.build_mpi_command(["python", "x.py"], env=env,
                                         mpi_flavor=flavor, **kw)
    ompi = flavor not in ("mpich", "intel")
    assert ("--allow-run-as-root" in cmd) is ompi
    assert ("-genvlist" in cmd) is not ompi


@pytest.mark.parametrize("text", [
    "mpirun (Open MPI) 4.1.0", "IBM Spectrum MPI 10.4",
    "HYDRA build details: MPICH 4.0", "Intel(R) MPI Library 2021",
    "something else"])
def test_mpi_flavor_matches_the_reference(text):
    from horovod_tpu.runner import mpi_run as jmpi
    from horovod_tpu_torch.runner import mpi_run as tmpi
    assert tmpi.flavor(version_text=text) == jmpi.flavor(version_text=text)
    assert tmpi.flavor({"PATH": "/nonexistent"}) == "none"


_MPIRUN_STUB = textwrap.dedent("""\
    #!/usr/bin/env python3
    import os, subprocess, sys
    argv = sys.argv[1:]
    if argv and argv[0] == "--version":
        print("Open MPI 4.1.0"); sys.exit(0)
    arity = {"-np": 1, "-H": 1, "-bind-to": 1, "-map-by": 1,
             "-mca": 2, "-x": 1, "--allow-run-as-root": 0}
    np = 1; i = 0
    while i < len(argv):
        if argv[i] in arity:
            if argv[i] == "-np":
                np = int(argv[i + 1])
            i += 1 + arity[argv[i]]
        else:
            break
    cmd = argv[i:]
    procs = []
    for r in range(np):
        env = dict(os.environ)
        env["OMPI_COMM_WORLD_RANK"] = str(r)
        env["OMPI_COMM_WORLD_SIZE"] = str(np)
        procs.append(subprocess.Popen(cmd, env=env))
    sys.exit(max(p.wait() for p in procs))
""")


def test_use_mpi_end_to_end(tmp_path):
    """``--use-mpi`` drives one mpirun (a stub that starts N local
    copies with ``OMPI_COMM_WORLD_*``); the port's workers adopt their
    identity from those and the exported layout, then allreduce."""
    stub = tmp_path / "mpirun"
    stub.write_text(_MPIRUN_STUB)
    stub.chmod(0o755)
    worker = tmp_path / "train.py"
    worker.write_text(textwrap.dedent("""\
        import os
        import torch
        import horovod_tpu_torch as hvd
        torch.set_num_threads(1)
        assert "HOROVOD_RANK" not in os.environ
        hvd.init()
        out = hvd.allreduce(torch.ones(3), op=hvd.Sum, name="mpi_e2e")
        assert hvd.size() == 2 and out[0] == 2.0, (hvd.size(), out)
        assert hvd.rank() == int(os.environ["OMPI_COMM_WORLD_RANK"])
        assert os.environ["HOROVOD_JSRUN_HOSTS"] == "localhost:2"
        assert hvd.local_size() == 2 and hvd.cross_size() == 1
        print(f"MPI_RANK{hvd.rank()}_OK", flush=True)
        hvd.shutdown()
    """))
    env = _clean_env()
    env["PATH"] = str(tmp_path) + os.pathsep + env["PATH"]
    env["HOROVOD_RENDEZVOUS_EPOCH"] = "mpi-e2e"
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "--use-mpi", "-np", "2", sys.executable, str(worker)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MPI_RANK0_OK" in proc.stdout
    assert "MPI_RANK1_OK" in proc.stdout


def _clean_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env.update(PYTHONPATH=os.pathsep.join([REPO, TESTS]),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return env


def test_static_launch_of_two_ranks(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(textwrap.dedent("""\
        import os
        import torch
        import horovod_tpu_torch as hvd
        torch.set_num_threads(1)
        hvd.init()
        out = hvd.allreduce(torch.ones(4) * (hvd.rank() + 1), op=hvd.Sum,
                            name="e2e")
        assert out.tolist() == [3.0] * 4, out
        assert os.environ["HOROVOD_HOST_IDS"] == "0,0"
        assert hvd.local_size() == 2 and hvd.cross_size() == 1
        print(f"rank {hvd.rank()} OK", flush=True)
        hvd.shutdown()
    """))
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--cycle-time-ms", "2", sys.executable, str(script)],
        env=_clean_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[0]<stdout>: rank 0 OK" in proc.stdout
    assert "[1]<stdout>: rank 1 OK" in proc.stdout


def test_static_failure_propagates(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text("import sys; sys.exit(3)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
         "-np", "2", sys.executable, str(script)],
        env=_clean_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    assert "horovodrun-tpu-torch: ranks failed: [(0, 3), (1, 3)]" in \
        proc.stderr


def test_programmatic_static_run():
    code = ("import horovod_tpu_torch as hvd\n"
            "from torch_elastic_worker import run_fn\n"
            "print('RESULT', hvd.run(run_fn, args=(2.0,), np=2,\n"
            "      env={'TEST_ELASTIC_RUN_MARKER': 'static'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    assert line[-1] == "RESULT " + str([
        {"rank": r, "size": 2, "sum": 4.0, "marker": "static"}
        for r in range(2)])


def test_elastic_only_params_rejected_on_static_path():
    import horovod_tpu_torch as hvd
    with pytest.raises(ValueError, match="elastic mode"):
        hvd.run(len, args=([1],), np=1, reset_limit=3)
