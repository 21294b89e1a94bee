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
- what is refused: ``--use-mpi``, ``--use-jsrun``, ``--fleet`` and the
  replicated control plane raise ``NotImplementedError`` naming ROADMAP
  item 12;
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
    (["--use-mpi", "-np", "2", "true"], "--use-mpi"),
    (["--use-jsrun", "-np", "2", "true"], "--use-jsrun"),
    (["--fleet", "-np", "2", "true"], "--fleet"),
    (["--use-mpi", "--min-np", "1", "-H", "localhost:1", "true"],
     "--use-mpi"),
])
def test_unported_starters_raise(argv, what):
    with pytest.raises(NotImplementedError, match="item 12") as info:
        tlaunch.main(argv)
    assert what in str(info.value)


def test_replicated_control_plane_raises(monkeypatch):
    monkeypatch.setenv("HOROVOD_RENDEZVOUS_REPLICAS", "2")
    with pytest.raises(NotImplementedError, match="item 12"):
        tlaunch.start_rendezvous("127.0.0.1")
    with pytest.raises(NotImplementedError, match="item 12"):
        tlaunch.launch_mpi(tlaunch.parse_args(["true"]), ["true"])


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
