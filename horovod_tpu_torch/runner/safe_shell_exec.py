"""Child-process execution with signal forwarding and output prefixing.

The port's copy of ``horovod_tpu/runner/safe_shell_exec.py`` (upstream
horovod/runner/common/util/safe_shell_exec.py) — run a worker
command, stream its stdout/stderr line-by-line through a prefixing filter
(`[1]<stdout>: ...`), forward SIGINT/SIGTERM to the whole process group,
and make sure orphans die with the launcher.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading

GRACEFUL_TERMINATION_TIME_S = 5


def _tail(stream, prefix: str, sink, buffer: list[str] | None) -> None:
    for raw in iter(stream.readline, b""):
        line = raw.decode(errors="replace")
        if buffer is not None:
            buffer.append(line)
        if prefix:
            sink.write(f"{prefix}{line}")
        else:
            sink.write(line)
        sink.flush()
    stream.close()


def execute(command, env: dict | None = None, index: int | None = None,
            stdout=None, stderr=None, prefix_output: bool = True,
            capture: list[str] | None = None,
            events: list[threading.Event] | None = None,
            stdin_data: bytes | None = None) -> int:
    """Run `command` (list or shell string); returns its exit code.

    `events`: optional termination events — a watcher thread kills the
    child when any is set (used by the elastic driver to stop slots whose
    host was blacklisted).
    `stdin_data`: bytes written to the child's stdin then closed — used to
    hand secrets to remote shells without exposing them in argv."""
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    shell = isinstance(command, str)
    proc = subprocess.Popen(
        command, shell=shell, env=env,
        stdin=subprocess.PIPE if stdin_data is not None else None,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    if stdin_data is not None:
        try:
            proc.stdin.write(stdin_data)
            proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass

    prefixed = prefix_output and index is not None
    out_prefix = f"[{index}]<stdout>: " if prefixed else ""
    err_prefix = f"[{index}]<stderr>: " if prefixed else ""
    threads = [
        threading.Thread(target=_tail, name="hvd-tail",
                         args=(proc.stdout, out_prefix, stdout, capture),
                         daemon=True),
        threading.Thread(target=_tail, name="hvd-tail",
                         args=(proc.stderr, err_prefix, stderr, capture),
                         daemon=True),
    ]
    for t in threads:
        t.start()

    def _kill_group(sig):
        try:
            os.killpg(os.getpgid(proc.pid), sig)
        except (ProcessLookupError, PermissionError):
            pass

    stop_watch = threading.Event()
    if events:
        def _watch():
            while not stop_watch.is_set():
                if any(e.is_set() for e in events):
                    _kill_group(signal.SIGTERM)
                    if proc.poll() is None:
                        stop_watch.wait(GRACEFUL_TERMINATION_TIME_S)
                        _kill_group(signal.SIGKILL)
                    return
                stop_watch.wait(0.1)
        threading.Thread(target=_watch, daemon=True,
                         name="hvd-exec-watch").start()

    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _forward(sig, _frame):
            _kill_group(sig)
        for sig in (signal.SIGINT, signal.SIGTERM):
            prev_handlers[sig] = signal.signal(sig, _forward)
    try:
        proc.wait()
    finally:
        stop_watch.set()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        for t in threads:
            t.join(timeout=1)
    return proc.returncode
