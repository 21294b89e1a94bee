"""A port test that runs the port's ``hvd.init()`` in the pytest process
leaves the process's SIGTERM disposition as it found it
(``tests/torch_sigterm.py``).

Each case runs one such test through ``pytest.main`` in a subprocess whose
SIGTERM handler is set first, then checks that the test did chain the
port's handler while it ran, and that the handler from before is back
afterwards, with the port's chain state reset.  The second case sets the
reference's flight recorder's handler first, as an earlier reference test
in the same worker does: it must survive, since the reference chains its
handler once a process.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_TEST = ("tests/test_torch_imports.py::"
             "test_entry_points_need_cuda_unless_cpu_is_asked")

_SCRIPT = """
import signal, sys
import pytest

def mine(signum, frame):
    pass

if sys.argv[1] == "reference":
    from horovod_tpu.telemetry import flight as ref_flight
    ref_flight.configure(0)
    before = ref_flight._sigterm_handler
else:
    signal.signal(signal.SIGTERM, mine)
    before = mine
assert signal.getsignal(signal.SIGTERM) is before

from horovod_tpu_torch.telemetry import flight

class Probe:
    seen = []

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_call(self, item):
        yield
        self.seen.append(signal.getsignal(signal.SIGTERM)
                         is flight._sigterm_handler)

probe = Probe()
rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                  sys.argv[2]], plugins=[probe])
assert rc == 0, rc
assert probe.seen == [True], probe.seen     # the test chained the port's
assert signal.getsignal(signal.SIGTERM) is before
assert flight._sigterm_chained is False and flight._prev_sigterm is None
print("SIGTERM-OK")
"""


@pytest.mark.parametrize("first", ["own", "reference"])
def test_port_init_test_restores_sigterm(first):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _SCRIPT, first, PORT_TEST],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "SIGTERM-OK" in out.stdout
