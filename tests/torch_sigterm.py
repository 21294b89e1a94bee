"""A fixture for port test files that run the port's ``hvd.init()`` (or
its flight recorder's ``configure``) in the pytest process.

The port's flight recorder chains its SIGTERM handler over the process's
on the first init, once a process, as the reference's does.  In a test
worker that also runs the reference's tests, a port handler left behind
replaces the reference's, and the reference's once-a-process chaining
does not put its own back (``tests/test_trace.py``'s check of its
handler then fails).  ``restore_sigterm`` undoes the port's chaining
after each test: where the port's handler is the process's, the handler
it chained over is put back, and the port's ``_sigterm_chained`` is
reset so that the next init chains anew.

    from torch_sigterm import restore_sigterm  # noqa: F401

makes it autouse for the importing module.
"""
from __future__ import annotations

import signal

import pytest


def undo_port_sigterm_chain(before) -> None:
    """Put back the SIGTERM handler the port's flight recorder chained
    over (``before``, the disposition before the test, where it kept
    none) and reset its chain state."""
    from horovod_tpu_torch.telemetry import flight
    if not flight._sigterm_chained:
        return
    if signal.getsignal(signal.SIGTERM) is flight._sigterm_handler:
        prev = flight._prev_sigterm
        if prev is None:
            prev = before if before is not None else signal.SIG_DFL
        signal.signal(signal.SIGTERM, prev)
    flight._sigterm_chained = False
    flight._prev_sigterm = None


@pytest.fixture(autouse=True)
def restore_sigterm():
    before = signal.getsignal(signal.SIGTERM)
    yield
    undo_port_sigterm_chain(before)
