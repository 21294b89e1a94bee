"""Remote worker bootstrap for :func:`horovod_tpu_torch.run`.

The port's copy of ``horovod_tpu/runner/run_worker.py``.  Upstream
horovod/runner/launch.py:528-618 `_run_static` runs a pickled
``run_func`` on remote hosts and collects results through a KV server; here
the bootstrap reads the pickled ``(func, args, kwargs)`` from stdin (argv
is world-readable on the remote host; stdin is not), executes it with the
slot environment the parent exported, and ships the pickled outcome back
to the parent's rendezvous KV store under the ``runfunc`` scope.
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback


def main() -> int:
    payload = sys.stdin.buffer.read()
    rank = os.environ["HOROVOD_RANK"]
    from .network import RendezvousClient
    kv = RendezvousClient(
        os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"],
        int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"]))
    try:
        # Unpickling inside the try: the most common remote failure is the
        # function's module not being importable on this host, and that
        # diagnostic must reach the parent, not vanish into a timeout.
        func, args, kwargs = pickle.loads(payload)
        result = func(*args, **kwargs)
        outcome = (True, result)
        rc = 0
    except BaseException:  # noqa: BLE001 - ship the traceback to the parent
        outcome = (False, traceback.format_exc())
        rc = 1
    kv.put("runfunc", rank, pickle.dumps(outcome))
    return rc


if __name__ == "__main__":
    sys.exit(main())
