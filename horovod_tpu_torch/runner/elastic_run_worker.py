"""Worker bootstrap for programmatic *elastic* :func:`horovod_tpu_torch.run`.

The port's copy of ``horovod_tpu/runner/elastic_run_worker.py``.
Upstream horovod/runner/__init__.py:92-210 — `horovod.run(func,
min_np=..., max_np=...)` launches the elastic driver over a pickled
function.  Unlike the static bootstrap (run_worker.py, payload over
stdin), elastic workers are (re)spawned by the driver on membership
changes — possibly on hosts that did not exist at submit time — so the
payload is fetched from the rendezvous KV store every worker can already
reach via the exported env.

The function runs once per worker lifetime; on success its result is
published under the worker's FINAL rank (elastic rounds may have
re-ranked it).  The function itself decides how to use
``hvd.elastic.run`` / State for mid-run fault tolerance, exactly as with
the CLI launcher.
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback

PAYLOAD_SCOPE = "elastic_runfunc"
RESULT_SCOPE = "elastic_runfunc_result"


def main() -> int:
    from ..elastic.run import _apply_assignment
    from ..elastic.worker import notification_manager
    from .network import RendezvousClient

    kv = RendezvousClient(
        os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"],
        int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"]))
    assigned = False
    try:
        # Pull this worker's rank assignment from the elastic driver (the
        # role hvd.elastic.run's _rendezvous plays for CLI workers): the
        # launcher hands out only hostname+local_rank; global rank/size
        # come from the driver's round formation. The launcher strips any
        # inherited epoch/rank env, so round formation starts at 0.
        notification_manager.init()
        if notification_manager.has_driver:
            assignment = notification_manager.get_assignment(0)
            if assignment is None:
                return 0   # dropped from the new world; exit quietly
            _apply_assignment(assignment)
            assigned = True
        payload = kv.wait(PAYLOAD_SCOPE, "blob", timeout=60.0)
        func, args, kwargs = pickle.loads(payload)
        result = func(*args, **kwargs)
        outcome, rc = (True, result), 0
    except BaseException:  # noqa: BLE001 — ship the traceback to the parent
        outcome, rc = (False, traceback.format_exc()), 1
    # HOROVOD_RANK/RENDEZVOUS_EPOCH reflect the latest elastic assignment
    # (elastic/run.py _apply_assignment re-exports them each round). A
    # worker that failed BEFORE receiving any assignment must not publish
    # — a fallback key would clobber/misattribute the real rank 0's
    # outcome; its nonzero exit reaches the driver's results instead.
    # The key carries the epoch so a result published by an EARLIER
    # round's incarnation of rank r (killed before the final round) can
    # never masquerade as the final round's rank-r outcome.
    if assigned or "HOROVOD_RANK" in os.environ:
        epoch = os.environ.get("HOROVOD_RENDEZVOUS_EPOCH", "0")
        # The payload carries the publishing SLOT so the launcher can
        # accept an earlier-epoch result only when it provably belongs to
        # the final round's incarnation of the rank (a success can race
        # the final round forming, landing one epoch behind).
        slot = (f"{os.environ.get('HOROVOD_HOSTNAME', '')}"
                f"[{os.environ.get('HOROVOD_LOCAL_RANK', '')}]")
        kv.put(RESULT_SCOPE,
               f"{epoch}:{os.environ['HOROVOD_RANK']}",
               pickle.dumps((outcome, slot)))
    return rc


if __name__ == "__main__":
    sys.exit(main())
