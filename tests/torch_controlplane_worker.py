"""One rank of a port world over the replicated rendezvous:

    python torch_controlplane_worker.py BATTERY RANK SIZE SEEDS PORT OUTDIR

``SEEDS`` is the comma-separated ``host:port`` seed list the world dials
(``HOROVOD_GLOO_RENDEZVOUS_ADDR``) and ``PORT`` the first replica's port.
The batteries are the reference's (``tests/mp_worker.py``
``battery_rolling`` and ``battery_statesync_grow`` under the chaos
``coordkill`` of ``tests/test_controlplane.py``) on ``horovod_tpu_torch``
and CPU torch tensors:

- ``rolling``: rank 1 advertises wire proto 1 (``HOROVOD_PROTO_COMPAT``);
  every mesh negotiates the base schema and four allreduce steps run
  under the strict fingerprint; then the lagging rank lifts the pin and
  the whole world re-inits under a fresh epoch at the native schema.
- ``grow``: ``tests/torch_statesync_worker.py``'s grow battery with the
  rendezvous primary SIGKILLed at collective 5 (``coordkill:at=5``) before
  rank 2's SIGKILL at collective 13; the shrink, the joiner's bootstrap
  and the grow are then served by the promoted standby.
- ``joiner``: the grow battery's replacement rank, started by rank 0 with
  RANK and SIZE ignored.

One compute thread a rank.  An assertion fails the rank's exit code.
"""
from __future__ import annotations

import os
import subprocess
import sys
import traceback

import torch

import torch_statesync_worker as ssw

GROW_CHAOS = "coordkill:at=5;kill:rank=2,op=13,sig=9"


def battery_rolling(hvd, rank: int, size: int) -> None:
    from horovod_tpu_torch import core
    from horovod_tpu_torch.common import wire
    from horovod_tpu_torch.runner.network import PeerMesh

    def meshes():
        return [r for r in core.global_state().resources
                if isinstance(r, PeerMesh)]

    def steps(tag):
        t = torch.ones(256) * (rank + 1)
        want = torch.ones(256) * (size * (size + 1) / 2)
        for i in range(4):
            out = hvd.allreduce(t, op=hvd.Sum, name=f"{tag}{i}")
            assert torch.equal(out, want), out[:4]

    assert meshes(), "no TCP meshes formed"
    for m in meshes():
        assert m.negotiated_proto == 1, m.negotiated_proto
        assert m.negotiated_features == 0, m.negotiated_features
        assert m.peer_protos, m.peer_protos
    steps("rollold")
    # The old rank upgrades: drain, lift the compat pin, rejoin.
    hvd.shutdown()
    os.environ.pop("HOROVOD_PROTO_COMPAT", None)
    os.environ["HOROVOD_RENDEZVOUS_EPOCH"] += "~u1"
    hvd.init()
    assert meshes()
    for m in meshes():
        assert m.negotiated_proto == wire.PROTO_VERSION
        assert m.negotiated_features == wire.FEATURES_ALL
    steps("rollnew")
    print(f"ROLLING_OK rank={rank} proto 1->{wire.PROTO_VERSION}",
          flush=True)


def _spawn_joiner(battery: str, outdir: str) -> subprocess.Popen:
    env = dict(os.environ)
    for k in ("HOROVOD_CHAOS", "HOROVOD_RANK", "HOROVOD_SIZE"):
        env.pop(k, None)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "joiner", "0", "0",
         os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"],
         os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"], outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def main(battery: str, rank: int, size: int, seeds: str, port: int,
         outdir: str) -> int:
    torch.set_num_threads(1)
    os.environ.update(HOROVOD_GLOO_RENDEZVOUS_ADDR=seeds,
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port))
    if battery == "rolling":
        os.environ.update(HOROVOD_FINGERPRINT="strict",
                          HOROVOD_SHM_OPERATIONS="0")
        if rank == 1:
            os.environ["HOROVOD_PROTO_COMPAT"] = "1"
    else:
        env = {**ssw.COMMON, **ssw.ENV["grow"]}
        os.environ.update({k: v.format(outdir=outdir)
                           for k, v in env.items()})
        ssw._spawn_joiner = _spawn_joiner
        if battery == "grow":
            os.environ["HOROVOD_CHAOS"] = GROW_CHAOS
        else:
            try:
                return ssw.battery_joiner(outdir)
            except BaseException:
                traceback.print_exc()
                return 1
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size))
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        if battery == "rolling":
            battery_rolling(hvd, rank, size)
        else:
            ssw.battery_grow(hvd, rank, size, outdir)
    except BaseException:
        traceback.print_exc()
        return 1
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4], int(sys.argv[5]), sys.argv[6]))
