"""One rank of a perfscope world: an allreduce ladder through the eager core.

    python torch_perfscope_worker.py DEVICE SIZES REPS

Started by the port's launcher (``python -m horovod_tpu_torch.runner.launch
-np N ...``) with ``HOROVOD_METRICS=on``, ``HOROVOD_METRICS_FILE`` and
``HOROVOD_TIMELINE`` set.  Each rank calls ``hvd.init()``, then
allreduces (sum) an fp32 tensor of each byte size in ``SIZES``
(comma-separated) ``REPS`` times, every element ``rank + 1``, and checks
each result against ``N(N+1)/2``; ``hvd.shutdown()`` then writes the
rank's metrics dump and timeline.  ``DEVICE`` is ``cpu`` (the host
planes) or ``cuda`` (the rank's own card, ``hvd.local_rank()``: the NCCL
plane).  One compute thread a rank; exit 1 on a wrong sum.
"""
from __future__ import annotations

import sys

import torch

import horovod_tpu_torch as hvd


def main(device: str, sizes: str, reps: int) -> int:
    torch.set_num_threads(1)
    hvd.init()
    if device == "cuda":
        torch.cuda.set_device(hvd.local_rank())
        dev = torch.device("cuda", hvd.local_rank())
    else:
        dev = torch.device("cpu")
    n = hvd.size()
    want = n * (n + 1) / 2
    bad = []
    for nbytes in (int(s) for s in sizes.split(",")):
        x = torch.full((nbytes // 4,), float(hvd.rank() + 1), device=dev)
        for _ in range(reps):
            out = hvd.allreduce(x, op=hvd.Sum, name=f"ladder.{nbytes}")
            if not bool((out == want).all()):
                bad.append(nbytes)
    hvd.shutdown()
    if bad:
        print(f"rank wrong sums at {sorted(set(bad))}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
