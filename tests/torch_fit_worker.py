"""One rank of an eager host world exercising the fit loop's rank rules.

    python torch_fit_worker.py RANK WORLD PORT OUTDIR

Each rank ``hvd.init()``s against the port's rendezvous server at
``127.0.0.1:PORT``, then:

- ``MetricAverageCallback.on_epoch_end`` on its own logs (``loss`` =
  1.5 (rank + 1), ``accuracy`` = rank / 4, and a string, which stays);
- ``save_checkpoint(OUTDIR/ck, {"rank": rank})``: only rank 0 writes;
  after a barrier every rank reads the checkpoint back;
- ``BestModelCheckpoint`` on two epochs' logs, with a ``save_fn`` that
  records the paths: only rank 0 saves.

It writes ``OUTDIR/rank<r>.json``.  It imports torch and the port only.
"""
from __future__ import annotations

import json
import os
import sys

import torch


def main(rank: int, world: int, port: int, outdir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                      HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                      HOROVOD_RENDEZVOUS_EPOCH="fit")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks, checkpoint
    hvd.init()
    try:
        logs = {"loss": 1.5 * (rank + 1), "accuracy": rank / 4,
                "name": "x"}
        callbacks.MetricAverageCallback().on_epoch_end(3, logs)
        ck = os.path.join(outdir, "ck")
        checkpoint.save_checkpoint(ck, {"rank": torch.tensor(rank)})
        hvd.barrier()
        read = int(checkpoint.restore_checkpoint(ck)["rank"])
        saved = []
        best = callbacks.BestModelCheckpoint(
            os.path.join(outdir, "best-{epoch}"),
            save_fn=lambda path, state: saved.append(path))
        for epoch, loss in enumerate((2.0, 1.0)):
            best.on_epoch_end(epoch, {"loss": loss})
        hvd.barrier()
    finally:
        hvd.shutdown()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"logs": logs, "checkpoint_rank": read, "saved": saved},
                  f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
