"""One rank of a gloo world running the port's ``sync_gradients``.

    python torch_sync_worker.py RANK WORLD STORE_FILE INPUTS.npz OUT.npz

``INPUTS.npz`` holds ``configs`` (a JSON list of ``GradSyncConfig``
keyword dicts) and, for each rank r and gradient name n, the array
``r/n``; the names are synced in the order given by ``names`` (JSON).
The rank writes ``c/n`` for config c and name n to ``OUT.npz``.  It
imports torch and the port only.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel import GradSyncConfig, sync_gradients


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    data = np.load(inputs)
    names = json.loads(str(data["names"]))
    configs = json.loads(str(data["configs"]))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        grads = {n: torch.from_numpy(data[f"{rank}/{n}"]) for n in names}
        result = {}
        for c, kwargs in enumerate(configs):
            synced = sync_gradients(grads, GradSyncConfig(**kwargs))
            assert list(synced) == names
            for n, g in synced.items():
                assert g.dtype == grads[n].dtype and g.shape == grads[n].shape
                result[f"{c}/{n}"] = g.numpy()
        np.savez(out, **result)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
