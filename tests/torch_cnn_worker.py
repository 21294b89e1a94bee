"""One rank of a gloo world training the port's ResNet with ``Trainer``.

    python torch_cnn_worker.py RANK WORLD STORE_FILE INPUTS.npz OUT.npz

``INPUTS.npz`` holds ``config`` (JSON: ``stage_sizes``, ``num_filters``,
``num_classes``, ``steps``, ``lr``, ``momentum`` and, optionally,
``sync``: ``GradSyncConfig`` keywords), the global batch
``images`` (NHWC) and ``labels``, and the initial state dict as
``state/<name>``.  Rank r trains on its rows ``r*B/W .. (r+1)*B/W - 1``
with SGD and writes ``losses``, its final ``state/<name>`` (parameters
and BatchNorm statistics) and ``opt_numel`` (the elements of each
parameter and state tensor of the state's optimizer) to ``OUT.npz``.  It imports torch and the port
only.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import GradSyncConfig, Trainer, build_mesh
from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    data = np.load(inputs)
    cfg = json.loads(str(data["config"]))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        model = ResNet(cfg["stage_sizes"], BottleneckBlock,
                       num_filters=cfg["num_filters"],
                       num_classes=cfg["num_classes"], dtype=torch.float32,
                       device="cpu")
        model.load_state_dict({k[len("state/"):]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("state/")})
        opt = torch.optim.SGD(model.parameters(), lr=cfg["lr"],
                              momentum=cfg["momentum"])
        sync = GradSyncConfig(**cfg["sync"]) if "sync" in cfg else None
        trainer = Trainer(model, opt, build_mesh(device="cpu"), sync=sync)
        rows = len(data["images"]) // world
        part = slice(rank * rows, (rank + 1) * rows)
        batch = {"image": torch.from_numpy(data["images"][part]),
                 "label": torch.from_numpy(data["labels"][part])}
        state = trainer.init()
        losses = []
        for _ in range(cfg["steps"]):
            state, metrics = trainer.step(state, batch)
            losses.append(float(metrics["loss"]))
        result = {f"state/{k}": v.detach().numpy()
                  for k, v in model.state_dict().items()}
        opt = state.optimizer
        numel = [p.numel() for g in opt.param_groups for p in g["params"]]
        numel += [t.numel() for s in opt.state.values() for t in s.values()
                  if torch.is_tensor(t) and t.dim() > 0]
        np.savez(out, losses=np.array(losses), opt_numel=np.array(numel),
                 **result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
