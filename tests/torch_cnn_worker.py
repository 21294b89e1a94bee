"""One rank of a gloo world training the port's ResNet with ``Trainer``.

    python torch_cnn_worker.py RANK WORLD STORE_FILE INPUTS.npz OUT.npz

``INPUTS.npz`` holds ``config`` (JSON: ``stage_sizes``, ``num_filters``,
``num_classes``, ``steps``, ``lr``, ``momentum`` and, optionally,
``sync``: ``GradSyncConfig`` keywords; ``axis_name``: the ResNet's
cross-replica BatchNorm axis; ``weight_decay``: AdamW with that decay in
place of SGD; ``ring_dir``: where each rank writes its ring checkpoint
shard after the steps; ``every_step``: also write the state after each
step as ``step<i>/<name>``), the global batch
``images`` (NHWC) and ``labels``, and the initial state dict as
``state/<name>``.  Rank r trains on its rows ``r*B/W .. (r+1)*B/W - 1``
with SGD (or AdamW) and writes ``losses``, its final ``state/<name>``
(parameters and BatchNorm statistics) and ``opt_numel`` (the elements of
each parameter and state tensor of the state's optimizer) to
``OUT.npz``.  It imports torch and the port only.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import GradSyncConfig, Trainer, build_mesh
from horovod_tpu_torch.checkpoint import save_ring_checkpoint
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
                       axis_name=cfg.get("axis_name"), device="cpu")
        model.load_state_dict({k[len("state/"):]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("state/")})
        if "weight_decay" in cfg:
            opt = torch.optim.AdamW(model.parameters(), lr=cfg["lr"],
                                    weight_decay=cfg["weight_decay"])
        else:
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
        steps = {}
        for i in range(cfg["steps"]):
            state, metrics = trainer.step(state, batch)
            losses.append(float(metrics["loss"]))
            if cfg.get("every_step"):
                steps.update({f"step{i + 1}/{k}": v.detach().numpy().copy()
                              for k, v in model.state_dict().items()})
        if "ring_dir" in cfg:
            save_ring_checkpoint(
                cfg["ring_dir"], state.optimizer, rank=rank, world=world,
                n_params=sum(p.numel() for p in model.parameters()),
                step=state.step, config=sync)
        result = {f"state/{k}": v.detach().numpy()
                  for k, v in model.state_dict().items()}
        opt = state.optimizer
        numel = [p.numel() for g in opt.param_groups for p in g["params"]]
        numel += [t.numel() for s in opt.state.values() for t in s.values()
                  if torch.is_tensor(t) and t.dim() > 0]
        np.savez(out, losses=np.array(losses), opt_numel=np.array(numel),
                 **result, **steps)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
