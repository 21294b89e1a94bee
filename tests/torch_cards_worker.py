"""One rank of a gloo world running the cards phase's training legs
(``chip_smoke.cards_train`` and ``chip_smoke.bn_steps``) on the CPU.

    python torch_cards_worker.py RANK WORLD STORE_FILE INPUTS.npz OUT.npz

``INPUTS.npz`` holds ``config`` (JSON: the gpt wires, the steps), the
global batches (``inputs``/``labels`` for gpt_tiny, ``images``/``classes``
for the small ResNet) and the initial state dicts (``gpt/<name>``,
``cnn/<name>``).  Each rank takes its rows of each batch.  For every wire
it trains fp32 gpt_tiny through ``cards_train`` and writes
``<wire>/losses``, ``<wire>/digests_equal`` and ``<wire>/state/<name>``;
then it runs the small ResNet with cross-replica BatchNorm
(``axis_name="dp"``) through ``bn_steps`` and writes ``bn/losses``,
``bn/logits`` (its rows), ``bn/step<k>/<name>`` (the parameters after
step k) and ``bn/stats/<name>``.

It imports torch, the port and ``chip_smoke`` only.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from horovod_tpu_torch.models import resnet as tres  # noqa: E402
from horovod_tpu_torch.models import transformer as ttr  # noqa: E402


def _state(data, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(data[k])
            for k in data.files if k.startswith(prefix)}


def _rows(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    n = x.shape[0] // world
    return torch.from_numpy(x[rank * n:(rank + 1) * n].copy())


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    data = np.load(inputs)
    config = json.loads(str(data["config"]))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    result = {}
    try:
        batch = {"input": _rows(data["inputs"], rank, world),
                 "label": _rows(data["labels"], rank, world)}
        for wire, kw in config["wires"].items():
            model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                                      device="cpu")
            model.load_state_dict(_state(data, "gpt/"))
            leg = chip_smoke.cards_train(model, kw, batch, config["steps"],
                                         digests=True)
            assert not leg["misplaced"], leg["misplaced"]
            result[f"{wire}/losses"] = np.array(leg["losses"])
            result[f"{wire}/digests_equal"] = np.array(
                leg["params_equal_every_step"])
            for name, t in model.state_dict().items():
                result[f"{wire}/state/{name}"] = t.numpy()
        cnn = config["cnn"]
        model = tres.ResNet(cnn["stage_sizes"], tres.BottleneckBlock,
                            num_filters=cnn["num_filters"],
                            num_classes=cnn["num_classes"],
                            dtype=torch.float32, axis_name="dp",
                            device="cpu")
        model.load_state_dict(_state(data, "cnn/"))
        images = {"image": _rows(data["images"], rank, world),
                  "label": _rows(data["classes"], rank, world)}
        bn = chip_smoke.bn_steps(model, images, config["bn_steps"])
        result["bn/losses"] = np.array(bn["losses"])
        result["bn/logits"] = bn["logits"].numpy()
        for k, params in enumerate(bn["params"]):
            for name, t in params.items():
                result[f"bn/step{k + 1}/{name}"] = t.numpy()
        for name, t in bn["stats"].items():
            result[f"bn/stats/{name}"] = t.numpy()
        np.savez(out, **result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
