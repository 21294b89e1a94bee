"""One rank of a gloo world running the port's gradient sync.

    python torch_sync_worker.py RANK WORLD STORE_FILE INPUTS.npz OUT.npz

``INPUTS.npz`` holds ``jobs`` (a JSON list) and ``sets`` (JSON: set name
-> the gradient names in sync order).  Set ``s`` holds rank r's gradient
``n`` as ``s/r/n`` and, for the ring jobs, the parameters (equal on every
rank) as ``s/p/n``.  Each job j writes its arrays as ``j/...`` to
``OUT.npz``.  Jobs:

- ``sync``: ``sync_gradients(grads, GradSyncConfig(**config))`` -> ``j/n``;
- ``ef``: ``sync_gradients_ef`` over ``steps`` sets, the residuals
  threaded through from ``init_error_feedback`` -> ``j/k/n`` (synced) and
  ``j/rk/n`` (residual) for step k;
- ``allreduce``: ``collectives.allreduce(g, op)`` per gradient -> ``j/n``;
- ``ring``: ``sync_and_apply`` over ``steps`` sets from the parameters of
  the first, with ``optimizer`` (``{"cls": ..., "kw": ...}``) ->
  ``j/k/n`` (parameters after step k) and ``j/state`` (the numel of the
  shard optimizer's parameter and of each state tensor);
- ``sync_then_update``: the same steps through ``sync_gradients`` and the
  optimizer over the parameters themselves -> ``j/k/n``;
- ``adasum_odd``: adasum over a group of 3 ranks (ranks 0-2 of a 4-rank
  world) must raise ``ValueError`` -> ``j/raised``.

A job may name ``layouts`` (``{"model": "gpt_tiny"}`` or
``{"model": "resnet", ...}``: ``convert.flax_layouts`` of that model) and
``mesh`` (axis sizes: the groups of ``mesh.axis_groups``).  It imports
torch and the port only.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import convert
from horovod_tpu_torch.parallel import (GradSyncConfig, axis_groups,
                                        collectives, init_error_feedback,
                                        init_ring_optimizer, sync_and_apply,
                                        sync_gradients, sync_gradients_ef)


def _layouts(spec):
    if spec is None:
        return None
    if spec["model"] == "gpt_tiny":
        from horovod_tpu_torch.models.transformer import (TransformerLM,
                                                          gpt_tiny)
        return convert.flax_layouts(TransformerLM(gpt_tiny(), device="cpu"))
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    return convert.flax_layouts(ResNet(
        spec["stage_sizes"], BottleneckBlock,
        num_filters=spec["num_filters"], num_classes=spec["num_classes"],
        device="cpu"))


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    data = np.load(inputs)
    jobs = json.loads(str(data["jobs"]))
    sets = json.loads(str(data["sets"]))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        def grads(s):
            # 4-D gradients channels_last, as the CNNs' are.
            return {n: t.contiguous(memory_format=torch.channels_last)
                    if t.dim() == 4 else t for n, t in (
                        (n, torch.from_numpy(data[f"{s}/{rank}/{n}"]))
                        for n in sets[s])}

        def params(s):
            return {n: torch.nn.Parameter(torch.from_numpy(
                data[f"{s}/p/{n}"].copy())) for n in sets[s]}

        # Groups are created collectively, in the jobs' order, on every
        # rank.
        meshes = {}
        for job in jobs:
            key = json.dumps(job.get("mesh"))
            if job.get("mesh") and key not in meshes:
                meshes[key] = axis_groups(job["mesh"])
        odd = dist.new_group([0, 1, 2]) if world == 4 else None

        result = {}
        for j, job in enumerate(jobs):
            cfg = GradSyncConfig(**job.get("config", {}))
            layouts = _layouts(job.get("layouts"))
            group = meshes.get(json.dumps(job.get("mesh")))
            kind = job["kind"]
            if kind == "sync":
                g = grads(job["set"])
                synced = sync_gradients(g, cfg, group, layouts)
                assert list(synced) == list(g)
                for n, v in synced.items():
                    assert v.dtype == g[n].dtype and v.shape == g[n].shape
                    result[f"{j}/{n}"] = v.numpy()
            elif kind == "ef":
                res = init_error_feedback(grads(job["steps"][0]))
                for k, s in enumerate(job["steps"]):
                    synced, res = sync_gradients_ef(grads(s), res, cfg, group,
                                                    layouts)
                    for n in synced:
                        result[f"{j}/{k}/{n}"] = synced[n].numpy()
                        result[f"{j}/r{k}/{n}"] = res[n].numpy()
            elif kind == "allreduce":
                for n, v in grads(job["set"]).items():
                    result[f"{j}/{n}"] = collectives.allreduce(
                        v, job["op"], group).numpy()
            elif kind in ("ring", "sync_then_update"):
                p = params(job["steps"][0])
                spec = job["optimizer"]
                opt = getattr(torch.optim, spec["cls"])(p.values(),
                                                        **spec["kw"])
                if kind == "ring":
                    opt = init_ring_optimizer(opt, list(p.values()),
                                              world, cfg)
                for k, s in enumerate(job["steps"]):
                    if kind == "ring":
                        sync_and_apply(opt, grads(s), p, cfg, group, layouts)
                    else:
                        synced = sync_gradients(grads(s), cfg, group, layouts)
                        for n, v in synced.items():
                            p[n].grad = v
                        opt.step()
                    for n, v in p.items():
                        result[f"{j}/{k}/{n}"] = v.detach().numpy().copy()
                if kind == "ring":
                    shard = opt.param_groups[0]["params"][0]
                    result[f"{j}/state"] = np.array(
                        [shard.numel()] + [t.numel() for t in
                                           opt.state[shard].values()
                                           if t.dim() > 0])
            elif kind == "adasum_odd":
                raised = False
                if rank < 3:
                    try:
                        collectives.allreduce(torch.ones(4), "adasum", odd)
                    except ValueError as err:
                        raised = "power-of-2" in str(err)
                result[f"{j}/raised"] = np.array(raised or rank == 3)
            else:
                raise ValueError(kind)
        np.savez(out, **result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
