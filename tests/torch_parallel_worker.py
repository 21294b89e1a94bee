"""One rank of a gloo world running the port's sequence, expert and
pipeline parallelism.

    python torch_parallel_worker.py RANK WORLD STORE_FILE INPUTS.npz OUT.npz

``INPUTS.npz`` holds ``jobs`` (a JSON list) and each job j's arrays as
``j/<name>``.  Every job builds its mesh with ``build_mesh`` (collective,
in the jobs' order on every rank) and writes its arrays as ``j/<name>``
to ``OUT.npz``.  Jobs (``kind``):

- ``ring`` / ``ulysses``: ``q``, ``k``, ``v`` ``[B, T, H, D]`` are the
  whole sequence; rank r takes chunk r of T over an ``sp`` mesh of the
  world, runs the attention (``causal``), and writes ``out`` and the
  gradients ``dq``, ``dk``, ``dv`` of ``sum(out**2)`` over its chunk;
- ``pipeline``: ``W`` ``[n, d, d]``, ``b`` ``[n, d]``, ``x`` ``[B, d]``;
  rank r is stage r of ``tanh(h @ W + b)`` over a ``pp`` mesh, with
  ``microbatches``; writes ``out`` (the whole batch) and the gradients
  ``dW``, ``db`` of its stage and ``dx`` of ``sum(out**2)``;
- ``moe``: ``x`` ``[B, T, D]`` and the flax leaves ``router``, ``wi``,
  ``wo``; rank r takes row block r over an ``ep`` mesh of the world
  (``experts``, ``capacity_factor``) and writes ``out``, ``dx`` and its
  gradients ``drouter`` (flax layout), ``dwi``, ``dwo`` of
  ``sum(out**2)``;
- ``trainer``: ``TransformerLM(gpt_tiny(dtype=float32, **model))`` from
  the state dict ``state/<name>`` on the mesh ``mesh`` (axis sizes),
  ``Trainer(..., sync=GradSyncConfig(**sync), batch_spec=batch_spec)``
  with AdamW(``lr``, wd 1e-4) for ``steps`` steps on the global
  ``inputs``/``labels``, each rank passing its shard as ``batch_spec``
  lays it over the mesh; writes ``losses``, the final ``state/<name>``
  and ``mesh_shape``, the input shape the MFU gauge counts.

It imports torch and the port only.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import GradSyncConfig, Trainer, build_mesh
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.moe import MoEMLP
from horovod_tpu_torch.parallel import (pipeline_apply, ring_attention,
                                        ulysses_attention)


def _chunk(x: np.ndarray, axis: int, index: int, parts: int) -> np.ndarray:
    size = x.shape[axis] // parts
    return np.take(x, range(index * size, (index + 1) * size), axis=axis)


def _shard(x: np.ndarray, spec, mesh) -> np.ndarray:
    """This rank's shard of ``x`` under ``spec`` (one entry per leading
    dim: an axis, a list of axes or None), row-major over each entry's
    axes."""
    for dim, entry in enumerate(spec):
        axes = [] if entry is None else [entry] if isinstance(entry, str) \
            else list(entry)
        idx, parts = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
            parts *= mesh.shape[a]
        x = _chunk(x, dim, idx, parts)
    return x


def _leaf(data, j, name, grad=False):
    return torch.from_numpy(data[f"{j}/{name}"].copy()).requires_grad_(grad)


def _attention(job, j, data, world, rank):
    mesh = build_mesh(sp=world, device="cpu")
    q, k, v = (torch.from_numpy(_chunk(data[f"{j}/{n}"], 1, rank, world))
               .requires_grad_() for n in ("q", "k", "v"))
    group = mesh.axis_group("sp")
    if job["kind"] == "ring":
        out = ring_attention(q, k, v, group, causal=job["causal"])
    else:
        out = ulysses_attention(q, k, v, group, causal=job["causal"])
    out.square().sum().backward()
    return {"out": out, "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _pipeline(job, j, data, world, rank):
    mesh = build_mesh(pp=world, device="cpu")
    w = torch.from_numpy(data[f"{j}/W"][rank].copy()).requires_grad_()
    b = torch.from_numpy(data[f"{j}/b"][rank].copy()).requires_grad_()
    x = _leaf(data, j, "x", grad=True)

    def stage(params, h):
        weight, bias = params
        return torch.tanh(h @ weight + bias)
    out = pipeline_apply(stage, (w, b), x, group=mesh.axis_group("pp"),
                         num_microbatches=job["microbatches"])
    out.square().sum().backward()
    return {"out": out, "dW": w.grad, "db": b.grad, "dx": x.grad}


def _moe(job, j, data, world, rank):
    mesh = build_mesh(ep=world, device="cpu")
    x_all = data[f"{j}/x"]
    d, e = x_all.shape[-1], job["experts"]
    layer = MoEMLP(d, num_experts=e, d_ff=data[f"{j}/wi"].shape[-1],
                   capacity_factor=job["capacity_factor"], ep_mesh=mesh,
                   device=torch.device("cpu"))
    layer.load_state_dict({"router.weight": torch.from_numpy(
                               data[f"{j}/router"].T.copy()),
                           "wi": _leaf(data, j, "wi"),
                           "wo": _leaf(data, j, "wo")})
    x = torch.from_numpy(_chunk(x_all, 0, rank, world)).requires_grad_()
    out = layer(x)
    out.square().sum().backward()
    return {"out": out, "dx": x.grad, "drouter": layer.router.weight.grad.T,
            "dwi": layer.wi.grad, "dwo": layer.wo.grad}


def _trainer(job, j, data, world, rank):
    mesh = build_mesh(device="cpu", **job["mesh"])
    cfg = ttr.gpt_tiny(dtype=torch.float32, mesh=mesh, **job["model"])
    model = ttr.TransformerLM(cfg, device="cpu")
    prefix = f"{j}/state/"
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith(prefix)})
    opt = torch.optim.AdamW(model.parameters(), lr=job["lr"],
                            weight_decay=1e-4)
    spec = [tuple(e) if isinstance(e, list) else e
            for e in job["batch_spec"]]
    sync = GradSyncConfig(axes=tuple(job["sync"]["axes"]),
                          op=job["sync"]["op"])
    trainer = Trainer(model, opt, mesh, sync=sync, batch_spec=tuple(spec))
    batch = {n: torch.from_numpy(_shard(data[f"{j}/{n}"], spec, mesh))
             for n in ("inputs", "labels")}
    batch = {"input": batch["inputs"], "label": batch["labels"]}
    state = trainer.init()
    losses = []
    for _ in range(job["steps"]):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    out = {"losses": torch.tensor(losses, dtype=torch.float64),
           "mesh_shape": torch.tensor(trainer._mesh_shape(batch["input"]))}
    for name, p in model.state_dict().items():
        out[f"state/{name}"] = p
    return out


_JOBS = {"ring": _attention, "ulysses": _attention, "pipeline": _pipeline,
         "moe": _moe, "trainer": _trainer}


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    data = np.load(inputs)
    jobs = json.loads(str(data["jobs"]))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = {}
        for j, job in enumerate(jobs):
            for name, value in _JOBS[job["kind"]](job, j, data, world,
                                                  rank).items():
                result[f"{j}/{name}"] = value.detach().numpy()
        np.savez(out, **result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
