"""One rank of a gloo world training the port with sharded parameters.

    python torch_sharding_worker.py RANK WORLD STORE_FILE INPUTS.npz OUT.npz

``INPUTS.npz`` holds ``jobs`` (a JSON list) and each job j's arrays as
``j/<name>``: the initial state dict ``state/<name>`` (the port's
layout) and the global batch ``inputs``/``labels`` (token rows) or
``images``/``labels`` (NHWC).  Every job is a ``trainer``:

- the model: ``gpt`` (``gpt_tiny(dtype=float32, **model_kw)`` on the
  job's mesh) or ``resnet`` (the small fp32 ResNet of
  ``tests/test_torch_cnn_training.py``);
- ``Trainer(..., sync=GradSyncConfig(**sync), batch_spec=batch_spec,
  param_rules=ShardingRules(rules))`` with AdamW(``lr``, wd 1e-4) or
  SGD(``lr``, momentum 0.9) for ``steps`` steps, each rank passing its
  shard of the global batch as ``batch_spec`` lays it over the mesh,
  then ``eval_step`` on that batch; it writes ``losses`` (the steps'
  and the evaluation's, last), its chunks ``state/<name>`` and ``bytes`` (the
  bytes of its parameters and of its optimizer's tensors);
- with ``twin``, the same run without rules on the same mesh:
  ``plain/losses`` and ``plain/state/<name>``;
- with ``ckpt`` (a directory): the sharded state and the twin's are
  saved (``save_checkpoint``, rank 0 writes), and each rank writes
  ``ckpt/same_digest`` (the two manifests' digests equal),
  ``ckpt/restore_dp4`` (the sharded checkpoint restored into a ``dp=4``
  Trainer without rules holds the twin's parameters and optimizer state
  bit for bit) and ``ckpt/restore_resharded`` (restored into a Trainer
  with the rules of ``ckpt_reshard`` on its mesh, every chunk is the cut
  of the twin's leaf);
- with ``fit_ckpt`` (a directory): ``Trainer.fit`` with the rules and
  ``BestModelCheckpoint``, 2 epochs of the job's steps, then
  ``fit/improved`` (the second epoch's loss is lower, so it saved) and
  ``fit/restored`` (that checkpoint restored at ``dp=4`` without rules
  is the fitted state bit for bit).

The world runs under ``HOROVOD_METRICS=on``: each job's ``perf`` holds
the Trainer's ``horovod_train_step_flops`` gauge after its steps, the
peak it divides by, ``horovod_train_mfu`` and the one step time that
MFU was read from (ms, the ``horovod_train_step_ms`` histogram's growth).

After the jobs, ``gather/roundtrip``: ``gather_params`` of this rank's
``shard_params`` chunks of a flax-shaped tree (gpt_tiny's, drawn from
seed 0) over a ``dp=2, tp=2`` mesh with the strided table of
``gather_rules`` is the tree again, bit for bit.

``python torch_sharding_worker.py statesync RANK WORLD STORE_FILE
OUT.json`` runs ``statesync_round_trip`` instead: at tp=WORLD in the
pure-GSPMD step with the int8 and the uint4 wire (the layers split),
one SGD-with-momentum step, then the state's tree through
``train_state_tree(gather=True)`` and ``load_train_state`` into a fresh
sharded Trainer of another seed.

It imports torch and the port only; one compute thread a rank.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import (GradSyncConfig, Trainer, build_mesh, convert,
                               telemetry)
from horovod_tpu_torch.callbacks import BestModelCheckpoint
from horovod_tpu_torch.checkpoint import (restore_checkpoint,
                                          save_checkpoint,
                                          train_state_tree)
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
from horovod_tpu_torch.parallel.sharding import (ShardingRules,
                                                 gather_params, shard_params)


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _shard(x: np.ndarray, spec, mesh) -> np.ndarray:
    """This rank's shard of ``x`` under ``spec`` (one entry per leading
    dim), row-major over each entry's axes."""
    for dim, entry in enumerate(spec):
        axes = [] if entry is None else [entry] if isinstance(entry, str) \
            else list(entry)
        idx, parts = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
            parts *= mesh.shape[a]
        size = x.shape[dim] // parts
        x = np.take(x, range(idx * size, (idx + 1) * size), axis=dim)
    return x


def _model(job, mesh):
    if job["model"] == "resnet":
        return ResNet((1, 1), BottleneckBlock, num_filters=8,
                      num_classes=10, dtype=torch.float32, device="cpu")
    cfg = ttr.gpt_tiny(dtype=torch.float32, mesh=mesh,
                       **job.get("model_kw", {}))
    return ttr.TransformerLM(cfg, device="cpu")


def _trainer(job, j, data, mesh_shape, rules):
    mesh = build_mesh(device="cpu", **mesh_shape)
    model = _model(job, mesh)
    prefix = f"{j}/state/"
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith(prefix)})
    if job["opt"] == "sgd":
        opt = torch.optim.SGD(model.parameters(), lr=job["lr"],
                              momentum=0.9)
    else:
        opt = torch.optim.AdamW(model.parameters(), lr=job["lr"],
                                weight_decay=1e-4)
    sync = GradSyncConfig(**{**job["sync"],
                             "axes": tuple(job["sync"]["axes"])})
    spec = _spec(job["batch_spec"])
    trainer = Trainer(model, opt, mesh, sync=sync, batch_spec=spec,
                      param_rules=None if rules is None
                      else ShardingRules([(p, _spec(s)) for p, s in rules]))
    return trainer, mesh, spec


def _batch(j, data, spec, mesh) -> dict:
    """This rank's shard of job j's global batch."""
    key = "images" if f"{j}/images" in data.files else "inputs"
    return {"input" if key == "inputs" else "image":
            torch.from_numpy(_shard(data[f"{j}/{key}"], spec, mesh)),
            "label": torch.from_numpy(_shard(data[f"{j}/labels"], spec,
                                             mesh))}


def _run(job, j, data, rules):
    trainer, mesh, spec = _trainer(job, j, data, job["mesh"], rules)
    batch = _batch(j, data, spec, mesh)
    state = trainer.init()
    losses = []
    for _ in range(job["steps"]):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    # The trained state evaluated on the same batch: the loss after the
    # last step.
    losses.append(float(trainer.eval_step(state, batch)["loss"]))
    return trainer, state, losses


def _step_ms_sum() -> float:
    return telemetry.metrics().histogram("horovod_train_step_ms").sum


def _perf(trainer, ms_before: float) -> torch.Tensor:
    """The MFU gauges of the job just run: step FLOPs, the peak the
    Trainer divides by, MFU, and the step time (ms) it was read from."""
    tm = telemetry.metrics()
    return torch.tensor([tm.gauge("horovod_train_step_flops").value,
                         trainer._peak_flops,
                         tm.gauge("horovod_train_mfu").value,
                         _step_ms_sum() - ms_before], dtype=torch.float64)


def _bytes(state) -> list[int]:
    params = sum(p.numel() * p.element_size()
                 for p in state.model.parameters())
    opt = sum(t.numel() * t.element_size()
              for s in state.optimizer.state.values() for t in s.values()
              if torch.is_tensor(t) and t.dim() > 0)
    return [params, opt]


def _digest(path: str) -> int:
    with open(os.path.join(path, "manifest.json")) as f:
        return int(json.load(f)["digest"])


def _checkpoint(job, j, data, state, plain_state) -> dict:
    out = {}
    root = job["ckpt"]
    save_checkpoint(os.path.join(root, "sharded"), state)
    save_checkpoint(os.path.join(root, "plain"), plain_state)
    dist.barrier()
    out["same_digest"] = _digest(os.path.join(root, "sharded")) \
        == _digest(os.path.join(root, "plain"))
    want = train_state_tree(plain_state)
    # Into dp=4 without rules.
    dp4 = dict(job, mesh={"dp": 4})
    trainer, _, _ = _trainer(dp4, j, data, dp4["mesh"], None)
    restored = restore_checkpoint(os.path.join(root, "sharded"),
                                  trainer.init())
    got = train_state_tree(restored)
    out["restore_dp4"] = list(got) == list(want) and all(
        torch.equal(got[k], want[k]) for k in want)
    # Into another layout: every chunk the cut of the twin's leaf.
    other = dict(job, mesh=job["ckpt_reshard"]["mesh"],
                 sync=job["ckpt_reshard"]["sync"])
    trainer, _, _ = _trainer(other, j, data, other["mesh"],
                             job["ckpt_reshard"]["rules"])
    resharded = restore_checkpoint(os.path.join(root, "sharded"),
                                   trainer.init())
    sharding = resharded.sharding
    params = dict(resharded.model.named_parameters())
    ok = resharded.step == plain_state.step
    for name, p in params.items():
        full = want[f"params/{name}"]
        if name in sharding.leaves:
            ok = ok and torch.equal(p.detach(), sharding.cut(name, full))
            moment = resharded.optimizer.state[p]["exp_avg"]
            ok = ok and torch.equal(moment, sharding.cut(
                name, want[f"opt/{name}/exp_avg"]))
        else:
            ok = ok and torch.equal(p.detach(), full)
    out["restore_resharded"] = bool(ok) and len(sharding.leaves) > 0
    # The gathered tree of the restored state is the twin's again.
    again = train_state_tree(resharded, gather=True)
    out["resharded_tree"] = all(torch.equal(again[k], want[k])
                                for k in want)
    return {f"ckpt/{k}": torch.tensor(int(v)) for k, v in out.items()}


def _fit_checkpoint(job, j, data) -> dict:
    """``Trainer.fit`` with the job's rules for 2 epochs of its steps on
    its batch, under ``BestModelCheckpoint`` (a sharded state is saved on
    every rank, rank 0 writes); the second epoch's checkpoint restored
    into a ``dp=4`` Trainer without rules is the fitted state's gathered
    tree bit for bit."""
    trainer, mesh, spec = _trainer(job, j, data, job["mesh"], job["rules"])
    batch = _batch(j, data, spec, mesh)
    best = BestModelCheckpoint(os.path.join(job["fit_ckpt"], "best-{epoch}"))
    state, history = trainer.fit(trainer.init(), [batch] * job["steps"],
                                 epochs=2, callbacks=[best])
    want = train_state_tree(state, gather=True)
    dist.barrier()
    dp4 = dict(job, mesh={"dp": 4})
    plain, _, _ = _trainer(dp4, j, data, dp4["mesh"], None)
    restored = restore_checkpoint(
        os.path.join(job["fit_ckpt"], "best-1"), plain.init())
    got = train_state_tree(restored)
    out = {"improved": history[1]["loss"] < history[0]["loss"],
           "restored": list(got) == list(want) and all(
               torch.equal(got[k], want[k]) for k in want)}
    return {f"fit/{k}": torch.tensor(int(v)) for k, v in out.items()}


def _gather_roundtrip(rules) -> dict:
    cfg = ttr.gpt_tiny(dtype=torch.float32)
    model = ttr.TransformerLM(cfg, device="cpu", seed=0)
    tree = convert.params_to_flax(model.state_dict(), cfg)
    mesh = build_mesh(dp=2, tp=2, device="cpu")
    rules = ShardingRules([(p, _spec(s)) for p, s in rules])
    chunks = _as_tensors(shard_params(tree, mesh, rules))
    whole = gather_params(chunks, mesh, rules)
    return {"gather/roundtrip": torch.tensor(int(_equal_trees(whole, tree)))}


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _equal_trees(got, want) -> bool:
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _equal_trees(got[k], want[k]) for k in want)
    return np.array_equal(got.numpy(), want)


def main(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    data = np.load(inputs)
    jobs = json.loads(str(data["jobs"]))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = {}
        for j, job in enumerate(jobs):
            ms_before = _step_ms_sum()
            trainer, state, losses = _run(job, j, data, job["rules"])
            found = {"losses": torch.tensor(losses, dtype=torch.float64),
                     "bytes": torch.tensor(_bytes(state)),
                     "perf": _perf(trainer, ms_before)}
            for name, p in state.model.state_dict().items():
                found[f"state/{name}"] = p
            if job.get("twin"):
                _, plain, plosses = _run(job, j, data, None)
                found["plain/losses"] = torch.tensor(plosses,
                                                     dtype=torch.float64)
                for name, p in plain.model.state_dict().items():
                    found[f"plain/state/{name}"] = p
                if "ckpt" in job:
                    found.update(_checkpoint(job, j, data, state, plain))
            if "fit_ckpt" in job:
                found.update(_fit_checkpoint(job, j, data))
            for name, value in found.items():
                result[f"{j}/{name}"] = value.detach().numpy()
        for name, value in _gather_roundtrip(
                json.loads(str(data["gather_rules"]))).items():
            result[name] = value.numpy()
        np.savez(out, **result)
        dist.barrier()
    finally:
        dist.destroy_process_group()


TP_RULES = [(r"attn/w[qkv]/kernel", (None, "tp", None)),
            (r"attn/wo/kernel", ("tp", None, None)),
            (r"mlp/(gate|up)/kernel", (None, "tp")),
            (r"mlp/down/kernel", ("tp", None))]


def statesync_round_trip(rank: int, world: int, store: str,
                         out: str) -> None:
    """Each check's verdict (True or the error's text) into ``out``."""
    from horovod_tpu_torch.checkpoint import (load_train_state,
                                              whole_tree_template)
    from horovod_tpu_torch.training import TrainState
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    found: dict = {}

    def sharded(codec: str, seed: int):
        model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                                  device="cpu", seed=seed)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        trainer = Trainer(model, opt, build_mesh(tp=world, device="cpu"),
                          sync=GradSyncConfig(axes=(), compression=codec),
                          param_rules=ShardingRules(TP_RULES))
        return trainer, trainer.init()

    def layout(tree):
        return [(k, tuple(v.shape), v.dtype) for k, v in tree.items()]
    try:
        for codec in ("int8", "uint4"):
            trainer, state = sharded(codec, 0)
            tokens = torch.from_numpy(np.random.default_rng(3).integers(
                0, 256, (2, 17)))
            trainer.step(state, {"input": tokens[:, :-1],
                                 "label": tokens[:, 1:]})
            try:
                train_state_tree(state)
                found[f"{codec}/refused"] = "no error"
            except NotImplementedError as exc:
                found[f"{codec}/refused"] = "gather=True" in str(exc)
            tree = {k: v.clone() for k, v in
                    train_state_tree(state, gather=True).items()}
            plain = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                                      device="cpu", seed=2)
            fresh = TrainState(step=0, model=plain, optimizer=torch.optim.SGD(
                plain.parameters(), lr=0.1, momentum=0.9))
            found[f"{codec}/templates"] = \
                layout(whole_tree_template(state)) == layout(tree) \
                == layout(whole_tree_template(fresh)) \
                == layout(train_state_tree(fresh))
            _, target = sharded(codec, 1)
            load_train_state(tree, target)
            again = train_state_tree(target, gather=True)
            found[f"{codec}/round_trip"] = list(again) == list(tree) and all(
                torch.equal(again[k], tree[k]) for k in tree)
            found[f"{codec}/chunks"] = all(
                torch.equal(a, b) for a, b in
                zip(state.model.parameters(), target.model.parameters()))
            for bad, what in (({k: v for k, v in tree.items()
                                if k != "step"}, "leaves"),
                              ({**tree, "step": tree["step"].int()},
                               "dtype")):
                try:
                    load_train_state(bad, target)
                    found[f"{codec}/refuses_{what}"] = "no error"
                except ValueError:
                    found[f"{codec}/refuses_{what}"] = True
        with open(out, "w") as f:
            json.dump(found, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "statesync":
        statesync_round_trip(int(sys.argv[2]), int(sys.argv[3]),
                             *sys.argv[4:6])
    else:
        main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
