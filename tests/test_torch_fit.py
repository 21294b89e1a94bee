"""``Trainer.fit`` and the callbacks of the port (``training.py``,
``callbacks.py``) against the JAX package's, and the profiler hooks.

- The LR callbacks set the reference's lrs at every epoch and batch,
  staircase and smooth, warmup with and without ``steps_per_epoch``, on
  an object with ``lr`` and on ``torch.optim`` param groups; on a ring
  Trainer they act on its shard optimizer.
- gpt_tiny (fp32, AdamW) through ``fit``, 2 epochs of a
  ``ShardedBatchLoader``, against the reference's ``Trainer.fit`` on the
  same batches from the same weights: the history within
  ``tests/test_torch_training.py``'s step tolerance (rtol 1e-5, atol
  1e-5), the callback events equal.
- ``BestModelCheckpoint`` saves only on improvement;
  ``MetricAverageCallback`` and the rank-0 rules in a 2-rank eager host
  world (``tests/torch_fit_worker.py``); the elastic callbacks over the
  port's ``ObjectState`` and ``TorchState``.
- ``HOROVOD_FLEET=1`` raises; ``start_profiler``/``stop_profiler`` write
  a trace holding ``profiler_annotation``'s name.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import callbacks as jcb
from horovod_tpu import training as jtrain
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import GradSyncConfig as JSync
from horovod_tpu.parallel import MeshSpec as JMeshSpec
from horovod_tpu.parallel import build_mesh as jbuild_mesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as tcb
from horovod_tpu_torch import checkpoint, convert
from horovod_tpu_torch import training as ttrain
from horovod_tpu_torch.data import ShardedBatchLoader
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import GradSyncConfig, build_mesh
from torch_sigterm import restore_sigterm  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_fit_worker.py"
ROWS, B, T, VOCAB, EPOCHS = 8, 2, 16, 256, 2
LR, WD = 3e-4, 1e-4


class _Lr:
    def __init__(self, lr):
        self.lr = lr


def _lr_of(opt):
    return opt.param_groups[0]["lr"] if hasattr(opt, "param_groups") \
        else opt.lr


LR_CASES = {
    "staircase": lambda m, o: m.LearningRateScheduleCallback(
        o, multiplier=lambda e: 0.5 ** e),
    "window": lambda m, o: m.LearningRateScheduleCallback(
        o, multiplier=2.0, start_epoch=1, end_epoch=3),
    "smooth": lambda m, o: m.LearningRateScheduleCallback(
        o, multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
        steps_per_epoch=4),
    "smooth-no-steps": lambda m, o: m.LearningRateScheduleCallback(
        o, multiplier=lambda e: 0.9 ** e, staircase=False),
    "warmup": lambda m, o: m.LearningRateWarmupCallback(
        o, warmup_epochs=3, steps_per_epoch=4, size=8),
    "warmup-no-steps": lambda m, o: m.LearningRateWarmupCallback(
        o, warmup_epochs=2, size=4),
}


@pytest.mark.parametrize("case", sorted(LR_CASES))
@pytest.mark.parametrize("holder", ["lr", "param_groups"])
def test_lr_callbacks_set_the_references_lrs(case, holder):
    def make_opt():
        if holder == "lr":
            return _Lr(0.8)
        return torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.8)

    lrs = {}
    for side, mod in (("port", tcb), ("ref", jcb)):
        opt = make_opt()
        cb = LR_CASES[case](mod, opt)
        seen = []
        for epoch in range(5):
            cb.on_epoch_begin(epoch)
            seen.append(_lr_of(opt))
            for batch in range(4):
                cb.on_batch_begin(batch)
                seen.append(_lr_of(opt))
            cb.on_epoch_end(epoch)
        lrs[side] = seen
    assert lrs["port"] == lrs["ref"]
    assert len(set(lrs["port"])) > 1


def test_lr_callback_acts_on_the_ring_shard_optimizer():
    model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                              device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    trainer = ttrain.Trainer(model, opt, build_mesh(device="cpu"),
                             sync=GradSyncConfig(optimizer_in_ring=True))
    state = trainer.init()
    cb = tcb.LearningRateScheduleCallback(opt, multiplier=0.5,
                                          start_epoch=1)
    batch = ttrain.synthetic_text_batch(B, T, VOCAB, device="cpu")
    state, _ = trainer.fit(state, [batch], epochs=2, callbacks=[cb])
    assert state.optimizer is not opt
    assert state.optimizer.param_groups[0]["lr"] == LR * 0.5
    assert opt.param_groups[0]["lr"] == LR


def test_metric_average_single_process_noop():
    hvd.init()
    try:
        logs = {"loss": 1.5, "name": "x"}
        tcb.MetricAverageCallback().on_epoch_end(0, logs)
        assert logs == {"loss": 1.5, "name": "x"}
    finally:
        hvd.shutdown()


def test_metric_average_and_rank0_gating_in_a_host_world(tmp_path):
    from horovod_tpu_torch.runner.network import RendezvousServer
    server = RendezvousServer()
    port = server.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["HOROVOD_FLIGHT_FILE"] = str(tmp_path / "flight.json")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    # The mean over the ranks, the string kept.
    for o in outs:
        assert o["logs"] == {"loss": 2.25, "accuracy": 0.125, "name": "x"}
    # Rank 0's checkpoint is the one on disk; rank 1 wrote nothing.
    assert [o["checkpoint_rank"] for o in outs] == [0, 0]
    assert outs[0]["saved"] == [str(tmp_path / "best-0"),
                                str(tmp_path / "best-1")]
    assert outs[1]["saved"] == []


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.events = []

        def set_trainer(self, trainer):
            super().set_trainer(trainer)
            self.events.append(("set_trainer",))

        def set_state(self, state):
            self.events.append(("set_state",))

        def on_train_begin(self, logs=None):
            self.events.append(("train_begin",))

        def on_train_end(self, logs=None):
            self.events.append(("train_end",))

        def on_epoch_begin(self, epoch, logs=None):
            self.events.append(("epoch_begin", epoch))

        def on_epoch_end(self, epoch, logs=None):
            self.events.append(("epoch_end", epoch, sorted(logs)))

        def on_batch_begin(self, batch, logs=None):
            self.events.append(("batch_begin", batch))

        def on_batch_end(self, batch, logs=None):
            self.events.append(("batch_end", batch, sorted(logs)))
    return Recorder()


def _tokens():
    return np.random.default_rng(0).integers(0, VOCAB, (ROWS, T + 1))


def _epochs(loader):
    def data(epoch):
        loader.set_epoch(epoch)
        return loader
    return data


def _jax_fit():
    cfg = jtr.gpt_tiny(dtype=jnp.float32)
    mesh = jbuild_mesh(JMeshSpec(dp=1), devices=jax.devices()[:1])
    trainer = jtrain.Trainer(jtr.TransformerLM(cfg), optax.adamw(LR), mesh,
                             sync=JSync(axes=("dp",), op="average"))
    tokens = _tokens()
    loader = ShardedBatchLoader({"input": tokens[:, :-1].astype(np.int32),
                                 "label": tokens[:, 1:].astype(np.int32)},
                                batch_size=B, seed=3)
    state = trainer.init(jax.random.key(0), next(iter(loader)))
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    rec = _recorder(jcb.Callback)
    state, history = trainer.fit(state, _epochs(loader), epochs=EPOCHS,
                                 callbacks=[rec])
    return params0, history, rec.events


def test_fit_matches_the_reference(tmp_path):
    params0, jhistory, jevents = _jax_fit()
    cfg = ttr.gpt_tiny(dtype=torch.float32)
    model = ttr.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(params0, cfg))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    trainer = ttrain.Trainer(model, opt, build_mesh(device="cpu"))
    tokens = _tokens()
    loader = ShardedBatchLoader({"input": tokens[:, :-1], "label":
                                 tokens[:, 1:]}, batch_size=B, seed=3)
    rec = _recorder(tcb.Callback)
    best = tcb.BestModelCheckpoint(str(tmp_path / "best-{epoch}"))
    state, history = trainer.fit(trainer.init(), _epochs(loader),
                                 epochs=EPOCHS, callbacks=[rec, best])
    assert state.step == EPOCHS * ROWS // B
    assert len(history) == len(jhistory) == EPOCHS
    for got, want in zip(history, jhistory):
        assert sorted(got) == sorted(want) == ["accuracy", "loss"]
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5)
    assert history[1]["loss"] < history[0]["loss"]
    assert rec.events == jevents
    assert rec.events[:3] == [("set_trainer",), ("set_state",),
                              ("train_begin",)]
    # Both epochs improved: both saved, the last one the final state.
    assert sorted(os.listdir(tmp_path)) == ["best-0", "best-1"]
    final = checkpoint.restore_checkpoint(str(tmp_path / "best-1"))
    assert final["step"] == state.step
    for name, p in model.named_parameters():
        assert torch.equal(final[f"params/{name}"], p.detach()), name


def test_best_model_checkpoint_saves_only_on_improvement(tmp_path):
    saved = []
    best = tcb.BestModelCheckpoint(str(tmp_path / "ck-{epoch}"),
                                   monitor="loss",
                                   save_fn=lambda path, st: saved.append(
                                       (path, st)))
    best.set_state({"w": 1})
    for epoch, loss in enumerate((3.0, 2.0, 2.5, 1.0, 1.0)):
        best.on_epoch_end(epoch, {"loss": loss})
    assert [p for p, _ in saved] == [str(tmp_path / f"ck-{e}")
                                     for e in (0, 1, 3)]
    real = tcb.BestModelCheckpoint(str(tmp_path / "acc-{epoch}"),
                                   monitor="accuracy", mode="max")
    real.set_state({"w": torch.arange(3.0)})
    for epoch, acc in enumerate((0.1, 0.05, 0.3)):
        real.on_epoch_end(epoch, {"accuracy": acc})
    real.on_epoch_end(3, {"loss": 0.0})          # not monitored: nothing
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("acc")) == ["acc-0", "acc-2"]
    restored = checkpoint.restore_checkpoint(str(tmp_path / "acc-2"))
    assert torch.equal(restored["w"], torch.arange(3.0))


def test_elastic_callbacks_over_the_ports_states():
    from horovod_tpu_torch.elastic import ObjectState
    from horovod_tpu_torch.torch.elastic import TorchState

    obj = ObjectState(epoch=0, batch=0)
    commits = []
    obj.save = lambda: commits.append((obj.epoch, obj.batch))
    commit = tcb.CommitStateCallback(obj, batches_per_commit=2)
    update = tcb.UpdateBatchStateCallback(obj)
    for epoch in range(2):
        for batch in range(4):
            update.on_batch_end(batch)
            commit.on_batch_end(batch)
        update.on_epoch_end(epoch)
    assert commits == [(0, 1), (0, 3), (1, 1), (1, 3)]
    assert (obj.epoch, obj.batch) == (2, 0)

    model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                              device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    trainer = ttrain.Trainer(model, opt, build_mesh(device="cpu"))
    state = TorchState(model=model, optimizer=opt, epoch=0, batch=0)
    batch = ttrain.synthetic_text_batch(B, T, VOCAB, device="cpu")
    train_state, _ = trainer.fit(
        trainer.init(), [batch] * 3, epochs=1,
        callbacks=[tcb.UpdateBatchStateCallback(state),
                   tcb.CommitStateCallback(state, batches_per_commit=2)])
    # Committed after batch 1; batch 2 ran after it.
    committed = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.step(train_state, batch)
    state.restore()
    assert (state.epoch, state.batch) == (0, 1)   # the committed values
    moved = sum(not torch.equal(p.detach(), committed[n])
                for n, p in model.named_parameters())
    assert moved > 0        # the restore went back past batch 2


def test_fleet_raises(monkeypatch):
    monkeypatch.setenv("HOROVOD_FLEET", "1")
    model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                              device="cpu")
    trainer = ttrain.Trainer(model, torch.optim.SGD(model.parameters(),
                                                    lr=0.1),
                             build_mesh(device="cpu"))
    with pytest.raises(NotImplementedError, match="item 12"):
        trainer.fit(trainer.init(), [], epochs=1)


def test_fit_needs_the_card(monkeypatch):
    from horovod_tpu_torch.data import prefetch_to_device
    from horovod_tpu_torch.parallel.mesh import Mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                              device="cpu")
    mesh = Mesh(shape={"dp": 1}, group=None, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                       mesh)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        prefetch_to_device([{"input": np.zeros(2)}])


def test_profiler_hooks_write_the_annotation(tmp_path):
    logdir = str(tmp_path / "trace")
    hvd.start_profiler(logdir)
    with pytest.raises(RuntimeError, match="already"):
        hvd.start_profiler(logdir)
    with hvd.profiler_annotation("fit_step"):
        (torch.randn(32, 32) @ torch.randn(32, 32)).sum()
    hvd.stop_profiler()
    with pytest.raises(RuntimeError, match="no profile"):
        hvd.stop_profiler()
    traces = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "fit_step" for e in events)
