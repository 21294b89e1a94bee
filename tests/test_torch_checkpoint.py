"""The port's checkpoints (``horovod_tpu_torch/checkpoint.py``) on the CPU.

- A ``TrainState`` round trip (parameters, BatchNorm buffers, AdamW or
  SGD state, step) is bitwise, and the restored run's next step is the
  unbroken run's, bitwise.
- Ring checkpoints: a 4-rank gloo world (``tests/torch_cnn_worker.py``,
  a small ResNet, AdamW, ``optimizer_in_ring``) writes its shards; the
  port restores them on 2 ranks, and the 2-rank shards on 4, each
  bitwise the JAX package's ``restore_ring_checkpoint`` of the same
  files (``mu``/``nu`` against ``exp_avg``/``exp_avg_sq``).  A corrupted
  byte, a torn step, mixed world sizes and an incomplete set raise in
  both packages, with the reference's messages (as
  ``tests/test_statesync.py`` checks them).
- Rank-0 gating: ``tests/test_torch_fit.py``'s 2-rank host world.
- ``latest_checkpoint``.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import checkpoint as jck
from horovod_tpu.models import resnet as jres
from horovod_tpu_torch import checkpoint as ck
from horovod_tpu_torch import training
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import GradSyncConfig, build_mesh
from horovod_tpu_torch.parallel import grad_sync as tsync
from torch_cnn_util import load, random_variables, run_cnn_world

STAGES, FILTERS, CLASSES, B, SIZE = (1, 1), 8, 10, 16, 16
LR, WD = 1e-3, 1e-4


def _gpt(seed):
    model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                              device="cpu", seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=WD)
    trainer = training.Trainer(model, opt, build_mesh(device="cpu"))
    return trainer, trainer.init(), training.synthetic_text_batch(
        2, 16, 256, seed=1, device="cpu")


def _cnn(seed):
    model = tres.ResNet(STAGES, tres.BottleneckBlock, num_filters=FILTERS,
                        num_classes=CLASSES, dtype=torch.float32,
                        device="cpu", seed=seed)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    trainer = training.Trainer(model, opt, build_mesh(device="cpu"))
    return trainer, trainer.init(), training.synthetic_image_batch(
        4, SIZE, CLASSES, seed=1, device="cpu")


def _state_tensors(state):
    out = {f"p/{n}": p.detach().clone()
           for n, p in state.model.named_parameters()}
    out.update({f"b/{n}": b.clone() for n, b in state.model.named_buffers()})
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            out[f"o/{names.get(id(p), 'ring')}/{k}"] = \
                torch.as_tensor(v).clone()
    return out


def _assert_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("make", [_gpt, _cnn], ids=["gpt_adamw", "cnn_sgd"])
def test_train_state_round_trip_is_bitwise(make, tmp_path):
    trainer, state, batch = make(0)
    for _ in range(2):
        state, _ = trainer.step(state, batch)
    ck.save_checkpoint(str(tmp_path / "ck"), state)
    saved = _state_tensors(state)
    # A fresh model and optimizer, other weights, no optimizer state.
    trainer2, state2, _ = make(1)
    ck.restore_checkpoint(str(tmp_path / "ck"), target=state2)
    assert state2.step == 2
    _assert_equal(_state_tensors(state2), saved)
    state, m1 = trainer.step(state, batch)
    state2, m2 = trainer2.step(state2, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_equal(_state_tensors(state2), _state_tensors(state))
    # Without a target: the leaves as CPU tensors, and the step.
    flat = ck.restore_checkpoint(str(tmp_path / "ck"))
    assert flat["step"] == 2
    for name, t in saved.items():
        kind, rest = name.split("/", 1)
        key = {"p": "params/", "b": "batch_stats/", "o": "opt/"}[kind] + rest
        assert torch.equal(flat[key], t), key
    with open(tmp_path / "ck" / ck.MANIFEST) as f:
        manifest = json.load(f)
    assert manifest["optimizer"]["class"] == type(state.optimizer).__name__
    group = manifest["optimizer"]["param_groups"][0]
    assert group["lr"] == state.optimizer.param_groups[0]["lr"]
    assert len(group["params"]) == len(list(state.model.parameters()))


def test_mapping_round_trip_and_refusals(tmp_path):
    tree = {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "step": 7, "h": torch.ones(2, dtype=torch.bfloat16)}
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, tree)
    restored = ck.restore_checkpoint(path)
    np.testing.assert_array_equal(restored["w"].numpy(), tree["w"])
    assert int(restored["step"]) == 7
    assert restored["h"].dtype == torch.bfloat16
    target = {"w": torch.zeros(3, 4),
              "step": torch.zeros((), dtype=torch.int64),
              "h": torch.zeros(2, dtype=torch.bfloat16)}
    ck.restore_checkpoint(path, target=target)
    assert int(target["step"]) == 7 and torch.equal(target["h"], tree["h"])
    with pytest.raises(FileExistsError):
        ck.save_checkpoint(path, tree, force=False)
    image = tmp_path / "ck" / ck.IMAGE
    blob = bytearray(image.read_bytes())
    blob[5] ^= 0x01                              # one flipped bit
    image.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="digest check"):
        ck.restore_checkpoint(path)
    image.write_bytes(bytes(blob[:-2]))
    with pytest.raises(ValueError, match="bytes, the manifest says"):
        ck.restore_checkpoint(path)
    # A model whose leaves are not the checkpoint's.
    ck.save_checkpoint(path, tree)
    trainer, state, _ = _gpt(0)
    with pytest.raises(ValueError, match="not the target model's"):
        ck.restore_checkpoint(path, target=state)


def _ring_world(tmp_path, world, ring_dir):
    flax_model = jres.ResNet(stage_sizes=STAGES,
                             block_cls=jres.BottleneckBlock,
                             num_filters=FILTERS, num_classes=CLASSES,
                             dtype=jnp.float32)
    variables = random_variables(flax_model, (B, SIZE, SIZE, 3), seed=1)
    model = load(tres.ResNet(STAGES, tres.BottleneckBlock,
                             num_filters=FILTERS, num_classes=CLASSES,
                             dtype=torch.float32, device="cpu"), variables)
    rng = np.random.default_rng(0)
    inputs = {f"state/{k}": v.numpy() for k, v in model.state_dict().items()}
    config = dict(stage_sizes=list(STAGES), num_filters=FILTERS,
                  num_classes=CLASSES, steps=2, lr=LR, momentum=0.0,
                  weight_decay=WD, ring_dir=str(ring_dir),
                  sync=dict(op="average", optimizer_in_ring=True))
    inputs.update(
        images=rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
        labels=rng.integers(0, CLASSES, B).astype(np.int64),
        config=np.array(json.dumps(config)))
    run_cnn_world(tmp_path, inputs, world)
    return sum(np.asarray(v).size for k, v in inputs.items()
               if k.startswith("state/") and not k.endswith((".mean",
                                                             ".var")))


def _shard_optimizer(n_params, world):
    param = torch.nn.Parameter(torch.zeros(4))
    opt = torch.optim.AdamW([param], lr=LR, weight_decay=WD)
    return tsync.init_ring_optimizer(opt, [torch.zeros(n_params)], world,
                                     GradSyncConfig())


def _restore_both(directory, n_params, world):
    """Each rank's shard as the port restores it (returned and loaded
    into a shard optimizer) and as the reference does, from one set of
    files."""
    tx = optax.adamw(LR, weight_decay=WD)
    out = []
    for rank in range(world):
        opt = _shard_optimizer(n_params, world)
        shard, step = ck.restore_ring_checkpoint(directory, opt, rank=rank,
                                                 world=world)
        ref, ref_step = jck.restore_ring_checkpoint(
            directory, tx, rank=rank, world=world, n_params=n_params)
        assert step == ref_step == 2
        ref_adam = ref[0]
        for leaf, want in (("count", ref_adam.count), ("mu", ref_adam.mu),
                           ("nu", ref_adam.nu)):
            want = np.asarray(want)
            assert shard[leaf].dtype == want.dtype, leaf
            np.testing.assert_array_equal(shard[leaf], want)
        state = opt.state[opt.param_groups[0]["params"][0]]
        np.testing.assert_array_equal(state["exp_avg"].numpy(),
                                      np.asarray(ref_adam.mu))
        np.testing.assert_array_equal(state["exp_avg_sq"].numpy(),
                                      np.asarray(ref_adam.nu))
        assert float(state["step"]) == 2.0
        out.append(opt)
    return out


def test_ring_checkpoint_reshards_as_the_reference(tmp_path):
    four = tmp_path / "four"
    n_params = _ring_world(tmp_path, 4, four)
    assert sorted(os.listdir(four)) == sorted(
        f"ring-{r}-of-4.{ext}" for r in range(4) for ext in ("json",
                                                             "state"))
    chunk4 = tsync.ring_chunk_size(n_params, 4, GradSyncConfig())
    with open(four / "ring-0-of-4.json") as f:
        meta = json.load(f)
    assert meta["n_params"] == n_params and meta["step"] == 2
    assert meta["nbytes"] == 4 + 2 * 4 * chunk4
    # 4 -> 2, then the 2-rank shards -> 4: the full state back.
    two_opts = _restore_both(str(four), n_params, 2)
    two = tmp_path / "two"
    for rank, opt in enumerate(two_opts):
        ck.save_ring_checkpoint(str(two), opt, rank=rank, world=2,
                                n_params=n_params, step=2)
    back = _restore_both(str(two), n_params, 4)
    again = _restore_both(str(four), n_params, 4)
    for a, b in zip(back, again):
        sa = a.state[a.param_groups[0]["params"][0]]
        sb = b.state[b.param_groups[0]["params"][0]]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    # The refusals, in both packages, on the same files.
    tx = optax.adamw(LR, weight_decay=WD)

    def refuse(directory, match):
        with pytest.raises(ValueError, match=match):
            ck.restore_ring_checkpoint(str(directory),
                                       _shard_optimizer(n_params, 1),
                                       rank=0, world=1)
        with pytest.raises(ValueError, match=match):
            jck.restore_ring_checkpoint(str(directory), tx, rank=0, world=1,
                                        n_params=n_params)

    mixed = tmp_path / "mixed"
    shutil.copytree(four, mixed)
    for name in os.listdir(two):
        shutil.copy(two / name, mixed / name)
    refuse(mixed, "mixed world sizes")
    partial = tmp_path / "partial"
    shutil.copytree(four, partial)
    os.remove(partial / "ring-2-of-4.state")
    refuse(partial, "incomplete ring checkpoint")
    torn = tmp_path / "torn"
    shutil.copytree(two, torn)
    ck.save_ring_checkpoint(str(torn), two_opts[1], rank=1, world=2,
                            n_params=n_params, step=3)
    refuse(torn, "torn ring checkpoint")
    corrupt = tmp_path / "corrupt"
    shutil.copytree(two, corrupt)
    victim = corrupt / "ring-1-of-2.state"
    blob = bytearray(victim.read_bytes())
    blob[7] ^= 0xff
    victim.write_bytes(bytes(blob))
    refuse(corrupt, "digest check")
    with pytest.raises(FileNotFoundError):
        ck.restore_ring_checkpoint(str(tmp_path / "none"),
                                   _shard_optimizer(n_params, 1), rank=0,
                                   world=1)


def test_ring_trainer_state_round_trip(tmp_path):
    """A ring Trainer's ``save_checkpoint`` keeps the shard optimizer's
    state out; the ring checkpoint carries it, and the resumed step is
    the unbroken one's, bitwise."""
    def make(seed):
        model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                                  device="cpu", seed=seed)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=WD)
        trainer = training.Trainer(model, opt, build_mesh(device="cpu"),
                                   sync=GradSyncConfig(
                                       optimizer_in_ring=True))
        return trainer, trainer.init()
    batch = training.synthetic_text_batch(2, 16, 256, seed=2, device="cpu")
    trainer, state = make(0)
    for _ in range(2):
        state, _ = trainer.step(state, batch)
    n_params = sum(p.numel() for p in state.model.parameters())
    ck.save_checkpoint(str(tmp_path / "ck"), state)
    ck.save_ring_checkpoint(str(tmp_path / "ring"), state.optimizer, rank=0,
                            world=1, n_params=n_params, step=state.step)
    with open(tmp_path / "ck" / ck.MANIFEST) as f:
        manifest = json.load(f)
    assert manifest["optimizer"] == {"class": "AdamW", "ring": True}
    assert not any(leaf["name"].startswith("opt/")
                   for leaf in manifest["leaves"])
    trainer2, state2 = make(1)
    ck.restore_checkpoint(str(tmp_path / "ck"), target=state2)
    _, step = ck.restore_ring_checkpoint(str(tmp_path / "ring"),
                                         state2.optimizer, rank=0, world=1)
    assert step == state2.step == 2
    state, m1 = trainer.step(state, batch)
    state2, m2 = trainer2.step(state2, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_equal(_state_tensors(state2), _state_tensors(state))


def test_ring_state_maps_onto_optax_leaves():
    for opt_cls, kw, names in (
            (torch.optim.Adam, {}, ["count", "mu", "nu"]),
            (torch.optim.SGD, {"momentum": 0.9}, ["trace"]),
            (torch.optim.SGD, {}, [])):
        opt = opt_cls([torch.nn.Parameter(torch.zeros(3))], lr=0.1, **kw)
        assert list(ck.ring_state_tree(opt)) == names
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(3))],
                           amsgrad=True)
    with pytest.raises(ValueError, match="no optax counterpart"):
        ck.ring_state_tree(opt)
    # optax.adamw's state flattens to the same leaves, in that order.
    ref = optax.adamw(LR).init(jnp.zeros(3, jnp.float32))
    import jax
    assert [np.asarray(x).dtype for x in jax.tree_util.tree_leaves(ref)] == \
        [np.int32, np.float32, np.float32]


def test_latest_checkpoint(tmp_path):
    a, b = tmp_path / "1", tmp_path / "2"
    a.mkdir()
    time.sleep(0.01)
    b.mkdir()
    os.utime(b)
    assert ck.latest_checkpoint(str(tmp_path)).endswith("2")
    assert ck.latest_checkpoint(str(tmp_path / "nope")) is None
    assert jck.latest_checkpoint(str(tmp_path)).endswith("2")
