"""The port's Trainer on a small ResNet against the JAX Trainer on the CPU:
three SGD(0.1, momentum 0.9) steps from the same weights (drawn with
numpy) on the same batch of 16 images of 16x16, fp32.

- one rank against a 1-device mesh;
- a 2-rank gloo world (``tests/torch_cnn_worker.py``, 8 images a rank)
  against a 2-device mesh on the same global batch: the loss, the
  gradients (through the parameters) and the BatchNorm statistics are
  averaged over ``dp`` on both sides, and the two ranks end equal;
- the same with ``optimizer_in_ring=True`` on both sides: the reference's
  ring branch against ``Trainer``'s ``sync_and_apply``, each rank's
  optimizer state one flat shard of ``ring_chunk_size`` elements.

Losses within 1e-5 relative; parameters and ``batch_stats`` within 1e-5.
"""
from __future__ import annotations

import dataclasses
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

from horovod_tpu import training as jtrain
from horovod_tpu.models import resnet as jres
from horovod_tpu.parallel import GradSyncConfig as JSync
from horovod_tpu.parallel import MeshSpec as JMeshSpec
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as ttrain
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.parallel import build_mesh as tbuild_mesh
from horovod_tpu_torch.parallel import grad_sync as tsync
from torch_cnn_util import assert_trees_close, load, random_variables

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_cnn_worker.py"
STAGES, FILTERS, CLASSES = (1, 1), 8, 10
B, SIZE, STEPS, LR, MOMENTUM = 16, 16, 3, 0.1, 0.9
TOL = 1e-5


def _flax_model():
    return jres.ResNet(stage_sizes=STAGES, block_cls=jres.BottleneckBlock,
                       num_filters=FILTERS, num_classes=CLASSES,
                       dtype=jnp.float32)


def _port_model():
    return tres.ResNet(STAGES, tres.BottleneckBlock, num_filters=FILTERS,
                       num_classes=CLASSES, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, B).astype(np.int64)
    variables = random_variables(_flax_model(), images.shape, seed=1)
    return variables, images, labels


def _run_jax(variables, images, labels, devices, **sync):
    mesh = jbuild_mesh(JMeshSpec(dp=devices),
                       devices=jax.devices()[:devices])
    tx = optax.sgd(LR, momentum=MOMENTUM)
    trainer = jtrain.Trainer(_flax_model(), tx, mesh,
                             sync=JSync(axes=("dp",), op="average", **sync))
    batch = {"image": jnp.asarray(images),
             "label": jnp.asarray(labels, jnp.int32)}
    state = trainer.init(jax.random.key(0), batch)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = dataclasses.replace(
        state, params=params, opt_state=trainer._init_opt_state(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    losses = []
    for _ in range(STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    return (losses, jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))


def test_trainer_matches_jax(setup):
    variables, images, labels = setup
    jlosses, jparams, jstats = _run_jax(variables, images, labels, 1)
    model = load(_port_model(), variables)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    trainer = ttrain.Trainer(model, opt, tbuild_mesh(device="cpu"))
    state = trainer.init()
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)}
    losses = []
    for _ in range(STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    assert state.step == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    assert losses[-1] < losses[0]
    params, stats = convert.cnn_params_to_flax(model.state_dict())
    assert_trees_close(params, jparams, atol=TOL)
    assert_trees_close(stats, jstats, atol=TOL)
    # bn_init and 4 BatchNorms in each of the 2 blocks, mean and var each.
    assert set(state.batch_stats) == {n for n, _ in model.named_buffers()}
    assert len(state.batch_stats) == 18
    evaluated = trainer.eval_step(state, batch)
    assert np.isfinite(float(evaluated["loss"]))


def test_trainer_buckets_follow_the_flax_order():
    assert ttrain._leaf_order(_port_model()) == convert.cnn_leaf_order(
        _port_model())


def test_synthetic_image_batch():
    batch = ttrain.synthetic_image_batch(3, image_size=8, num_classes=5,
                                         seed=2, device="cpu")
    assert batch["image"].shape == (3, 8, 8, 3)
    assert batch["image"].dtype == torch.float32
    assert batch["label"].shape == (3,) and int(batch["label"].max()) < 5
    again = ttrain.synthetic_image_batch(3, image_size=8, num_classes=5,
                                         seed=2, device="cpu")
    assert torch.equal(batch["image"], again["image"])
    assert torch.equal(batch["label"], again["label"])


def _gloo_train(tmp_path, variables, images, labels, world=2, **sync):
    model = load(_port_model(), variables)
    inputs = {f"state/{k}": v.numpy() for k, v in model.state_dict().items()}
    config = dict(stage_sizes=list(STAGES), num_filters=FILTERS,
                  num_classes=CLASSES, steps=STEPS, lr=LR, momentum=MOMENTUM)
    if sync:
        config["sync"] = dict(op="average", **sync)
    inputs.update(images=images, labels=labels,
                  config=np.array(json.dumps(config)))
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / "inputs.npz"),
         str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [np.load(tmp_path / f"out{r}.npz") for r in range(world)]


def test_gloo_world_matches_jax_dp2(setup, tmp_path):
    variables, images, labels = setup
    jlosses, jparams, jstats = _run_jax(variables, images, labels, 2)
    outs = _gloo_train(tmp_path, variables, images, labels)
    names = [k for k in outs[0].files if k.startswith("state/")]
    for out in outs:
        np.testing.assert_allclose(out["losses"], jlosses, rtol=TOL)
        params, stats = convert.cnn_params_to_flax(
            {k[len("state/"):]: torch.from_numpy(out[k]) for k in names})
        assert_trees_close(params, jparams, atol=TOL)
        assert_trees_close(stats, jstats, atol=TOL)
    for k in names:                 # the ranks end with one state
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    # Each rank saw other images: its own statistics would differ.
    single = _run_jax(variables, images[:B // 2], labels[:B // 2], 1)[2]
    diff = max(np.abs(a - b).max() for a, b in zip(
        jax.tree_util.tree_leaves(single), jax.tree_util.tree_leaves(jstats)))
    assert diff > 100 * TOL


def test_gloo_ring_trainer_matches_jax_dp2(setup, tmp_path):
    variables, images, labels = setup
    jlosses, jparams, jstats = _run_jax(variables, images, labels, 2,
                                        optimizer_in_ring=True)
    outs = _gloo_train(tmp_path, variables, images, labels,
                       optimizer_in_ring=True)
    names = [k for k in outs[0].files if k.startswith("state/")]
    n_params = sum(v.size for v in jax.tree_util.tree_leaves(
        variables["params"]))
    chunk = tsync.ring_chunk_size(n_params, 2, tsync.GradSyncConfig())
    for out in outs:
        np.testing.assert_allclose(out["losses"], jlosses, rtol=TOL)
        params, stats = convert.cnn_params_to_flax(
            {k[len("state/"):]: torch.from_numpy(out[k]) for k in names})
        assert_trees_close(params, jparams, atol=TOL)
        assert_trees_close(stats, jstats, atol=TOL)
        # SGD with momentum: the shard and its momentum buffer, 1/world
        # of the parameters each.
        assert out["opt_numel"].tolist() == [chunk, chunk]
    for k in names:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert jlosses[-1] < jlosses[0]
