"""The cards phase of ``chip_smoke.py`` on the CPU: its training legs in a
gloo world of two ranks against the JAX package, and a rehearsal of the
whole phase with two fake cards.

- (a) ``chip_smoke.cards_train``, the function every rank of the phase
  trains gpt with, on fp32 gpt_tiny at dp=2, B/2 a rank
  (``tests/torch_cards_worker.py``), against the JAX ``Trainer`` at dp=2
  on two devices of the 8-device CPU mesh, on the same global batch and
  from the same weights (drawn by flax, carried across by ``convert``),
  3 AdamW(3e-4) steps on the bf16, int8 and optimizer-in-ring wires.
  Both ranks' parameter digests agree after every step.  The bf16 and ring
  wires' losses within 1e-5 relative; int8's within 1e-4, since a
  quantization level may land one step apart where XLA rounds a scale
  one ulp off (``tests/test_torch_grad_sync.py``).  The parameters'
  updates as ``tests/test_torch_parallel_worlds.py`` holds them: almost
  all to 1 % or a few ulps, none by more than 2 lr a step; on the int8
  wire a gradient within a level of zero takes AdamW's step of about lr
  either way, so there each leaf's mean distance must stay within 1 % of
  lr a step (gpt_tiny's largest is 0.4 %).
- (b) ``chip_smoke.bn_steps`` on the small ResNet of
  ``tests/test_torch_cnn_training.py`` with cross-replica BatchNorm
  (``axis_name="dp"``) at dp=2, B/2 a rank, two SGD(0.1, 0.9) steps
  (that file shows the third to be ill-conditioned), against JAX at dp=2
  (losses 1e-5 relative, parameters and statistics 1e-5) and against one
  rank at B through the same function (logits 1e-5 of their largest,
  parameters and statistics 1e-5).
- (c) ``tests/torch_cards_rehearsal.py``: ``chip_smoke.phase_cards()``
  with gpt_tiny and a small ResNet, two fake cards whose plane is gloo,
  and its launcher worlds of one and two ranks; the phase's own checks
  must pass and every leg report.

The world and the rehearsal run one after the other, one compute thread
a rank.
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
from jax.sharding import Mesh, PartitionSpec as P

import chip_smoke
from horovod_tpu import training as jtrain
from horovod_tpu.models import resnet as jres
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import GradSyncConfig as JSync
from horovod_tpu.parallel import MeshSpec as JMeshSpec
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu.parallel.mesh import DEFAULT_AXES
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models import transformer as ttr
from torch_cnn_util import assert_trees_close, load, random_variables

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_cards_worker.py"
REHEARSAL = Path(__file__).resolve().parent / "torch_cards_rehearsal.py"
WIRES = {"bf16": dict(compression="bf16"), "int8": dict(compression="int8"),
         "ring": dict(compression="bf16", optimizer_in_ring=True)}
LOSS_RTOL = {"bf16": 1e-5, "int8": 1e-4, "ring": 1e-5}
STEPS, LR, B, T = 3, 3e-4, 4, 16
CNN = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)
IMAGES, SIZE, BN_STEPS, TOL = 16, 16, 2, 1e-5


def _mesh(dp: int) -> Mesh:
    sizes = [dp if a == "dp" else 1 for a in DEFAULT_AXES]
    return Mesh(np.array(jax.devices()[:dp]).reshape(sizes), DEFAULT_AXES)


def _flax_resnet():
    return jres.ResNet(stage_sizes=tuple(CNN["stage_sizes"]),
                       block_cls=jres.BottleneckBlock,
                       num_filters=CNN["num_filters"],
                       num_classes=CNN["num_classes"], dtype=jnp.float32,
                       axis_name="dp")


def _port_resnet():
    return tres.ResNet(CNN["stage_sizes"], tres.BottleneckBlock,
                       num_filters=CNN["num_filters"],
                       num_classes=CNN["num_classes"], dtype=torch.float32,
                       axis_name="dp", device="cpu")


def _jax_gpt(wire: str, tokens: np.ndarray) -> dict:
    mesh = _mesh(2)
    cfg = jtr.gpt_tiny(dtype=jnp.float32, mesh=mesh)
    trainer = jtrain.Trainer(
        jtr.TransformerLM(cfg), optax.adamw(LR), mesh,
        sync=JSync(axes=("dp",), op="average", **WIRES[wire]),
        batch_spec=P("dp"))
    batch = {"input": jnp.asarray(tokens[:, :-1], jnp.int32),
             "label": jnp.asarray(tokens[:, 1:], jnp.int32)}
    state = trainer.init(jax.random.key(7), batch)
    params0 = jax.tree_util.tree_map(np.array, state.params)
    losses = []
    for _ in range(STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    return {"losses": np.array(losses), "params0": params0,
            "params": jax.tree_util.tree_map(np.asarray, state.params)}


def _jax_bn(variables, images, labels) -> dict:
    mesh = jbuild_mesh(JMeshSpec(dp=2), devices=jax.devices()[:2])
    trainer = jtrain.Trainer(_flax_resnet(), optax.sgd(0.1, momentum=0.9),
                             mesh, sync=JSync(axes=("dp",), op="average"))
    batch = {"image": jnp.asarray(images),
             "label": jnp.asarray(labels, jnp.int32)}
    state = trainer.init(jax.random.key(0), batch)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = dataclasses.replace(
        state, params=params, opt_state=trainer._init_opt_state(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    losses, after = [], []
    for _ in range(BN_STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
        after.append(jax.tree_util.tree_map(np.array, state.params))
    return {"losses": losses, "params": after,
            "stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The gloo world's outputs, the JAX references, and the inputs."""
    tmp = tmp_path_factory.mktemp("cards")
    rng = np.random.default_rng(16)
    tokens = rng.integers(0, 256, (B, T + 1))
    images = rng.standard_normal((IMAGES, SIZE, SIZE, 3)).astype(np.float32)
    classes = rng.integers(0, CNN["num_classes"], IMAGES).astype(np.int64)
    variables = random_variables(_flax_resnet(), images.shape, seed=3)
    refs = {wire: _jax_gpt(wire, tokens) for wire in WIRES}
    params0 = refs["bf16"]["params0"]
    inputs = {"config": np.array(json.dumps(dict(
                  wires=WIRES, steps=STEPS, bn_steps=BN_STEPS, cnn=CNN))),
              "inputs": tokens[:, :-1], "labels": tokens[:, 1:],
              "images": images, "classes": classes}
    for name, v in convert.params_from_flax(params0,
                                            ttr.gpt_tiny()).items():
        inputs[f"gpt/{name}"] = v.numpy()
    for name, v in load(_port_resnet(), variables).state_dict().items():
        inputs[f"cnn/{name}"] = v.numpy()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", str(tmp / "store"),
         str(tmp / "inputs.npz"), str(tmp / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        bn_ref = _jax_bn(variables, images, classes)
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]
    return {"outs": outs, "refs": refs, "bn_ref": bn_ref,
            "variables": variables, "images": images, "classes": classes}


def _state(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in out.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("wire", list(WIRES))
def test_cards_train_matches_jax_at_dp2(world, wire):
    outs, ref = world["outs"], world["refs"][wire]
    for out in outs:
        np.testing.assert_allclose(out[f"{wire}/losses"], ref["losses"],
                                   rtol=LOSS_RTOL[wire], atol=0)
        assert out[f"{wire}/digests_equal"]
    assert ref["losses"][-1] < ref["losses"][0]
    prefix = f"{wire}/state/"
    for k in outs[0]:
        if k.startswith(prefix):
            np.testing.assert_array_equal(outs[0][k], outs[1][k], k)
    final = convert.params_to_flax(_state(outs[0], prefix), ttr.gpt_tiny())
    jflat = jax.tree_util.tree_leaves_with_path(ref["params"])
    tflat = jax.tree_util.tree_leaves(final)
    p0 = jax.tree_util.tree_leaves(ref["params0"])
    assert len(jflat) == len(tflat) == len(p0)
    for (path, jv), tv, start in zip(jflat, tflat, p0):
        label = jax.tree_util.keystr(path)
        dj, dt = jv - start, tv - start
        assert np.abs(dt - dj).max() <= 2 * LR * STEPS, label
        if wire == "int8":
            # Where a gradient is within a quantization level of zero,
            # AdamW's first steps move it by about lr either way.
            assert np.abs(dt - dj).mean() <= 1e-2 * LR * STEPS, label
            continue
        close = np.abs(dt - dj) <= 1e-2 * np.abs(dj) \
            + 4 * np.spacing(np.abs(start))
        assert close.mean() > 0.99, (label, close.mean())


def test_cards_cross_replica_bn_matches_jax_and_one_rank(world):
    outs, ref = world["outs"], world["bn_ref"]
    images, classes = world["images"], world["classes"]
    one = chip_smoke.bn_steps(load(_port_resnet(), world["variables"]),
                              {"image": torch.from_numpy(images),
                               "label": torch.from_numpy(classes)},
                              BN_STEPS)
    logits = np.concatenate([out["bn/logits"] for out in outs])
    scale = np.abs(one["logits"].numpy()).max()
    np.testing.assert_allclose(logits, one["logits"].numpy(), rtol=0,
                               atol=TOL * scale)
    for out in outs:
        np.testing.assert_allclose(out["bn/losses"], ref["losses"],
                                   rtol=TOL)
        np.testing.assert_allclose(out["bn/losses"], one["losses"],
                                   rtol=TOL)
        for step in range(BN_STEPS):
            got = _state(out, f"bn/step{step + 1}/")
            for name, want in one["params"][step].items():
                np.testing.assert_allclose(got[name], want, rtol=0,
                                           atol=TOL, err_msg=name)
            params, _ = convert.cnn_params_to_flax(
                {**got, **_state(out, "bn/stats/")})
            assert_trees_close(params, ref["params"][step], atol=TOL)
        stats = _state(out, "bn/stats/")
        for name, want in one["stats"].items():
            np.testing.assert_allclose(stats[name], want, rtol=0, atol=TOL,
                                       err_msg=name)
        _, jstats = convert.cnn_params_to_flax(
            {**_state(out, f"bn/step{BN_STEPS}/"), **stats})
        assert_trees_close(jstats, ref["stats"], atol=TOL)
    for k in outs[0]:
        if k.startswith(("bn/step", "bn/stats")):
            np.testing.assert_array_equal(outs[0][k], outs[1][k], k)


def test_cards_phase_rehearsal_at_two_cards(tmp_path):
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    env.pop("HOROVOD_RANK", None)
    env.pop("HOROVOD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, str(REHEARSAL), str(tmp_path / "out.json")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(tmp_path / "out.json") as f:
        run = json.load(f)
    assert run["error"] is None, run["error"]
    legs = {line["leg"]: line for line in run["lines"]}
    assert {"one-card-reference", "launcher-np1", "world", "gpt-parity",
            "gpt-gpt", "wires", "resnet50", "plane", "streams", "binding",
            "syncbn", "summary"} <= set(legs)
    one = legs["launcher-np1"]
    assert one["rc"] == 0 and one["losses_bitwise_one_card"]
    w = legs["world"]
    assert w["rc"] == 0 and w["device_plane"] == [True, True]
    assert w["backend"] == ["gloo", "gloo"]
    parity = legs["gpt-parity"]
    assert parity["params_equal_every_step"] == [True, True]
    assert parity["batch_equal_one_card"]
    assert legs["plane"]["mismatches"] == [] and legs["plane"]["checks"] > 0
    assert legs["wires"]["ring"]["optimizer_state_share_of_one_card"] \
        == pytest.approx(0.5, rel=1e-3)
    assert legs["summary"]["problems"] == []
