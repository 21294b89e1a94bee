"""The port's Trainer against the JAX Trainer on the CPU: three steps of
gpt_tiny with flash attention (the Pallas kernels interpreted on the JAX
side) and AdamW, from the same weights on the same batch, on a mesh of one
device.  Losses per step and the final parameters agree."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import training as jtrain
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import GradSyncConfig as JSync
from horovod_tpu.parallel import MeshSpec as JMeshSpec
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as ttrain
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import GradSyncConfig as TSync
from horovod_tpu_torch.parallel import build_mesh as tbuild_mesh

B, T, STEPS, LR, WD = 2, 32, 3, 3e-4, 1e-4


def _batch(seed=0, vocab=256):
    tokens = np.random.default_rng(seed).integers(0, vocab, (B, T + 1))
    return tokens[:, :-1], tokens[:, 1:]


def _run_jax(compression, inputs, labels):
    cfg = jtr.gpt_tiny(dtype=jnp.float32, attention="flash",
                       flash_interpret=True, block_q=16, block_k=16)
    mesh = jbuild_mesh(JMeshSpec(dp=1), devices=jax.devices()[:1])
    trainer = jtrain.Trainer(
        jtr.TransformerLM(cfg), optax.adamw(LR), mesh,
        sync=JSync(axes=("dp",), op="average", compression=compression))
    batch = {"input": jnp.asarray(inputs, jnp.int32),
             "label": jnp.asarray(labels, jnp.int32)}
    state = trainer.init(jax.random.key(0), batch)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    losses = []
    for _ in range(STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    final = jax.tree_util.tree_map(np.asarray, state.params)
    evaluated = {k: float(v) for k, v in trainer.eval_step(state,
                                                           batch).items()}
    return params0, losses, final, evaluated


def _run_torch(compression, params0, inputs, labels):
    cfg = ttr.gpt_tiny(dtype=torch.float32, attention="flash")
    model = ttr.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(params0, cfg))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    trainer = ttrain.Trainer(model, opt, tbuild_mesh(dp=1, device="cpu"),
                             sync=TSync(op="average",
                                        compression=compression))
    state = trainer.init()
    batch = {"input": torch.from_numpy(inputs),
             "label": torch.from_numpy(labels)}
    losses = []
    for _ in range(STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    assert state.step == STEPS
    final = convert.params_to_flax(model.state_dict(), cfg)
    evaluated = {k: float(v) for k, v in trainer.eval_step(state,
                                                           batch).items()}
    return losses, final, evaluated


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.mark.parametrize("compression", [None, "fp16"])
def test_trainer_matches_jax(batch, compression):
    inputs, labels = batch
    params0, jlosses, jfinal, jeval = _run_jax(compression, inputs, labels)
    tlosses, tfinal, teval = _run_torch(compression, params0, inputs, labels)
    # fp32 forward and backward agree to ~1e-6 relative (sums in another
    # order); the fp16 wire rounds the gradients to 11 bits on both sides,
    # which moves a loss after an update by far less than 1e-4.
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-5)
    assert tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(teval["loss"], jeval["loss"], rtol=1e-5)
    np.testing.assert_allclose(teval["accuracy"], jeval["accuracy"],
                               atol=1e-6)
    # AdamW moves each weight by about lr a step.  Where the gradient is
    # nearly zero, m/sqrt(v) is sensitive to its last bits, so compare the
    # updates: almost all agree to 1% or to a few ulps of the weight (rows
    # of the embedding that no token picks move by weight decay alone,
    # lr * wd * w, near the weight's own rounding), none by more than 2 lr.
    jflat = jax.tree_util.tree_leaves_with_path(jfinal)
    tflat = jax.tree_util.tree_leaves(tfinal)
    p0 = jax.tree_util.tree_leaves(params0)
    for (path, j), t, start in zip(jflat, tflat, p0):
        name = jax.tree_util.keystr(path)
        dj, dt = j - start, t - start
        assert np.abs(dt - dj).max() <= 2 * LR * STEPS, name
        close = np.abs(dt - dj) <= 1e-2 * np.abs(dj) \
            + 4 * np.spacing(np.abs(start))
        assert close.mean() > 0.99, (name, close.mean())


def test_trainer_without_accuracy(monkeypatch, batch):
    monkeypatch.setenv("HOROVOD_TRACK_ACCURACY", "0")
    cfg = ttr.gpt_tiny(dtype=torch.float32)
    model = ttr.TransformerLM(cfg, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    trainer = ttrain.Trainer(model, opt, tbuild_mesh(device="cpu"))
    inputs, labels = batch
    _, metrics = trainer.step(trainer.init(), {
        "input": torch.from_numpy(inputs), "label": torch.from_numpy(labels)})
    assert set(metrics) == {"loss"}
    assert dataclasses.is_dataclass(trainer.init())


def test_synthetic_text_batch_shifts_labels():
    batch = ttrain.synthetic_text_batch(3, seq_len=16, vocab_size=50,
                                        seed=1, device="cpu")
    assert batch["input"].shape == (3, 16) == batch["label"].shape
    assert torch.equal(batch["input"][:, 1:], batch["label"][:, :-1])
    assert int(batch["input"].max()) < 50
    again = ttrain.synthetic_text_batch(3, seq_len=16, vocab_size=50,
                                        seed=1, device="cpu")
    assert torch.equal(batch["input"], again["input"])
