"""Cross entropy of the port against the JAX package on the CPU: the dense
loss (``training.cross_entropy_loss``) and the streaming one
(``ops/loss.py``), values and gradients, with label smoothing and
out-of-range labels."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import training as jtrain
from horovod_tpu.ops import loss as jloss
from horovod_tpu_torch import training as ttrain
from horovod_tpu_torch.ops import loss as tloss

VOCAB = 256
_ENV = "HOROVOD_STREAMING_CE_MIN_ELEMENTS"


def _data(seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((2, 24, VOCAB))).astype(np.float32)
    labels = rng.integers(0, VOCAB, (2, 24)).astype(np.int64)
    labels[0, :3] = -1          # padding
    labels[1, 5] = VOCAB        # past the vocab
    if dtype == "bfloat16":
        logits = np.asarray(jnp.asarray(logits, jnp.bfloat16)
                            .astype(jnp.float32))
    return logits, labels


def _both(logits, labels, dtype, jfn, tfn):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(logits, jdt),
                                     jnp.asarray(labels, jnp.int32))
    x = torch.tensor(logits, dtype=tdt, requires_grad=True)
    tl = tfn(x, torch.from_numpy(labels))
    tl.backward()
    assert x.grad.dtype == tdt
    return (float(jl), np.asarray(jg.astype(jnp.float32)),
            float(tl.detach()), x.grad.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("streaming", [False, True])
def test_cross_entropy_loss_matches(monkeypatch, dtype, smoothing,
                                    streaming):
    # 0 forces the streaming path, a huge threshold the dense one.
    monkeypatch.setenv(_ENV, "0" if streaming else str(10 ** 12))
    logits, labels = _data(0, dtype)
    jl, jg, tl, tg = _both(
        logits, labels, dtype,
        lambda x, y: jtrain.cross_entropy_loss(x, y, smoothing),
        lambda x, y: ttrain.cross_entropy_loss(x, y, smoothing))
    # fp32 math on both sides over 48 rows of 256: sums in another order.
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # The gradient is written in the logits' dtype: fp32 to ~1e-7 (values
    # of order 1/48), bf16 to one ulp of those values (2^-8 relative).
    atol = {"float32": 1e-6, "bfloat16": 2e-4}[dtype]
    np.testing.assert_allclose(tg, jg, atol=atol)


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_streaming_chunks_match(smoothing):
    """Several vocab chunks (chunk_target 64 of 256) against the reference
    streaming loss with the same chunking."""
    logits, labels = _data(1)
    jl, jg, tl, tg = _both(
        logits, labels, "float32",
        lambda x, y: jloss.streaming_softmax_cross_entropy(
            x, y, smoothing, chunk_target=64),
        lambda x, y: tloss.streaming_softmax_cross_entropy(
            x, y, smoothing, chunk_target=64))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-6)


def test_pick_chunk_matches_reference():
    for vocab, target in [(50304, 8192), (256, 64), (97, 8), (32000, 8192),
                          (1000, 10)]:
        assert tloss._pick_chunk(vocab, target) == \
            jloss._pick_chunk(vocab, target)


def test_threshold_rule(monkeypatch):
    monkeypatch.setenv(_ENV, "123")
    assert ttrain._ce_threshold(torch.device("cpu")) == 123
    monkeypatch.delenv(_ENV)
    # No device memory to read on the CPU: the reference's 2^30 default.
    assert ttrain._ce_threshold(torch.device("cpu")) == 1 << 30
    monkeypatch.setenv(_ENV, "lots")
    with pytest.raises(ValueError, match="must be a plain int"):
        ttrain._ce_threshold(torch.device("cpu"))
