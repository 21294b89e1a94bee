"""Flash attention of the port (horovod_tpu_torch.ops.flash_attention) on
the CPU against the JAX package: the Pallas kernels run with
``interpret=True`` and ``mha_reference``.

On the CPU each kernel wrapper runs its plain PyTorch version, so these
tests hold the plain versions (the arithmetic each CUDA kernel repeats,
rounding points included) and the autograd wiring against the reference.
The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

# The package re-exports the function under the module's name.
jfa = importlib.import_module("horovod_tpu.ops.flash_attention")

B, H, D = 2, 4, 32
CPU = "cpu"

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# fp32: both sides compute in fp32 with sums in another order (~1e-6);
# bf16: outputs are rounded to bf16 (8 bits of mantissa, 2^-8 relative),
# and a rounding at a different point moves a value by one ulp.
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, tq, tk, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, t, H, D), dtype=np.float32)
            for t in (tq, tk, tk)]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16).astype(np.float32)
                for a in arrs]
    return arrs


def _to_jax(a, dtype):
    return jnp.asarray(a, _JNP[dtype])


def _to_torch(a, dtype, grad=False):
    return torch.tensor(a, dtype=_TORCH[dtype]).requires_grad_(grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


CASES = [(False, 64, 64), (True, 64, 64), (False, 32, 64), (True, 32, 64)]


@pytest.mark.parametrize("causal,tq,tk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_lse_match_pallas(causal, tq, tk, dtype):
    q, k, v = _inputs(0, tq, tk, dtype)
    jo, jlse = jfa.flash_attention_with_lse(
        *(_to_jax(a, dtype) for a in (q, k, v)), causal=causal,
        block_q=16, block_k=16, interpret=True)
    to, tlse = tfa.flash_attention_with_lse(
        *(_to_torch(a, dtype) for a in (q, k, v)), causal=causal,
        device=CPU)
    assert tuple(to.shape) == (B, tq, H, D) and to.dtype == _TORCH[dtype]
    assert tuple(tlse.shape) == (B, H, tq) and tlse.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), atol=ATOL[dtype])
    # lse is fp32 on both sides: only the order of the sums differs.
    np.testing.assert_allclose(_np(tlse), _np(jlse), atol=2e-5)
    ref = jfa.mha_reference(*(_to_jax(a, dtype) for a in (q, k, v)),
                            causal=causal)
    np.testing.assert_allclose(_np(to), _np(ref), atol=ATOL[dtype])


@pytest.mark.parametrize("causal,tq,tk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_pallas(causal, tq, tk, dtype):
    q, k, v = _inputs(1, tq, tk, dtype)
    w = np.random.default_rng(2).standard_normal((B, tq, H, D),
                                                 dtype=np.float32)

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal=causal, block_q=16,
                                block_k=16, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(_to_jax(a, dtype) for a in (q, k, v)))
    tq_, tk_, tv_ = (_to_torch(a, dtype, grad=True) for a in (q, k, v))
    out = tfa.flash_attention(tq_, tk_, tv_, causal=causal, device=CPU)
    (out.float() * torch.from_numpy(w)).sum().backward()
    # bf16 gradients pass through three bf16 roundings (p, ds and the
    # output), each within one ulp of values of order 10.
    tol = {"float32": 5e-5, "bfloat16": 1e-1}[dtype]
    for name, a, b in zip("qkv", (tq_.grad, tk_.grad, tv_.grad), jg):
        assert a.dtype == _TORCH[dtype], name
        np.testing.assert_allclose(_np(a), _np(b), atol=tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,tq,tk", [(True, 64, 64), (False, 32, 64)])
def test_plain_kernels_match_pallas_kernels(causal, tq, tk):
    """The three plain versions against the three Pallas kernels, at the
    [BH, T, D] layout of the kernels, in bf16 (their rounding points)."""
    rng = np.random.default_rng(3)
    bh, scale = 4, D ** -0.5
    arrs = [rng.standard_normal((bh, t, D), dtype=np.float32)
            .astype(ml_dtypes.bfloat16) for t in (tq, tk, tk, tq)]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    tq_t, tk_t, tv_t, tdo = (torch.tensor(a.astype(np.float32),
                                          dtype=torch.bfloat16)
                             for a in arrs)
    jo, jlse = jfa._flash_fwd_pallas(jq, jk, jv, sm_scale=scale,
                                     causal=causal, block_q=16, block_k=16,
                                     interpret=True)
    to, tlse = tfa.flash_fwd(tq_t, tk_t, tv_t, scale, causal)
    np.testing.assert_allclose(_np(to), _np(jo), atol=ATOL["bfloat16"])
    np.testing.assert_allclose(_np(tlse), _np(jlse[:, :, 0]), atol=2e-5)

    jdq, jdk, jdv = jfa._flash_bwd_pallas(
        jq, jk, jv, jo, jlse[:, :, 0], jdo, sm_scale=scale, causal=causal,
        block_q=16, block_k=16, interpret=True)
    # The same o on both sides, so that delta agrees exactly.
    to = torch.tensor(np.asarray(jo.astype(jnp.float32)),
                      dtype=torch.bfloat16)
    delta = (tdo.float() * to.float()).sum(-1)
    tdq = tfa.flash_bwd_dq(tq_t, tk_t, tv_t, tdo, tlse, delta, scale, causal)
    tdk, tdv = tfa.flash_bwd_dkv(tq_t, tk_t, tv_t, tdo, tlse, delta, scale,
                                 causal)
    for name, a, b in (("dq", tdq, jdq), ("dk", tdk, jdk), ("dv", tdv, jdv)):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL["bfloat16"],
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_error_accepts_pallas_rounding_and_catches_wrong_rows(causal):
    """``kernel_error`` is the check that holds each CUDA kernel against
    its plain version on the card.  The Pallas kernels round where the
    CUDA kernels do (p and ds to bf16, at a running max over 64-key
    tiles), so their outputs must pass it; outputs 5 % off on the late
    rows, where values average many keys and are small, must not."""
    rng = np.random.default_rng(4)
    bh, t, d = 2, 256, 64
    scale = d ** -0.5
    arrs = [rng.standard_normal((bh, t, d), dtype=np.float32)
            .astype(ml_dtypes.bfloat16) for _ in range(4)]
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    tq_, tk_, tv_, tdo = (torch.tensor(a.astype(np.float32),
                                       dtype=torch.bfloat16) for a in arrs)
    jo, jlse = jfa._flash_fwd_pallas(jq, jk, jv, sm_scale=scale,
                                     causal=causal, block_q=64, block_k=64,
                                     interpret=True)
    jgrads = jfa._flash_bwd_pallas(
        jq, jk, jv, jo, jlse[:, :, 0], jdo, sm_scale=scale, causal=causal,
        block_q=64, block_k=64, interpret=True)
    o = torch.tensor(np.asarray(jo.astype(jnp.float32)), dtype=torch.bfloat16)
    o_ref, lse = tfa.flash_fwd_plain(tq_, tk_, tv_, scale, causal)
    delta = (tdo.float() * o.float()).sum(-1)
    dq_ref = tfa.flash_bwd_dq_plain(tq_, tk_, tv_, tdo, lse, delta, scale,
                                    causal)
    dk_ref, dv_ref = tfa.flash_bwd_dkv_plain(tq_, tk_, tv_, tdo, lse, delta,
                                             scale, causal)
    grads = [torch.tensor(np.asarray(g.astype(jnp.float32)),
                          dtype=torch.bfloat16) for g in jgrads]
    for name, out, ref in zip(("o", "dq", "dk", "dv"), [o, *grads],
                              (o_ref, dq_ref, dk_ref, dv_ref)):
        report = tfa.kernel_error(out, ref)
        assert report["ok"], (name, report)
        wrong = out.clone()
        wrong[:, t // 2:] = (wrong[:, t // 2:].float() * 1.05).bfloat16()
        report = tfa.kernel_error(wrong, ref)
        assert not report["ok"] and report["worst"] > 2, (name, report)


def test_causal_tq_greater_than_tk_raises():
    q, k, v = (torch.zeros(1, t, 2, 16) for t in (8, 4, 4))
    with pytest.raises(ValueError, match="tq <= tk"):
        tfa.flash_attention(q, k, v, causal=True, device=CPU)
    with pytest.raises(ValueError, match="tq <= tk"):
        tfa.flash_attention_with_lse(q, k, v, causal=True, device=CPU)


def test_mixed_dtypes_raise():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="share one dtype"):
        tfa.flash_attention(q, k, k, device=CPU)
    with pytest.raises(ValueError, match="share one dtype"):
        tfa.flash_attention_with_lse(q, k, k, device=CPU)


def test_mha_reference_matches_jax():
    q, k, v = _inputs(5, 32, 64)
    for causal in (False, True):
        ref = jfa.mha_reference(*(_to_jax(a, "float32") for a in (q, k, v)),
                                causal=causal)
        out = tfa.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal)
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5)


def test_fit_block_matches_reference():
    for t, block in [(64, 128), (100, 16), (97, 32), (2048, 1024)]:
        assert tfa._fit_block(t, block) == jfa._fit_block(t, block)
