"""TransformerLM of the port against the flax model, on the CPU: logits
from the same weights (carried across by ``horovod_tpu_torch.convert``),
RoPE's split-halves rotation, the weight round trip and the initial
distributions."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import MeshSpec as JMeshSpec
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import build_mesh as tbuild_mesh

CPU = "cpu"
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _configs(dtype, attention):
    j = jtr.gpt_tiny(dtype=_JNP[dtype], attention=attention,
                     flash_interpret=attention == "flash", block_q=16,
                     block_k=16)
    t = ttr.gpt_tiny(dtype=_TORCH[dtype], attention=attention)
    return j, t


def _flax_params(cfg, seed=0):
    tokens = jnp.zeros((1, 8), jnp.int32)
    return jtr.TransformerLM(cfg).init(jax.random.key(seed), tokens)["params"]


def _torch_model(tcfg, flax_params):
    model = ttr.TransformerLM(tcfg, device=CPU)
    model.load_state_dict(convert.params_from_flax(flax_params, tcfg))
    return model


def _tokens(seed=0, b=2, t=32, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int64)


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_flax(attention, dtype):
    jcfg, tcfg = _configs(dtype, attention)
    params = _flax_params(jcfg)
    tokens = _tokens()
    jlogits = jtr.TransformerLM(jcfg).apply({"params": params},
                                            jnp.asarray(tokens, jnp.int32))
    model = _torch_model(tcfg, params)
    with torch.no_grad():
        tlogits = model(torch.from_numpy(tokens))
    assert tlogits.dtype == _TORCH[dtype]
    assert tuple(tlogits.shape) == tuple(jlogits.shape)
    a = tlogits.float().numpy()
    b = np.asarray(jlogits.astype(jnp.float32))
    if dtype == "float32":
        # The same arithmetic with sums in another order, through two
        # layers (~1e-6 relative).
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
        return
    # bf16: both sides round every projection and residual to bf16
    # (2^-8 relative, one ulp is 0.0078 at logits of order 1), at slightly
    # different points (XLA fuses elementwise chains in fp32).  Hold the
    # port to the same distance from the fp32 model as flax's bf16 model.
    jcfg32, _ = _configs("float32", attention)
    exact = np.asarray(jtr.TransformerLM(jcfg32).apply(
        {"params": params}, jnp.asarray(tokens, jnp.int32)))
    assert np.abs(a - exact).mean() <= 1.25 * np.abs(b - exact).mean()
    assert np.abs(a - b).mean() < 1.5e-2
    assert np.abs(a - b).max() < 0.1


def test_rope_is_split_halves():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 32), dtype=np.float32)
    positions = np.arange(16)
    ref = jtr.apply_rope(jnp.asarray(x), jnp.asarray(positions), 10000.0)
    out = ttr.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                         10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # Split halves: position 1 rotates (x[i], x[i + D/2]) by the angle of
    # frequency i, which leaves x[..., 0] * cos - x[..., 16] * sin in 0.
    cos, sin = np.cos(1.0), np.sin(1.0)
    np.testing.assert_allclose(
        out.numpy()[:, 1, :, 0],
        x[:, 1, :, 0] * cos - x[:, 1, :, 16] * sin, atol=1e-5)
    # Per-row positions [B, T] agree too.
    pos2 = rng.integers(0, 100, (2, 16))
    ref2 = jtr.apply_rope(jnp.asarray(x), jnp.asarray(pos2), 10000.0)
    out2 = ttr.apply_rope(torch.from_numpy(x), torch.from_numpy(pos2),
                          10000.0)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), atol=1e-4)


def test_convert_round_trip():
    jcfg, tcfg = _configs("float32", "dense")
    params = _flax_params(jcfg, seed=3)
    back = convert.params_to_flax(convert.params_from_flax(params, tcfg),
                                  tcfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_flax_leaf_order_is_tree_flatten_order():
    # 12 layers, so that layer_10 sorts before layer_2.
    jcfg = jtr.gpt_tiny(num_layers=12)
    tcfg = ttr.gpt_tiny(num_layers=12)
    params = jax.eval_shape(
        lambda: jtr.TransformerLM(jcfg).init(
            jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    names = convert.flax_leaf_order(tcfg)
    state = ttr.TransformerLM(tcfg, device=CPU).state_dict()
    assert sorted(names) == sorted(state)
    by_name = {name: path for name, path, *_ in convert._leaves(tcfg)}
    assert [by_name[n] for n in names] == paths
    # Shapes agree through the conversion.
    leaves = jax.tree_util.tree_leaves(params)
    for name, leaf in zip(names, leaves):
        assert int(np.prod(leaf.shape)) == state[name].numel(), name


def test_init_draws_flax_distributions():
    """Std of each kind of parameter against flax's defaults: Embed
    normal(1/sqrt(d_model)), Dense lecun_normal (truncated normal of
    std 1/sqrt(fan_in)), RMSNorm ones.  With thousands of draws the
    sample std is within a few percent."""
    tcfg = ttr.gpt_tiny(vocab_size=4096)
    jcfg = jtr.gpt_tiny(vocab_size=4096)
    state = ttr.TransformerLM(tcfg, device=CPU, seed=7).state_dict()
    ref = convert.params_from_flax(_flax_params(jcfg, seed=7), tcfg)
    for name, value in state.items():
        a, b = value.float(), ref[name]
        if name.endswith("scale"):
            assert torch.all(a == 1.0), name
            continue
        assert abs(a.mean().item()) < 0.1 * b.std().item(), name
        np.testing.assert_allclose(a.std().item(), b.std().item(),
                                   rtol=0.08, err_msg=name)
        # The truncation of lecun_normal: no draw beyond 2 stds (of the
        # untruncated normal); the embedding is not truncated.
        limit = np.abs(b.numpy()).max()
        if name != "embed.weight":
            assert a.abs().max().item() <= limit * 1.05, name


def test_seeded_init_is_reproducible():
    tcfg = ttr.gpt_tiny()
    a = ttr.TransformerLM(tcfg, device=CPU, seed=5).state_dict()
    b = ttr.TransformerLM(tcfg, device=CPU, seed=5).state_dict()
    c = ttr.TransformerLM(tcfg, device=CPU, seed=6).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed.weight"], c["embed.weight"])


@pytest.mark.parametrize("overrides", [
    dict(decode=True, moe_experts=4),
    dict(attention="ring"),
    dict(attention="ulysses"), dict(moe_experts=4)])
def test_unported_config_values_raise(overrides):
    """These configurations were refused until the port had sequence and
    expert parallelism; each now matches the flax model on the same
    weights, in fp32: the logits and the gradients of a square loss (1e-4
    of the largest logit, 1e-5 of the largest gradient), or with decode a
    prefill and two decode steps (logits within 1e-4).  Ring and Ulysses
    run on a mesh of one rank, where the ring is local attention and
    Ulysses' head shard dense attention on the CPU, on both sides."""
    extra_j, extra_t = {}, {}
    if overrides.get("attention") in ("ring", "ulysses"):
        extra_j = dict(mesh=jbuild_mesh(JMeshSpec(dp=1),
                                        devices=jax.devices()[:1]))
        extra_t = dict(mesh=tbuild_mesh(device=CPU))
    jcfg = jtr.gpt_tiny(dtype=jnp.float32, **overrides, **extra_j)
    tcfg = ttr.gpt_tiny(dtype=torch.float32, **overrides, **extra_t)
    params = _flax_params(jcfg)
    model = _torch_model(tcfg, params)
    tokens = _tokens(seed=4, t=16)
    if tcfg.decode:
        jmodel, variables = jtr.TransformerLM(jcfg), {"params": params}
        jprefill = jax.jit(lambda v, t: jtr.prefill(jmodel, v, t))
        jdecode = jax.jit(lambda v, c, t: jtr.decode_step(jmodel, v, c, t))
        jlogits, jcache = jprefill(variables, jnp.asarray(tokens, jnp.int32))
        tlogits, tcache = ttr.prefill(model, tokens)
        steps = _tokens(seed=5, t=2)
        for i in range(3):
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=1e-4, rtol=1e-4)
            if i == 2:
                break
            step = steps[:, i:i + 1]
            jlogits, jcache = jdecode(variables, jcache,
                                      jnp.asarray(step, jnp.int32))
            tlogits, tcache = ttr.decode_step(model, tcache, step)
        return
    jtokens = jnp.asarray(tokens, jnp.int32)
    jlogits = np.asarray(jax.jit(lambda p: jtr.TransformerLM(jcfg).apply(
        {"params": p}, jtokens))(params))
    tlogits = model(torch.from_numpy(tokens), train=True)
    scale = np.abs(jlogits).max()
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits,
                               atol=1e-4 * scale, rtol=0)
    tlogits.float().square().mean().backward()
    jgrads = convert.params_from_flax(jax.jit(
        lambda p: _square_loss_grads_flax(jcfg, p, jtokens))(params), tcfg)
    for name, p in model.named_parameters():
        ref = jgrads[name]
        torch.testing.assert_close(
            p.grad, ref, atol=1e-5 * ref.abs().max().item() + 1e-12,
            rtol=0, msg=name)


def test_remat_gives_the_same_gradients():
    tcfg = ttr.gpt_tiny(dtype=torch.float32, attention="flash")
    rcfg = ttr.gpt_tiny(dtype=torch.float32, attention="flash", remat=True)
    tokens = torch.from_numpy(_tokens(t=16))
    grads = []
    for cfg in (tcfg, rcfg):
        model = ttr.TransformerLM(cfg, device=CPU, seed=2)
        model(tokens, train=True).float().square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   atol=1e-6, rtol=1e-5, msg=name)


def _square_loss_grads_flax(jcfg, params, tokens):
    def loss(p):
        logits = jtr.TransformerLM(jcfg).apply({"params": p}, tokens,
                                               train=True)
        return jnp.mean(jnp.square(logits.astype(jnp.float32)))
    return jax.grad(loss)(params)


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_match_flax(policy, attention):
    """fp32 gpt_tiny with remat under each policy: the port's gradients
    against flax's nn.remat (checkpoint_dots for "dots"; the Pallas
    kernels interpreted).  The same arithmetic summed in another order
    through two layers and their backward: 1e-5 of the largest
    gradient."""
    jcfg = jtr.gpt_tiny(dtype=jnp.float32, attention=attention,
                        flash_interpret=attention == "flash", block_q=16,
                        block_k=16, remat=True, remat_policy=policy)
    tcfg = ttr.gpt_tiny(dtype=torch.float32, attention=attention,
                        remat=True, remat_policy=policy)
    params = _flax_params(jcfg)
    tokens = _tokens(seed=3, t=16)
    jgrads = convert.params_from_flax(
        _square_loss_grads_flax(jcfg, params, jnp.asarray(tokens,
                                                          jnp.int32)), tcfg)
    model = _torch_model(tcfg, params)
    model(torch.from_numpy(tokens), train=True).float().square().mean() \
        .backward()
    for name, p in model.named_parameters():
        ref = jgrads[name]
        scale = ref.abs().max().item()
        torch.testing.assert_close(p.grad, ref, atol=1e-5 * scale + 1e-12,
                                   rtol=0, msg=name)


# The ATen matmuls a dot_general of the block runs as, with or without
# batch dimensions.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default})


class _BackwardOps(TorchDispatchMode):
    """Counts the ATen ops that run while it is on, matmuls apart."""

    def __init__(self):
        super().__init__()
        self.ops = self.dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.dots += func in _DOT_OPS
        return func(*args, **(kwargs or {}))


def _backward_op_counts(tcfg, tokens):
    model = ttr.TransformerLM(tcfg, device=CPU, seed=2)
    loss = model(tokens, train=True).float().square().mean()
    with _BackwardOps() as mode:
        loss.backward()
    return mode.ops, mode.dots


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_dots_saves_matmul_outputs(attention):
    """"dots" keeps every block's products from the forward: its backward
    recomputes the rest of the block (more ops than without remat) but no
    product, so it runs as many matmuls as the backward without remat and
    fewer than "full", which recomputes them all.  The flash call is
    recomputed, as checkpoint_dots recomputes the Pallas call: on the CPU
    its plain version's two products (scores and values) run again in
    each layer.  (Non-reentrant checkpointing packs saved tensors under
    its own ``saved_tensors_hooks``, which shadow an outer hook, so the
    count is taken from the ops that run.)"""
    tokens = torch.from_numpy(_tokens(t=16))
    kw = dict(dtype=torch.float32, attention=attention)
    plain = _backward_op_counts(ttr.gpt_tiny(**kw), tokens)
    full = _backward_op_counts(ttr.gpt_tiny(remat=True, **kw), tokens)
    dcfg = ttr.gpt_tiny(remat=True, remat_policy="dots", **kw)
    dots = _backward_op_counts(dcfg, tokens)
    print(f"backward (ops, matmuls): none {plain}, full {full}, "
          f"dots {dots}")
    recomputed = 2 * dcfg.num_layers if attention == "flash" else 0
    assert plain[0] < dots[0] < full[0]
    assert dots[1] - recomputed == plain[1] < full[1]
