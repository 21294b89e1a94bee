"""Sequence, expert and pipeline parallelism of the port in one process,
against the JAX package on the CPU: the MoE routing helpers and the dense
MoE layer, local attention, the parallel functions at one rank, the
mesh's and the Trainer's refusals, the MoE leaves of ``convert``, and the
Trainer's two modes at one rank.  The worlds of 2 and 4 ranks are in
``tests/test_torch_parallel_worlds.py``.  Tolerances are the JAX tests'
own: attention 2e-5 (gradients 5e-5), MoE 1e-4/1e-5 (gradients
1e-3/1e-4), pipeline 1e-5/1e-6."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.models import moe as jmoe
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel.ring_attention import \
    local_attention as jlocal_attention
from horovod_tpu_torch import GradSyncConfig, Trainer, convert
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.ops.flash_attention import mha_reference
from horovod_tpu_torch.parallel import (allgather, alltoall, broadcast,
                                        build_mesh, local_attention,
                                        pipeline_apply, ppermute,
                                        ring_attention, ulysses_attention)
from horovod_tpu_torch.parallel.mesh import Mesh

CPU = "cpu"


def _f32(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("n,e,factor", [(8, 2, 0.5), (64, 4, 1.25),
                                        (7, 3, 2.0), (3, 8, 0.1)])
def test_capacity_matches_jax(n, e, factor):
    assert tmoe._capacity(n, e, factor) == jmoe._capacity(n, e, factor)


@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_dispatch_combine_matches_jax(capacity):
    logits = _f32(0, 24, 4, scale=2.0)
    jd, jc = jmoe._dispatch_combine(jnp.asarray(logits), capacity)
    td, tc = tmoe._dispatch_combine(torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)


def test_capacity_drops_tokens():
    """Switch semantics: past an expert's capacity a token is dropped."""
    logits = np.full((8, 2), -10.0, np.float32)
    logits[:, 0] = 10.0
    cap = tmoe._capacity(8, 2, 0.5)
    dispatch, _ = tmoe._dispatch_combine(torch.from_numpy(logits), cap)
    kept = dispatch.sum(dim=(1, 2))
    assert kept.sum().item() == cap
    assert kept[:cap].tolist() == [1.0] * cap
    assert kept[cap:].tolist() == [0.0] * (8 - cap)


def _dense_pair(e, factor, dtype=torch.float32):
    x = _f32(3, 4, 6, 8)
    jlayer = jmoe.MoEMLP(num_experts=e, d_ff=16, capacity_factor=factor,
                         dtype=jnp.float32 if dtype == torch.float32
                         else jnp.bfloat16)
    variables = jlayer.init(jax.random.key(1), jnp.asarray(x))
    p = variables["params"]
    tlayer = tmoe.MoEMLP(8, num_experts=e, d_ff=16, capacity_factor=factor,
                         dtype=dtype, device=torch.device(CPU))
    tlayer.load_state_dict({
        "router.weight": torch.from_numpy(np.asarray(p["router"]["kernel"]).T
                                          .copy()),
        "wi": torch.from_numpy(np.array(p["wi"])),
        "wo": torch.from_numpy(np.array(p["wo"]))})
    return x, jlayer, variables, tlayer


@pytest.mark.parametrize("factor", [4.0, 0.5])
def test_dense_moe_matches_jax(factor):
    """The dense MoE layer (ep = 1), forward and gradients, with nothing
    dropped and with binding capacities."""
    x, jlayer, variables, tlayer = _dense_pair(4, factor)
    jout = jlayer.apply(variables, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tlayer(xt)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    gv, gx = jax.grad(lambda v, xx: jnp.sum(jlayer.apply(v, xx) ** 2),
                      argnums=(0, 1))(variables, jnp.asarray(x))
    tout.square().sum().backward()
    g = gv["params"]
    for got, want in ((xt.grad, gx), (tlayer.router.weight.grad.T,
                                      g["router"]["kernel"]),
                      (tlayer.wi.grad, g["wi"]), (tlayer.wo.grad, g["wo"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-4)


def test_dense_moe_casts_to_dtype():
    x, jlayer, variables, tlayer = _dense_pair(4, 1.25, torch.bfloat16)
    jout = np.asarray(jlayer.apply(variables, jnp.asarray(x))
                      .astype(jnp.float32))
    with torch.no_grad():
        tout = tlayer(torch.from_numpy(x))
    assert tout.dtype == torch.bfloat16
    # fp32 math on both sides, one bf16 rounding of the output.
    np.testing.assert_allclose(tout.float().numpy(), jout, rtol=2 ** -8,
                               atol=1e-6)


def test_moe_init_draws_lecun_normal_over_experts():
    """flax's lecun_normal on [E, D, F] takes its fan-in over E·D."""
    layer = tmoe.MoEMLP(32, num_experts=8, d_ff=64,
                        device=torch.device(CPU))
    layer.reset_parameters(torch.Generator().manual_seed(0))
    p = jmoe.MoEMLP(num_experts=8, d_ff=64).init(
        jax.random.key(0), jnp.zeros((1, 2, 32)))["params"]
    for name in ("wi", "wo"):
        ref = np.asarray(p[name])
        got = getattr(layer, name).detach().numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.std(), ref.std(), rtol=0.05)
        assert np.abs(got).max() <= 2 * got.std() / 0.8796 * 1.01


@pytest.mark.parametrize("causal", [False, True])
def test_local_attention_matches_jax(causal):
    q, k, v = (_f32(s, 2, 16, 4, 8) for s in (5, 6, 7))
    jout = jlocal_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tout = local_attention(*qkv, causal=causal)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    jgrads = jax.grad(lambda *a: (jlocal_attention(*a, causal=causal) ** 2)
                      .sum(), argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))
    tout.square().sum().backward()
    for t, j in zip(qkv, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=5e-5,
                                   rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_at_one_rank_is_local(causal):
    q, k, v = (torch.from_numpy(_f32(s, 2, 16, 4, 8)) for s in (8, 9, 10))
    want = local_attention(q, k, v, causal=causal)
    assert torch.equal(ring_attention(q, k, v, causal=causal), want)
    assert torch.equal(ulysses_attention(q, k, v, causal=causal), want)
    dense = ulysses_attention(q, k, v, causal=causal, attn_fn=mha_reference)
    torch.testing.assert_close(dense, want, atol=2e-5, rtol=0)


def test_ulysses_rejects_indivisible_heads():
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention(q, q, q, axis_size=3)


def test_pipeline_at_one_stage_is_the_stage():
    x = torch.from_numpy(_f32(11, 8, 6))
    w = torch.from_numpy(_f32(12, 6, 6, scale=0.3))
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p), w, x,
                         num_microbatches=4)
    torch.testing.assert_close(out, torch.tanh(x @ w), rtol=1e-5, atol=1e-6)


def test_collectives_are_the_identity_without_a_world():
    assert not dist.is_initialized()
    x = torch.arange(12.0).reshape(3, 4)
    for y in (alltoall(x, None, 1, 0), broadcast(x), ppermute(x, None,
                                                             [(0, 0)]),
              allgather(x)):
        assert y is x


def test_mesh_of_one_has_every_axis():
    mesh = build_mesh(device=CPU)
    assert mesh.coords == {a: 0 for a in mesh.shape}
    assert mesh.groups == {}
    assert mesh.axis_index("sp") == 0
    with pytest.raises(ValueError, match="one rank"):
        mesh.axis_group("sp")


@pytest.fixture
def fake_world(monkeypatch):
    """torch.distributed looking initialised with 2 ranks (no group is
    formed before the refusals)."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)


def test_tensor_parallel_mesh_names_item_10b(fake_world):
    """tp > 1 builds like any other axis: with one axis
    larger than one it spans the whole group, and rank 1 sits at tp
    coordinate 1."""
    mesh = build_mesh(tp=2, device=CPU)
    assert mesh.shape["tp"] == 2 and mesh.shape["dp"] == 1
    assert mesh.coords["tp"] == 1 and mesh.axis_index("tp") == 1
    assert mesh.groups == {"tp": None} and mesh.axis_group("tp") is None


def test_mesh_of_one_axis_uses_the_group(fake_world):
    mesh = build_mesh(sp=2, device=CPU)
    assert mesh.shape["sp"] == 2 and mesh.shape["dp"] == 1
    assert mesh.coords["sp"] == 1 and mesh.groups == {"sp": None}


def _tiny_model(**kw):
    return ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32, **kw),
                             device=CPU)


def test_trainer_refusals():
    model = _tiny_model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="optimizer_in_ring"):
        Trainer(model, opt, build_mesh(device=CPU),
                sync=GradSyncConfig(axes=(), optimizer_in_ring=True))
    # A pure-GSPMD batch_spec over a non-batch dim builds (on this mesh
    # of one rank nothing is gathered).
    trainer = Trainer(model, opt, build_mesh(device=CPU),
                      sync=GradSyncConfig(axes=()), batch_spec=("dp", "sp"))
    assert trainer.batch_spec == ("dp", "sp")
    assert trainer._gather_dims == [] and trainer._seq_axes == ()
    # Over dp=2 x sp=2 (a mesh made by hand: planning uses no group) the
    # dense model gets the sequence gathered, the Ulysses one over that
    # sp axis takes its chunk.
    shape = {"pp": 1, "dp": 2, "fsdp": 1, "ep": 1, "sp": 2, "tp": 1}
    mesh = Mesh(shape=shape, group=None, device=torch.device(CPU),
                groups={"dp": None, "sp": None},
                coords=dict.fromkeys(shape, 0))
    for attention, gathered, bound in (("dense", [(1, ("sp",))], ()),
                                       ("ulysses", [], ("sp",))):
        m = _tiny_model(attention=attention, mesh=mesh)
        trainer = Trainer(m, torch.optim.SGD(m.parameters(), lr=0.1), mesh,
                          sync=GradSyncConfig(axes=()),
                          batch_spec=("dp", "sp"))
        assert (trainer._gather_dims, trainer._seq_axes) == (gathered, bound)
    # MoE over ep > 1 in the manual step (a mesh made by hand: the
    # refusal comes before any group is used).
    shape = {"pp": 1, "dp": 1, "fsdp": 1, "ep": 2, "sp": 1, "tp": 1}
    mesh = Mesh(shape=shape, group=None, device=torch.device(CPU),
                groups={"ep": None}, coords=dict.fromkeys(shape, 0))
    moe = _tiny_model(moe_experts=4, mesh=mesh)
    with pytest.raises(ValueError, match="pure-GSPMD"):
        Trainer(moe, torch.optim.SGD(moe.parameters(), lr=0.1), mesh,
                sync=GradSyncConfig(axes=("ep",)))


def test_sequence_parallel_needs_a_mesh():
    for attention in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="needs cfg.mesh"):
            _tiny_model(attention=attention)
        with pytest.raises(ValueError, match="incompatible"):
            _tiny_model(attention=attention, decode=True,
                        mesh=build_mesh(device=CPU))


def test_moe_leaves_round_trip_in_flax_order():
    jcfg = jtr.gpt_tiny(moe_experts=4)
    tcfg = ttr.gpt_tiny(moe_experts=4)
    params = jtr.TransformerLM(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    order = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    names = convert.flax_leaf_order(tcfg)
    assert len(order) == len(names)
    assert [n for n in names if ".moe." in n][:3] == [
        "layers.0.moe.router.weight", "layers.0.moe.wi", "layers.0.moe.wo"]
    model = ttr.TransformerLM(tcfg, device=CPU)
    state = convert.params_from_flax(params, tcfg)
    model.load_state_dict(state)
    assert model.layers[0].moe.router.weight.shape == (4, 64)
    back = convert.params_to_flax(model.state_dict(), tcfg)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(params),
                                 jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, np.asarray(want),
                                      jax.tree_util.keystr(path))
    layouts = convert.flax_layouts(model)
    for name, p in model.named_parameters():
        to_flax, from_flax = layouts[name]
        assert torch.equal(from_flax(to_flax(p)), p)


def test_gspmd_and_manual_steps_agree_at_one_rank():
    """At one rank the pure-GSPMD step (the global view) and the manual
    step are the same computation: equal losses and parameters."""
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 17)))
    batch = {"input": tokens[:, :-1], "label": tokens[:, 1:]}
    results = []
    for axes in (("dp",), ()):
        model = _tiny_model(moe_experts=4, moe_capacity_factor=0.5,
                            mesh=build_mesh(device=CPU))
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                weight_decay=1e-4)
        trainer = Trainer(model, opt, build_mesh(device=CPU),
                          sync=GradSyncConfig(axes=axes, op="average"))
        state = trainer.init()
        losses = [trainer.step(state, batch)[1]["loss"].item()
                  for _ in range(2)]
        results.append((losses, model.state_dict()))
    assert results[0][0] == results[1][0]
    for name, p in results[0][1].items():
        assert torch.equal(p, results[1][1][name]), name


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recompute_sees_the_global_view(policy):
    """A checkpointed block's recompute runs in the forward's global view,
    also when the backward runs on another thread, as autograd runs a
    CUDA backward on a device thread of its own."""
    import threading

    from horovod_tpu_torch.parallel.mesh import (current_global_batch,
                                                 global_batch)
    mesh = build_mesh(device=CPU)
    cfg = ttr.gpt_tiny(dtype=torch.float32, remat=True, remat_policy=policy,
                       moe_experts=2, attention="ulysses", mesh=mesh)
    model = ttr.TransformerLM(cfg, device=CPU, seed=0)
    seen = []
    for block in model.layers:
        block.register_forward_pre_hook(
            lambda m, a: seen.append(current_global_batch()))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    with global_batch(mesh, ("dp",)):
        loss = model(tokens, train=True).square().mean()
    assert seen == [(mesh, ("dp",))] * cfg.num_layers
    errors = []

    def backward():
        try:
            loss.backward()
        except BaseException as exc:          # re-raised below
            errors.append(exc)
    thread = threading.Thread(target=backward)
    thread.start()
    thread.join()
    assert not errors, errors
    assert seen == [(mesh, ("dp",))] * (2 * cfg.num_layers)
    assert current_global_batch() is None
