"""Gradient sync of the port against the JAX package on the CPU.

- ``_bucketize`` gives the reference's buckets on gpt_tiny's gradients in
  the flax leaf order;
- ``sync_gradients`` in a 2-process gloo world matches the reference's
  ``sync_gradients`` on a 2-device CPU mesh, on the same per-rank
  gradients, for the none/fp16 wires x sum/average and with fused loss
  scaling and clipping;
- the bf16 wire, which XLA on the CPU cannot all-reduce, is checked
  against a bf16 round trip of the mean;
- the reference's refusals (adasum with a quantized codec or with loss
  scaling, the ring with error feedback or adasum, uint4 with an odd
  block) raise its ValueErrors.  The other knobs are tested in
  ``tests/test_torch_sync_knobs.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.common.jax_compat import shard_map
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import grad_sync as jsync
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import grad_sync as tsync
from torch_sync_util import run_gloo_world

WORLD = 2

# Gradients of a few shapes; a threshold of 2000 bytes puts them in
# several buckets of 1 to 3 leaves, with fp32 and 2-byte wires alike.
SHAPES = {"a": (7, 9), "b": (300,), "c": (4, 5, 6), "d": (64,),
          "e": (500,), "f": (3,)}
THRESHOLD = 2000
CONFIGS = [
    dict(op="sum", compression=None),
    dict(op="average", compression=None),
    dict(op="sum", compression="fp16"),
    dict(op="average", compression="fp16"),
    dict(op="average", compression=None, loss_scale=256.0,
         clip_global_norm=0.75),
    dict(op="average", compression="fp16", loss_scale=8.0,
         clip_global_norm=1e3),
    dict(op="sum", compression=None, clip_global_norm=0.5),
]


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return [{n: (2 * rng.standard_normal(s)).astype(np.float32)
             for n, s in SHAPES.items()} for _ in range(WORLD)]


def _jax_sync(per_rank, kwargs):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    cfg = jsync.GradSyncConfig(axes=("dp",),
                               fusion_threshold_bytes=THRESHOLD, **kwargs)
    stacked = {n: jnp.stack([jnp.asarray(g[n]) for g in per_rank])
               for n in SHAPES}
    out = jax.jit(shard_map(
        lambda g: jsync.sync_gradients(g, cfg), mesh=mesh,
        in_specs=P("dp"), out_specs=P("dp"), check_vma=False))(stacked)
    return [{n: np.asarray(v)[r] for n, v in out.items()}
            for r in range(WORLD)]


def _gloo_sync(tmp_path, per_rank, configs):
    """Run the port's sync_gradients in a WORLD-process gloo world."""
    jobs = [dict(kind="sync", set="g", config=kw) for kw in configs]
    return run_gloo_world(tmp_path, WORLD, {"g": {"names": list(SHAPES),
                                                  "ranks": per_rank}}, jobs)


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    per_rank = _grads()
    configs = [dict(kw, fusion_threshold_bytes=THRESHOLD) for kw in CONFIGS]
    configs.append(dict(op="average", compression="bf16",
                        fusion_threshold_bytes=THRESHOLD))
    return per_rank, _gloo_sync(tmp_path_factory.mktemp("gloo"), per_rank,
                                configs)


@pytest.mark.parametrize("c", range(len(CONFIGS)),
                         ids=[f"{kw['op']}-{kw['compression']}"
                              + ("-scale-clip" if "clip_global_norm" in kw
                                 else "") for kw in CONFIGS])
def test_gloo_sync_matches_jax(gloo_results, c):
    per_rank, results = gloo_results
    expect = _jax_sync(per_rank, CONFIGS[c])
    # fp32 wire: sums of two fp32 values (exact order) and one multiply;
    # fp16 wire: both sides round to fp16 at the same points, the sum
    # itself in fp16, so one fp16 ulp (2^-10 relative) separates them at
    # most where a sum lands on a rounding boundary.
    tol = 1e-3 if CONFIGS[c]["compression"] == "fp16" else 1e-6
    for r in range(WORLD):
        for n in SHAPES:
            np.testing.assert_allclose(results[r][f"{c}/{n}"], expect[r][n],
                                       rtol=tol, atol=tol,
                                       err_msg=f"rank {r} {n}")


def test_gloo_bf16_wire_is_rounded_mean(gloo_results):
    per_rank, results = gloo_results
    c = len(CONFIGS)
    bf16 = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    for n in SHAPES:
        # Each rank rounds to bf16, the wire adds and halves in bf16.
        expect = ((bf16(per_rank[0][n]) + bf16(per_rank[1][n])) / 2).float()
        for r in range(WORLD):
            np.testing.assert_array_equal(results[r][f"{c}/{n}"],
                                          expect.numpy(), err_msg=n)


def test_bucketize_matches_reference_on_gpt_tiny():
    jcfg, tcfg = jtr.gpt_tiny(), ttr.gpt_tiny()
    params = jax.eval_shape(lambda: jtr.TransformerLM(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]
    jleaves = jax.tree_util.tree_leaves(params)
    state = ttr.TransformerLM(tcfg, device="cpu").state_dict()
    tleaves = [state[n] for n in convert.flax_leaf_order(tcfg)]
    # gpt_tiny has 33k to 65k bytes per 2-byte leaf; these thresholds
    # give buckets of one to many leaves.
    for threshold in (20_000, 70_000, 150_000, 1 << 26):
        for itemsize in (None, 2):
            assert tsync._bucketize(tleaves, threshold, itemsize) == \
                jsync._bucketize(jleaves, threshold, itemsize), \
                (threshold, itemsize)


def test_world_one_rounds_through_the_wire():
    g = {"w": torch.tensor([1.0 + 2 ** -12, 3.0, -0.1])}
    out = tsync.sync_gradients(g, tsync.GradSyncConfig(compression="bf16"))
    torch.testing.assert_close(out["w"], g["w"].bfloat16().float(),
                               atol=0, rtol=0)
    same = tsync.sync_gradients(g, tsync.GradSyncConfig())
    torch.testing.assert_close(same["w"], g["w"], atol=0, rtol=0)


def test_world_one_scale_clip_matches_jax():
    per_rank = _grads(seed=4)[:1]
    kw = dict(op="average", compression=None, loss_scale=4.0,
              clip_global_norm=0.5)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    cfg = jsync.GradSyncConfig(axes=("dp",), **kw)
    expect = jax.jit(shard_map(
        lambda g: jsync.sync_gradients(g, cfg), mesh=mesh, in_specs=P(),
        out_specs=P(), check_vma=False))(
            {n: jnp.asarray(v) for n, v in per_rank[0].items()})
    out = tsync.sync_gradients(
        {n: torch.from_numpy(v) for n, v in per_rank[0].items()},
        tsync.GradSyncConfig(**kw))
    for n in SHAPES:
        np.testing.assert_allclose(out[n].numpy(), np.asarray(expect[n]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kwargs,match", [
    (dict(op="adasum", compression="int8"), "quantized"),
    (dict(op="adasum", compression="uint4"), "quantized"),
    (dict(op="adasum", loss_scale=128.0), "loss-scaling"),
    (dict(op="adasum", clip_global_norm=1.0), "loss-scaling"),
    (dict(optimizer_in_ring=True, error_feedback=True), "error-feedback"),
    (dict(optimizer_in_ring=True, op="adasum"), "sum|average"),
    (dict(compression="uint4", compression_block_size=15), "even block"),
])
def test_reference_refusals_remain(kwargs, match):
    """The reference's own ValueErrors are the only refusals left."""
    with pytest.raises(ValueError, match=match):
        tsync.sync_gradients([torch.zeros(3)], tsync.GradSyncConfig(**kwargs))
