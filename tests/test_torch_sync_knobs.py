"""The rest of the port's gradient sync against the JAX package on the CPU:
the int8/uint4 codecs and error feedback, adasum, max/min, the
hierarchical split and optimizer-in-ring.

- The codec: ``compress.ops.quantize_rows``/``dequantize_rows`` against
  ``horovod_tpu/compress/jax_ops.py`` called op by op: payload, scales,
  zero points and the dequantized rows bitwise equal.  (Under ``jit``
  XLA's CPU code differs: 1 ulp in some scales, and a fused multiply-add
  in the dequantize.  The sync tests below run the reference under
  ``jit`` and hold the port to the quantized tolerance.)
- A 2-rank gloo world (``tests/torch_sync_worker.py``) against a 2-device
  CPU mesh on the same per-rank gradients: int8 and uint4, sum and
  average, with and without loss scaling and clipping, several block
  sizes; ``sync_gradients_ef`` over two steps; adasum with no wire and an
  fp16 wire; max and min; gpt_tiny's and a small ResNet's gradients
  packed through ``convert.flax_layouts`` and compared on the flax tree;
  ``sync_and_apply`` with SGD(0.1, 0.9) and AdamW on no wire, the fp16
  wire and the int8 gradient leg, and against the port's own
  sync-then-update.
- A 4-rank gloo world against a 4-device mesh: adasum over two levels,
  an int8 four-row sum, and on ``MeshSpec(dp=2, fsdp=2)``
  (``mesh.axis_groups``) the hierarchical split (against the reference's
  hierarchical and flat results) and an int8 sum over both axes; adasum
  over 3 ranks raises.

Tolerances: fp32 round-off (rtol 1e-6, atol 1e-7) for adasum, the
hierarchical split, max/min and the unquantized ring.  Quantized outputs
and residuals within one quantization level of their block everywhere and
within round-off (8 ulps of the block's magnitude) on at least 99.9 % of
elements.  A ring with AdamW on the int8 leg: every parameter within two
steps' size (2 lr) and within round-off on 99.9 %: Adam's first step is
lr * sign(g), which a level's difference can flip where g is near 0.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.compress import CompressionCodec as JCodec
from horovod_tpu.compress import jax_ops
from horovod_tpu.models import resnet as jres
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import collectives as jcoll
from horovod_tpu.common.jax_compat import shard_map
from horovod_tpu_torch import convert
from horovod_tpu_torch.compress import CompressionCodec as TCodec
from horovod_tpu_torch.compress import ops as tops
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import grad_sync as tsync
from torch_sync_util import (ROUNDOFF, assert_quantized_close, block_levels, jax_mesh,
                             jax_ring, jax_sync, jax_sync_ef,
                             quantization_profile, random_tree, run_gloo_world,
                             stack, unstack)

SHAPES = {"a": (7, 9), "b": (300,), "c": (4, 5, 6), "d": (64,),
          "e": (500,), "f": (3,)}
THRESHOLD = 1000            # wire bytes: buckets of 1 to 3 leaves at int8
GPT_THRESHOLD = 60_000      # gpt_tiny's 164k gradients in 4 buckets
LEVELS = {"int8": 256, "uint4": 16}
RESNET = dict(stage_sizes=[1, 1], num_filters=8, num_classes=10)
SGD = ({"cls": "SGD", "kw": {"lr": 0.1, "momentum": 0.9}},
       optax.sgd(0.1, momentum=0.9))
ADAMW = ({"cls": "AdamW", "kw": {"lr": 1e-3, "weight_decay": 1e-4}},
         optax.adamw(1e-3, weight_decay=1e-4))

QCONFIGS = [
    dict(op="sum", compression="int8"),
    dict(op="average", compression="int8"),
    dict(op="sum", compression="uint4"),
    dict(op="average", compression="uint4"),
    dict(op="average", compression="int8", loss_scale=256.0,
         clip_global_norm=0.75),
    dict(op="sum", compression="uint4", loss_scale=8.0,
         clip_global_norm=1e3),
    dict(op="average", compression="int8", compression_block_size=16),
    dict(op="average", compression="uint4", compression_block_size=2),
]
RING = [  # (optimizer, compression, loss_scale / clip)
    (SGD, None, {}), (SGD, "fp16", {}), (SGD, "int8", {}),
    (ADAMW, None, {}), (ADAMW, "fp16", {}), (ADAMW, "int8", {}),
    (SGD, None, dict(loss_scale=4.0, clip_global_norm=0.5)),
]


def _small(seed, world=2):
    rng = np.random.default_rng(seed)
    return [{n: (2 * rng.standard_normal(s)).astype(np.float32)
             for n, s in SHAPES.items()} for _ in range(world)]


def _small_set(seed, world=2, params_seed=None):
    out = {"names": list(SHAPES), "ranks": _small(seed, world)}
    if params_seed is not None:
        out["params"] = _small(params_seed, 1)[0]
    return out


# --- the models' gradients, as flax trees and as the port's state dicts -----
def _gpt_shapes():
    return jax.eval_shape(lambda: jtr.TransformerLM(jtr.gpt_tiny()).init(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))["params"]


def _gpt_to_port(tree):
    return {n: v.numpy() for n, v in
            convert.params_from_flax(tree, ttr.gpt_tiny()).items()}


def _gpt_to_flax(arrays):
    return convert.params_to_flax(
        {n: torch.from_numpy(v) for n, v in arrays.items()}, ttr.gpt_tiny())


def _resnet_port():
    return tres.ResNet(RESNET["stage_sizes"], tres.BottleneckBlock,
                       num_filters=RESNET["num_filters"],
                       num_classes=RESNET["num_classes"], device="cpu")


def _resnet_shapes():
    model = jres.ResNet(stage_sizes=RESNET["stage_sizes"],
                        block_cls=jres.BottleneckBlock,
                        num_filters=RESNET["num_filters"],
                        num_classes=RESNET["num_classes"],
                        dtype=jnp.float32)
    return jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False))["params"]


def _resnet_to_port(tree):
    out = {}
    for name in convert.cnn_leaf_order(_resnet_port()):
        node = tree
        for key in convert._cnn_path(name)[1]:
            node = node[key]
        out[name] = np.ascontiguousarray(
            convert._kernel_to_torch(np.asarray(node)))
    return out


def _resnet_to_flax(arrays):
    return convert.cnn_params_to_flax(
        {n: torch.from_numpy(v) for n, v in arrays.items()})[0]


MODELS = {
    "gpt": dict(shapes=_gpt_shapes, to_port=_gpt_to_port,
                to_flax=_gpt_to_flax, layouts={"model": "gpt_tiny"},
                names=lambda: convert.flax_leaf_order(ttr.gpt_tiny())),
    "cnn": dict(shapes=_resnet_shapes, to_port=_resnet_to_port,
                to_flax=_resnet_to_flax,
                layouts=dict(RESNET, model="resnet"),
                names=lambda: convert.cnn_leaf_order(_resnet_port())),
}
# (model, config) of the quantized model-leaf jobs.
MODEL_Q = [("gpt", dict(op="average", compression="int8")),
           ("gpt", dict(op="sum", compression="uint4",
                        compression_block_size=64)),
           ("cnn", dict(op="average", compression="int8",
                        compression_block_size=32)),
           ("cnn", dict(op="sum", compression="uint4",
                        compression_block_size=16))]


def _model_trees(model, seed, world=2):
    shapes = MODELS[model]["shapes"]()
    return [random_tree(shapes, seed + r) for r in range(world)]


def _model_set(model, trees):
    spec = MODELS[model]
    return {"names": spec["names"](),
            "ranks": [spec["to_port"](t) for t in trees]}


# --- the codec --------------------------------------------------------------
@pytest.mark.parametrize("codec", ["int8", "uint4"])
@pytest.mark.parametrize("block", [2, 16, 256])
def test_codec_matches_jax_ops_bitwise(codec, block):
    rng = np.random.default_rng(block)
    x = (3 * rng.standard_normal((3, block * 40))).astype(np.float32)
    x[1, :block] = 0.7          # a constant block: scale falls back to 1
    x[2, block:2 * block] = 0.0
    jq, js, jz = jax_ops.quantize_rows(jnp.asarray(x), JCodec[codec.upper()],
                                       block)
    tq, ts, tz = tops.quantize_rows(torch.from_numpy(x),
                                    TCodec[codec.upper()], block)
    assert tq.dtype == torch.uint8
    assert tq.shape[1] == x.shape[1] // (2 if codec == "uint4" else 1)
    for a, b, what in ((jq, tq, "payload"), (js, ts, "scales"),
                       (jz, tz, "zero points")):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), what)
    assert ts[1, 0] == 1.0 and tz[1, 0] == np.float32(0.7)
    jd = jax_ops.dequantize_rows(jq, js, jz, JCodec[codec.upper()], block)
    td = tops.dequantize_rows(tq, ts, tz, TCodec[codec.upper()], block)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_world_one_quantizes_like_jax_at_one_device():
    per_rank = _small(7, world=1)
    for kw in QCONFIGS[:4]:
        want = jax_sync(per_rank, {"dp": 1}, fusion_threshold_bytes=THRESHOLD,
                        **kw)[0]
        got = tsync.sync_gradients(
            {n: torch.from_numpy(v) for n, v in per_rank[0].items()},
            tsync.GradSyncConfig(fusion_threshold_bytes=THRESHOLD, **kw))
        n_levels = LEVELS[kw["compression"]]
        assert_quantized_close(
            {n: v.numpy() for n, v in got.items()}, want,
            block_levels(want, THRESHOLD, 256, n_levels, 1), str(kw),
            quantization_profile(per_rank, THRESHOLD, 256, n_levels, kw["op"]))
        assert any((got[n].numpy() != per_rank[0][n]).any() for n in SHAPES)


# --- the 2-rank world ---------------------------------------------------------
def _two_rank_jobs():
    jobs = [dict(kind="sync", set="small",
                 config=dict(kw, fusion_threshold_bytes=THRESHOLD))
            for kw in QCONFIGS]
    jobs += [dict(kind="ef", steps=["small", "small2"],
                  config=dict(op="average", compression="int8",
                              error_feedback=True,
                              fusion_threshold_bytes=THRESHOLD)),
             dict(kind="ef", steps=["gpt", "gpt2"], layouts={"model":
                                                           "gpt_tiny"},
                  config=dict(op="sum", compression="uint4",
                              compression_block_size=64, error_feedback=True,
                              fusion_threshold_bytes=GPT_THRESHOLD))]
    jobs += [dict(kind="sync", set="small", config=dict(op="adasum",
                                                         compression=c))
             for c in (None, "fp16")]
    jobs += [dict(kind="allreduce", set="small", op=op)
             for op in ("max", "min")]
    jobs += [dict(kind="sync", set=model, layouts=MODELS[model]["layouts"],
                  config=dict(kw, fusion_threshold_bytes=GPT_THRESHOLD))
             for model, kw in MODEL_Q]
    for (opt, _), compression, extra in RING:
        jobs.append(dict(kind="ring", steps=["small", "small2"],
                         optimizer=opt, config=dict(
                             op="average", compression=compression,
                             optimizer_in_ring=True, **extra)))
    jobs.append(dict(kind="ring", steps=["gpt", "gpt2"], optimizer=ADAMW[0],
                     layouts={"model": "gpt_tiny"},
                     config=dict(op="average", compression="int8",
                                 optimizer_in_ring=True)))
    for opt in (SGD, ADAMW):
        jobs.append(dict(kind="sync_then_update", steps=["small", "small2"],
                         optimizer=opt[0], config=dict(op="average")))
    return jobs


JOBS2 = _two_rank_jobs()


def _job(kind, **match):
    return next(j for j, job in enumerate(JOBS2) if job["kind"] == kind
                and all(job.get(k) == v for k, v in match.items()))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    gpt = [_model_trees("gpt", 10), _model_trees("gpt", 20)]
    cnn = _model_trees("cnn", 30)
    gpt_params = random_tree(_gpt_shapes(), 40, scale=0.05)
    sets = {"small": _small_set(0, params_seed=5), "small2": _small_set(1),
            "gpt": dict(_model_set("gpt", gpt[0]),
                        params=_gpt_to_port(gpt_params)),
            "gpt2": _model_set("gpt", gpt[1]),
            "cnn": _model_set("cnn", cnn)}
    outs = run_gloo_world(tmp_path_factory.mktemp("world2"), 2, sets, JOBS2)
    return dict(sets=sets, outs=outs, gpt=gpt, cnn=cnn,
                gpt_params=gpt_params)


def _rank_tree(out, j, names, prefix=""):
    return {n: out[f"{j}/{prefix}{n}"] for n in names}


@pytest.mark.parametrize("c", range(len(QCONFIGS)),
                         ids=["-".join(str(v) for v in kw.values())
                              for kw in QCONFIGS])
def test_quantized_sync_matches_jax(world2, c):
    kw = QCONFIGS[c]
    per_rank = world2["sets"]["small"]["ranks"]
    want = jax_sync(per_rank, {"dp": 2}, fusion_threshold_bytes=THRESHOLD,
                    **kw)
    bs = kw.get("compression_block_size", 256)
    n_levels = LEVELS[kw["compression"]]
    profile = quantization_profile(per_rank, THRESHOLD, bs, n_levels, kw["op"])
    for r, out in enumerate(world2["outs"]):
        assert_quantized_close(
            _rank_tree(out, c, SHAPES), want[r],
            block_levels(want[r], THRESHOLD, bs, n_levels, 2),
            f"rank {r} {kw}", profile)
    for n in SHAPES:       # the ranks end with one result
        np.testing.assert_array_equal(world2["outs"][0][f"{c}/{n}"],
                                      world2["outs"][1][f"{c}/{n}"])


@pytest.mark.parametrize("which", ["small-int8", "gpt-uint4"])
def test_error_feedback_two_steps_matches_jax(world2, which):
    j = _job("ef", steps=["small", "small2"]) if which == "small-int8" \
        else _job("ef", steps=["gpt", "gpt2"])
    job = JOBS2[j]
    cfg = {k: v for k, v in job["config"].items() if k != "error_feedback"}
    bs = cfg.get("compression_block_size", 256)
    levels_n = LEVELS[cfg["compression"]]
    threshold = cfg["fusion_threshold_bytes"]
    if which == "small-int8":
        steps = [world2["sets"][s]["ranks"] for s in job["steps"]]
        to_flax, names = (lambda t: t), list(SHAPES)
    else:
        steps = world2["gpt"]
        to_flax, names = _gpt_to_flax, MODELS["gpt"]["names"]()
    want = jax_sync_ef(steps, {"dp": 2}, error_feedback=True, **cfg)
    for k, (synced, res) in enumerate(want):
        # Each rank sends its gradient plus the residual it carries.
        comp = [jax.tree_util.tree_map(lambda g, p: g + p, steps[k][r],
                                       want[k - 1][1][r]) if k
                else steps[k][r] for r in range(2)]
        profile = quantization_profile(comp, threshold, bs, levels_n, cfg["op"])
        for r, out in enumerate(world2["outs"]):
            got = to_flax(_rank_tree(out, j, names, f"{k}/"))
            assert_quantized_close(got, synced[r], block_levels(
                synced[r], threshold, bs, levels_n, 2), f"step {k} rank {r}",
                profile)
            # The residual is what the wire missed of this rank's
            # compensated input: within a level of that input's block.
            got_res = to_flax(_rank_tree(out, j, names, f"r{k}/"))
            assert_quantized_close(
                got_res, res[r],
                block_levels(comp[r], threshold, bs, levels_n, 2),
                f"residual {k} rank {r}",
                quantization_profile([comp[r], comp[1 - r]], threshold, bs,
                                     levels_n))
            assert max(np.abs(np.asarray(x)).max()
                       for x in jax.tree_util.tree_leaves(got_res)) > 0


@pytest.mark.parametrize("wire", [None, "fp16"], ids=["fp32", "fp16"])
def test_adasum_matches_jax(world2, wire):
    j = _job("sync", config=dict(op="adasum", compression=wire))
    per_rank = world2["sets"]["small"]["ranks"]
    want = jax_sync(per_rank, {"dp": 2}, op="adasum", compression=wire)
    for r, out in enumerate(world2["outs"]):
        for n in SHAPES:
            _assert_adasum_close(out[f"{j}/{n}"], want[r][n], wire,
                                 f"rank {r} {n}")
    # Not a sum: adasum scales the pair down where the vectors agree.
    total = per_rank[0]["b"] + per_rank[1]["b"]
    assert np.abs(world2["outs"][0][f"{j}/b"] - total).max() > 1e-2


def _assert_adasum_close(got, want, wire, label):
    """fp32 round-off of the vector: the combine's coefficients are dot
    products over the whole leaf, summed in another order on each side,
    so their round-off scales the largest element (rtol 1e-6 of
    max|want|, atol 1e-7).  On the fp16 wire the result is rounded to
    fp16 after that, so an element within round-off of an fp16 rounding
    boundary may land one fp16 unit (2^-10 relative) away."""
    tol = 1e-6 * np.abs(want).max() + 1e-7
    d = np.abs(got - want)
    if wire == "fp16":
        tol = np.maximum(tol, 2.0 ** -10 * np.abs(want))
    assert (d <= tol).all(), (label, float(d.max()))


@pytest.mark.parametrize("op", ["max", "min"])
def test_max_min_match_jax(world2, op):
    j = _job("allreduce", op=op)
    per_rank = world2["sets"]["small"]["ranks"]
    mesh, axes = jax_mesh({"dp": 2})
    want = unstack(jax.jit(shard_map(
        lambda g: jax.tree_util.tree_map(
            lambda x: jcoll.allreduce(x, "dp", op), g), mesh=mesh,
        in_specs=jax.sharding.PartitionSpec(axes),
        out_specs=jax.sharding.PartitionSpec(axes), check_vma=False))(
            stack(per_rank)), 2)
    for r, out in enumerate(world2["outs"]):
        for n in SHAPES:
            np.testing.assert_allclose(out[f"{j}/{n}"], want[r][n],
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("m", range(len(MODEL_Q)),
                         ids=[f"{m}-{kw['compression']}" for m, kw in MODEL_Q])
def test_model_leaves_in_flax_order_match_jax(world2, m):
    model, kw = MODEL_Q[m]
    j = _job("sync", set=model, config=dict(
        kw, fusion_threshold_bytes=GPT_THRESHOLD))
    trees = world2["gpt"][0] if model == "gpt" else world2["cnn"]
    want = jax_sync(trees, {"dp": 2}, fusion_threshold_bytes=GPT_THRESHOLD,
                    **kw)
    names = MODELS[model]["names"]()
    bs = kw.get("compression_block_size", 256)
    n_levels = LEVELS[kw["compression"]]
    profile = quantization_profile(trees, GPT_THRESHOLD, bs, n_levels, kw["op"])
    for r, out in enumerate(world2["outs"]):
        got = MODELS[model]["to_flax"](_rank_tree(out, j, names))
        assert_quantized_close(
            got, want[r], block_levels(want[r], GPT_THRESHOLD, bs, n_levels,
                                       2), f"rank {r}", profile)


def _assert_params_close(got, want, label, leg=None):
    """fp32 round-off; with ``leg`` = (lr, bound, G) for a quantized
    gradient leg, round-off of the exchange (``ROUNDOFF`` of the summed
    gradient magnitude G, through lr) on 99.9 % and ``bound`` everywhere."""
    g = np.concatenate([np.asarray(x).reshape(-1)
                        for x in jax.tree_util.tree_leaves(got)])
    w = np.concatenate([np.asarray(x).reshape(-1)
                        for x in jax.tree_util.tree_leaves(want)])
    if leg is None:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=label)
        return
    lr, bound, big = leg
    d = np.abs(g - w)
    assert d.max() <= bound, (label, d.max())
    close = d <= 1e-6 * np.abs(w) + 1e-7 + 2 * lr * ROUNDOFF * big
    assert close.mean() >= 0.999, (label, int((~close).sum()), d.size)


def _int8_leg(opt, steps):
    """(lr, bound, G) of ``_assert_params_close`` for an int8 gradient
    leg: SGD moves a parameter by lr (1 + momentum) times the gradient's
    error, at most a level of the summed gradients' range; Adam's early
    steps are lr * sign(g), which a level's difference flips where g is
    near 0, so its bound is 2 lr."""
    lr = opt["kw"]["lr"]
    big = max(float(np.max(sum(np.abs(np.asarray(v)) for v in leaf)))
              for step in steps
              for leaf in zip(*[jax.tree_util.tree_leaves(t) for t in step]))
    if opt["cls"] == "AdamW":
        return lr, 2 * lr, big
    return lr, lr * 1.9 * 2 * big / 255, big


@pytest.mark.parametrize("c", range(len(RING)),
                         ids=[f"{o[0]['cls']}-{w}" + ("-scale-clip" if e else "")
                              for o, w, e in RING])
def test_ring_matches_jax(world2, c):
    (opt, tx), compression, extra = RING[c]
    j = _job("ring", steps=["small", "small2"], optimizer=opt,
             config=dict(op="average", compression=compression,
                         optimizer_in_ring=True, **extra))
    steps = [world2["sets"][s]["ranks"] for s in ("small", "small2")]
    params = world2["sets"]["small"]["params"]
    want = jax_ring(tx, steps, params, {"dp": 2}, op="average",
                    compression=compression, **extra)
    leg = _int8_leg(opt, steps) if compression == "int8" else None
    for k in range(2):
        for r, out in enumerate(world2["outs"]):
            _assert_params_close(_rank_tree(out, j, SHAPES, f"{k}/"),
                                 want[k], f"step {k} rank {r}", leg)
    # Optimizer state: 1/world of the flat buffer per rank.
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    chunk = tsync.ring_chunk_size(n, 2, tsync.GradSyncConfig(
        compression=compression))
    state = world2["outs"][0][f"{j}/state"]
    assert state[0] == chunk and all(s == chunk for s in state[1:])
    assert len(state) == (2 if opt["cls"] == "SGD" else 3)


def test_ring_on_gpt_leaves_matches_jax(world2):
    j = _job("ring", steps=["gpt", "gpt2"])
    want = jax_ring(ADAMW[1], world2["gpt"], world2["gpt_params"], {"dp": 2},
                    op="average", compression="int8")
    names = MODELS["gpt"]["names"]()
    for k in range(2):
        for r, out in enumerate(world2["outs"]):
            _assert_params_close(
                _gpt_to_flax(_rank_tree(out, j, names, f"{k}/")), want[k],
                f"step {k} rank {r}", _int8_leg(ADAMW[0], world2["gpt"]))


@pytest.mark.parametrize("opt", ["SGD", "AdamW"])
def test_ring_matches_sync_then_update(world2, opt):
    spec = (SGD if opt == "SGD" else ADAMW)[0]
    ring = _job("ring", steps=["small", "small2"], optimizer=spec,
                config=dict(op="average", compression=None,
                            optimizer_in_ring=True))
    plain = _job("sync_then_update", optimizer=spec)
    for k in range(2):
        for out in world2["outs"]:
            for n in SHAPES:
                np.testing.assert_allclose(out[f"{ring}/{k}/{n}"],
                                           out[f"{plain}/{k}/{n}"],
                                           rtol=1e-6, atol=1e-7)


# --- the 4-rank world ---------------------------------------------------------
MESH22 = {"dp": 2, "fsdp": 2}
# Leaf lengths 301 and 77: odd, so the inner reduce-scatter pads.
SHAPES4 = {"a": (301,), "b": (7, 11), "c": (64,)}
JOBS4 = [
    dict(kind="sync", set="s4", config=dict(op="adasum")),
    dict(kind="sync", set="s4", config=dict(op="sum", compression="int8",
                                            compression_block_size=16)),
    dict(kind="sync", set="s4", mesh=MESH22, config=dict(
        axes=["dp", "fsdp"], op="average", hierarchical=True)),
    dict(kind="sync", set="s4", mesh=MESH22, config=dict(
        axes=["dp", "fsdp"], op="sum", hierarchical=True)),
    dict(kind="sync", set="s4", mesh=MESH22, config=dict(
        axes=["dp", "fsdp"], op="sum", compression="int8",
        compression_block_size=16)),
    dict(kind="adasum_odd"),
]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.default_rng(4)
    per_rank = [{n: (2 * rng.standard_normal(s)).astype(np.float32)
                 for n, s in SHAPES4.items()} for _ in range(4)]
    outs = run_gloo_world(tmp_path_factory.mktemp("world4"), 4,
                          {"s4": {"names": list(SHAPES4),
                                  "ranks": per_rank}}, JOBS4)
    return per_rank, outs


def test_four_rank_adasum_matches_jax(world4):
    per_rank, outs = world4
    want = jax_sync(per_rank, {"dp": 4}, op="adasum")
    for r, out in enumerate(outs):
        for n in SHAPES4:
            _assert_adasum_close(out[f"0/{n}"], want[r][n], None,
                                 f"rank {r} {n}")


@pytest.mark.parametrize("j,shape", [(1, {"dp": 4}), (4, MESH22)],
                         ids=["dp4", "dp2-fsdp2"])
def test_four_rank_int8_matches_jax(world4, j, shape):
    per_rank, outs = world4
    kw = {k: v for k, v in JOBS4[j]["config"].items() if k != "axes"}
    want = jax_sync(per_rank, shape, **kw)
    threshold = 64 << 20
    profile = quantization_profile(per_rank, threshold, 16, 256, "sum")
    for r, out in enumerate(outs):
        assert_quantized_close(
            _rank_tree(out, j, SHAPES4), want[r],
            block_levels(want[r], threshold, 16, 256, 4), f"rank {r}", profile)


@pytest.mark.parametrize("j", [2, 3], ids=["average", "sum"])
def test_hierarchical_matches_jax(world4, j):
    per_rank, outs = world4
    op = JOBS4[j]["config"]["op"]
    hier = jax_sync(per_rank, MESH22, op=op, hierarchical=True)
    flat = jax_sync(per_rank, MESH22, op=op)
    for r, out in enumerate(outs):
        for n in SHAPES4:
            for want in (hier, flat):
                np.testing.assert_allclose(out[f"{j}/{n}"], want[r][n],
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"rank {r} {n}")


def test_adasum_needs_a_power_of_two(world4):
    _, outs = world4
    assert all(bool(out["5/raised"]) for out in outs)


# --- every knob in Trainer ------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(compression="int8"), dict(compression="uint4"),
    dict(compression="int8", error_feedback=True), dict(op="adasum"),
    dict(hierarchical=True), dict(optimizer_in_ring=True),
    dict(optimizer_in_ring=True, compression="int8"),
    dict(optimizer_in_ring=True, compression="bf16")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_every_knob_runs_in_trainer(kwargs):
    """One rank, gpt_tiny: each reference knob builds a Trainer and steps
    it (the loss falls on a fixed batch); the ring's state is the shard
    optimizer."""
    from horovod_tpu_torch import Trainer, build_mesh, synthetic_text_batch
    model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                              device="cpu", seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3, weight_decay=1e-4)
    trainer = Trainer(model, opt, build_mesh(device="cpu"),
                      sync=tsync.GradSyncConfig(**kwargs))
    state = trainer.init()
    batch = synthetic_text_batch(2, 16, 256, seed=1, device="cpu")
    losses = [float(trainer.step(state, batch)[1]["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    if kwargs.get("optimizer_in_ring"):
        n = sum(p.numel() for p in model.parameters())
        (shard,) = state.optimizer.param_groups[0]["params"]
        assert shard.numel() == tsync.ring_chunk_size(
            n, 1, tsync.GradSyncConfig(**kwargs))
        assert state.optimizer is not opt and not opt.state


def test_ring_optimizer_takes_one_param_group():
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(5))
    cfg = tsync.GradSyncConfig(optimizer_in_ring=True, compression="int8",
                               compression_block_size=4)
    ring = tsync.init_ring_optimizer(
        torch.optim.SGD([a, b], lr=0.5, momentum=0.9), [a, b], 2, cfg)
    (shard,) = ring.param_groups[0]["params"]
    assert shard.dtype == torch.float32 and shard.numel() == 4
    assert ring.param_groups[0]["lr"] == 0.5
    assert ring.param_groups[0]["momentum"] == 0.9
    with pytest.raises(ValueError, match="one param group"):
        tsync.init_ring_optimizer(torch.optim.SGD(
            [{"params": [a]}, {"params": [b], "lr": 0.1}], lr=0.5),
            [a, b], 2, cfg)
