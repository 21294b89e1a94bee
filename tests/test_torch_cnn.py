"""The port's CNN layers and models against the flax ones on the CPU.

Inputs and weights are drawn with numpy from a seed and carried across
with ``convert.cnn_params_from_flax``.  In fp32: logits within 1e-4 of
max|ref| (sums in another order), BatchNorm statistics within 1e-5.
The cases that catch the likeliest silent breaks are here on purpose:
``"SAME"`` at stride 2 on even maps (pads (0, 1)) and odd ones (1, 1);
BatchNorm's biased running variance; VGG's NHWC flatten of a map larger
than 1x1; Inception's construction-order names.
"""
from __future__ import annotations

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import inception as jinc
from horovod_tpu.models import resnet as jres
from horovod_tpu.models import vgg as jvgg
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import inception as tinc
from horovod_tpu_torch.models import layers
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models import vgg as tvgg
from torch_cnn_util import (assert_trees_close, batch_stats, load,
                            max_rel_err, random_variables, to_nchw, to_nhwc)

LOGITS_REL = 1e-4
STATS_ATOL = 1e-5


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_apply(model, variables, x, train):
    """flax forward; returns (output, batch_stats after it)."""
    if train:
        out, updated = model.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        return np.asarray(out), updated["batch_stats"]
    out = model.apply(variables, jnp.asarray(x), train=False)
    return np.asarray(out), variables["batch_stats"]


# ---------------------------------------------------------------- stems
def test_space_to_depth_matches_jax():
    x = _images((2, 8, 6, 3))
    want = np.asarray(jres.space_to_depth(jnp.asarray(x), 2))
    got = tres.space_to_depth(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    for fn in (lambda: jres.space_to_depth(jnp.zeros((1, 9, 8, 3))),
               lambda: tres.space_to_depth(torch.zeros(1, 9, 8, 3))):
        with pytest.raises(ValueError, match="divisible"):
            fn()


def test_fold_conv7_stem_weights_matches_jax():
    w7 = _images((7, 7, 3, 5), seed=1)                   # flax [kh,kw,C,F]
    want = np.asarray(jres.fold_conv7_stem_weights(jnp.asarray(w7)))
    got = tres.fold_conv7_stem_weights(
        torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()))
    assert got.shape == (5, 12, 4, 4)
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


# ---------------------------------------------------------------- layers
CONV_CASES = [  # (kernel, strides, padding)
    ((3, 3), (2, 2), "SAME"), ((1, 1), (2, 2), "SAME"),
    ((3, 3), (1, 1), "SAME"), ((7, 1), (1, 1), "SAME"),
    ((4, 4), (2, 2), "SAME"), ((3, 3), (2, 2), "VALID"),
    ((7, 7), (2, 2), ((3, 3), (3, 3))), ((4, 4), (1, 1), ((2, 1), (2, 1))),
]


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kernel,strides,padding", CONV_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_conv_matches_flax(size, kernel, strides, padding):
    x = _images((2, size, size, 3))
    jconv = fnn.Conv(5, kernel, strides, padding=padding, use_bias=True,
                     dtype=jnp.float32)
    variables = random_variables(jconv, x.shape, seed=size)
    want = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    conv = layers.Conv(3, 5, kernel, strides, padding, use_bias=True,
                       dtype=torch.float32)
    load(conv, variables)
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    out = conv(to_nchw(x))
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = to_nhwc(out)
    assert got.shape == want.shape
    assert max_rel_err(got, want) < LOGITS_REL


def test_same_stride2_on_even_map_is_not_torch_padding_one():
    """The check above can tell (0, 1) from torchvision's (1, 1)."""
    x = to_nchw(_images((1, 8, 8, 3)))
    conv = layers.Conv(3, 4, (3, 3), (2, 2), "SAME", dtype=torch.float32)
    # Drawn weights: the constructor leaves them uninitialised (the models
    # draw every layer's), and whatever memory they landed on decided
    # the test.
    conv.reset_parameters(torch.Generator().manual_seed(0))
    ours = conv(x)
    theirs = F.conv2d(x, conv.weight, None, 2, 1)
    assert ours.shape == theirs.shape
    assert (ours - theirs).abs().max() > 0.1
    assert layers._pads("SAME", (8, 9), (3, 3), (2, 2)) == ((0, 1), (1, 1))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("zero_scale", [False, True])
@pytest.mark.parametrize("epsilon", [1e-5, 1e-3])
def test_batch_norm_matches_flax(train, zero_scale, epsilon):
    rng = np.random.default_rng(3)
    c = 6
    # An offset mean and unequal channel scales; 2x4x4 is where torch's
    # unbiased running variance would be 3 % off.
    x = (3.0 + rng.uniform(0.2, 2.0, c) * rng.standard_normal(
        (2, 4, 4, c))).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                        epsilon=epsilon, dtype=jnp.float32)
    variables = random_variables(jbn, x.shape, seed=4)
    if zero_scale:
        variables["params"]["scale"] = np.zeros(c, np.float32)
    want, updated = jbn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
    want, want_stats = np.asarray(want), updated["batch_stats"]
    bn = layers.BatchNorm(c, momentum=0.9, epsilon=epsilon,
                          dtype=torch.float32)
    load(bn, variables)
    got = to_nhwc(bn(to_nchw(x), train))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert_trees_close(batch_stats(bn), want_stats, atol=STATS_ATOL)
    if train:
        # The biased variance, not torch's BatchNorm2d's unbiased one.
        var = x.reshape(-1, c).var(0)
        np.testing.assert_allclose(
            bn.var.numpy(), 0.9 * variables["batch_stats"]["var"] + 0.1 * var,
            rtol=1e-5)


def test_batch_norm_cross_replica_is_not_ported():
    """Cross-replica BatchNorm is ported (the name is from when
    ``axis_name`` raised): at one rank it is flax's BatchNorm (the
    batch's mean and biased variance); in train mode outside a manual
    region its axis is unbound and it raises, as in JAX; in eval mode it
    needs no axis."""
    from horovod_tpu_torch.parallel import build_mesh
    from horovod_tpu_torch.parallel.mesh import manual_region
    rng = np.random.default_rng(6)
    c = 4
    x = (2.0 + rng.standard_normal((3, 5, 5, c))).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.float32)
    variables = random_variables(jbn, x.shape, seed=2)
    want, updated = jbn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
    bn = layers.BatchNorm(c, momentum=0.9, epsilon=1e-5,
                          dtype=torch.float32, axis_name="dp")
    load(bn, variables)
    with pytest.raises(NameError, match="unbound axis name: dp"):
        bn(to_nchw(x), True)
    with manual_region(build_mesh(device="cpu")):
        got = to_nhwc(bn(to_nchw(x), True))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert_trees_close(batch_stats(bn), updated["batch_stats"],
                       atol=STATS_ATOL)
    assert np.isfinite(to_nhwc(bn(to_nchw(x), False))).all()
    model = tres.ResNet18(axis_name="dp", device="cpu", num_filters=8)
    assert model.axis_name == "dp"
    assert {m.axis_name for m in model.modules()
            if isinstance(m, layers.BatchNorm)} == {"dp"}


POOL_CASES = [  # (kind, window, strides, padding)
    ("max", (3, 3), (2, 2), "SAME"), ("avg", (3, 3), (2, 2), "SAME"),
    ("avg", (3, 3), (1, 1), "SAME"), ("max", (3, 3), (1, 1), "SAME"),
    ("max", (3, 3), (2, 2), ((1, 1), (1, 1))), ("max", (2, 2), (2, 2),
                                                "VALID"),
    ("max", (3, 3), (2, 2), "VALID"),
]


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kind,window,strides,padding", POOL_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_pools_match_flax(size, kind, window, strides, padding):
    x = _images((2, size, size, 4)) - 2.0     # negative: -inf padding shows
    jfn = fnn.max_pool if kind == "max" else fnn.avg_pool
    tfn = layers.max_pool if kind == "max" else layers.avg_pool
    want = np.asarray(jfn(jnp.asarray(x), window, strides=strides,
                          padding=padding))
    got = to_nhwc(tfn(to_nchw(x), window, strides, padding))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- models
RESNETS = {"basic": ((1, 1), jres.BasicBlock, tres.BasicBlock),
           "bottleneck": ((1, 1, 1), jres.BottleneckBlock,
                          tres.BottleneckBlock)}
RESNET_CASES = [(block, size, stem) for block in RESNETS
                for size, stem in ((32, "conv7"), (33, "conv7"),
                                   (32, "space_to_depth"))]


def _resnets(block, stem, dtype=torch.float32):
    stages, jblock, tblock = RESNETS[block]
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = jres.ResNet(stage_sizes=stages, block_cls=jblock, num_filters=8,
                         num_classes=10, dtype=jdtype, stem=stem)
    tmodel = tres.ResNet(stages, tblock, num_filters=8, num_classes=10,
                         dtype=dtype, stem=stem, device="cpu")
    return jmodel, tmodel


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("block,size,stem", RESNET_CASES)
def test_resnet_matches_flax(block, size, stem, train):
    x = _images((2, size, size, 3), seed=size)
    jmodel, tmodel = _resnets(block, stem)
    variables = random_variables(jmodel, x.shape, seed=7)
    want, want_stats = _jax_apply(jmodel, variables, x, train)
    load(tmodel, variables)
    got = tmodel(torch.from_numpy(x), train).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 10)
    assert max_rel_err(got, want) < LOGITS_REL
    assert_trees_close(batch_stats(tmodel), want_stats, atol=STATS_ATOL)


def test_resnet_odd_map_with_space_to_depth_raises():
    _, tmodel = _resnets("basic", "space_to_depth")
    with pytest.raises(ValueError, match="divisible"):
        tmodel(torch.zeros(1, 33, 33, 3))


def test_resnet_bf16_matches_flax():
    """bf16 compute, fp32 parameters.  Both sides accumulate in fp32 and
    round each conv and BatchNorm output to bf16; a rounding that falls
    the other way moves an activation by one bf16 unit (2^-8 relative),
    so the bound is one unit of max|ref| on the fp32 logits and one unit
    on the running statistics.  (On this CPU the two agree to about 1e-7:
    they round alike.)"""
    x = _images((2, 32, 32, 3), seed=5)
    jmodel, tmodel = _resnets("bottleneck", "conv7", torch.bfloat16)
    variables = random_variables(jmodel, x.shape, seed=8)
    want, want_stats = _jax_apply(jmodel, variables, x, True)
    load(tmodel, variables)
    got = tmodel(torch.from_numpy(x), True).detach().numpy()
    assert got.dtype == np.float32
    assert max_rel_err(got, want) < 2 ** -8
    assert_trees_close(batch_stats(tmodel), want_stats, atol=STATS_ATOL,
                       rtol=2 ** -8)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_vgg_matches_flax(train):
    """Last map 8x8x16: the first Dense sees the NHWC flatten of 1024."""
    stages = ((1, 8), (1, 16))
    x = _images((2, 32, 32, 3), seed=9)
    jmodel = jvgg.VGG(stages=stages, num_classes=10, dtype=jnp.float32)
    variables = random_variables(jmodel, x.shape, seed=10)
    want, want_stats = _jax_apply(jmodel, variables, x, train)
    tmodel = load(tvgg.VGG(stages, num_classes=10, dtype=torch.float32,
                           image_size=32, device="cpu"), variables)
    assert tmodel.Dense_0.in_features == 8 * 8 * 16
    got = tmodel(torch.from_numpy(x), train).detach().numpy()
    assert max_rel_err(got, want) < LOGITS_REL
    assert_trees_close(batch_stats(tmodel), want_stats, atol=STATS_ATOL)


def test_vgg_without_batch_norm_matches_flax():
    """The plain VGG: a bias on every conv, no statistics."""
    stages = ((1, 8), (2, 16))
    x = _images((2, 16, 16, 3), seed=16)
    jmodel = jvgg.VGG(stages=stages, num_classes=10, batch_norm=False,
                      dtype=jnp.float32)
    variables = random_variables(jmodel, x.shape, seed=17)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=True))
    tmodel = load(tvgg.VGG(stages, num_classes=10, batch_norm=False,
                           dtype=torch.float32, image_size=16,
                           device="cpu"), variables)
    assert not list(tmodel.buffers())
    got = tmodel(torch.from_numpy(x), True).detach().numpy()
    assert max_rel_err(got, want) < LOGITS_REL


class _JaxStem(fnn.Module):
    """The reference InceptionV3's layers before its first InceptionA."""

    @fnn.compact
    def __call__(self, x, train=False):
        cbn = partial(jinc.ConvBN, dtype=jnp.float32)
        x = cbn(32, (3, 3), (2, 2), padding="VALID")(x, train)
        x = cbn(32, (3, 3), padding="VALID")(x, train)
        x = cbn(64, (3, 3))(x, train)
        x = fnn.max_pool(x, (3, 3), strides=(2, 2), padding="VALID")
        x = cbn(80, (1, 1), padding="VALID")(x, train)
        x = cbn(192, (3, 3), padding="VALID")(x, train)
        return fnn.max_pool(x, (3, 3), strides=(2, 2), padding="VALID")


INCEPTION_BLOCKS = {  # name: (flax block, port block, input NHWC)
    "A": (jinc.InceptionA(8, dtype=jnp.float32),
          partial(tinc.InceptionA, 16, 8), (2, 5, 5, 16)),
    "reductionA": (jinc.ReductionA(dtype=jnp.float32),
                   partial(tinc.ReductionA, 16), (2, 7, 7, 16)),
    "B": (jinc.InceptionB(8, dtype=jnp.float32),
          partial(tinc.InceptionB, 16, 8), (2, 5, 5, 16)),
    "reductionB": (jinc.ReductionB(dtype=jnp.float32),
                   partial(tinc.ReductionB, 16), (2, 7, 7, 16)),
    "C": (jinc.InceptionC(dtype=jnp.float32),
          partial(tinc.InceptionC, 16), (2, 3, 3, 16)),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(INCEPTION_BLOCKS))
def test_inception_block_matches_flax(name, train):
    jblock, tblock, shape = INCEPTION_BLOCKS[name]
    x = _images(shape, seed=11)
    variables = random_variables(jblock, shape, seed=12)
    want, want_stats = _jax_apply(jblock, variables, x, train)
    block = load(tblock(dtype=torch.float32), variables)
    got = to_nhwc(block(to_nchw(x), train))
    assert got.shape == want.shape
    assert block.out_features == want.shape[-1]
    assert max_rel_err(got, want) < LOGITS_REL
    assert_trees_close(batch_stats(block), want_stats, atol=STATS_ATOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_inception_stem_matches_flax(train):
    x = _images((2, 75, 75, 3), seed=13)
    jstem = _JaxStem()
    variables = random_variables(jstem, x.shape, seed=14)
    want, want_stats = _jax_apply(jstem, variables, x, train)
    model = tinc.InceptionV3(num_classes=10, dtype=torch.float32,
                             device="cpu")
    for i in range(5):
        sub = {k: v[f"ConvBN_{i}"] for k, v in variables.items()}
        load(getattr(model, f"ConvBN_{i}"), sub)
    got = to_nhwc(model.stem(to_nchw(x), train))
    assert got.shape == want.shape == (2, 7, 7, 192)
    assert max_rel_err(got, want) < LOGITS_REL
    stats = batch_stats(model)
    assert_trees_close({k: stats[k] for k in want_stats}, want_stats,
                       atol=STATS_ATOL)


# ------------------------------------------------- presets and conversion
def _flax_leaves(model, shape) -> dict:
    tree = jax.eval_shape(partial(model.init, train=False),
                          jax.random.key(0), jnp.zeros(shape, jnp.float32))
    return {tuple([c] + [k.key for k in path]): leaf.shape
            for c in ("params", "batch_stats")
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree[c])}


def _port_leaves(model) -> dict:
    out = {}
    for name, t in model.state_dict().items():
        collection, path = convert._cnn_path(name)
        shape = tuple(t.shape)
        if len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])
        elif len(shape) == 2:
            shape = shape[::-1]
        out[(collection,) + path] = shape
    return out


PRESETS = {  # name: (flax preset, port preset, input shape)
    "resnet18": (jres.ResNet18(), tres.ResNet18, (1, 224, 224, 3)),
    "resnet50": (jres.ResNet50(), tres.ResNet50, (1, 224, 224, 3)),
    "resnet50_s2d": (jres.ResNet50(stem="space_to_depth"),
                     partial(tres.ResNet50, stem="space_to_depth"),
                     (1, 224, 224, 3)),
    "vgg16": (jvgg.VGG16(), tvgg.VGG16, (1, 224, 224, 3)),
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_preset_leaves_and_counts_match_flax(name):
    jmodel, tpreset, shape = PRESETS[name]
    want = _flax_leaves(jmodel, shape)
    model = tpreset(device="cpu")
    assert _port_leaves(model) == want
    count = sum(int(np.prod(s)) for k, s in want.items() if k[0] == "params")
    assert sum(p.numel() for p in model.parameters()) == count


def test_inception_v3_conversion_covers_every_leaf_and_round_trips():
    """The full InceptionV3 forward is the reference's slow tier; here its
    tree (jax.eval_shape) is carried across and back exactly."""
    jmodel = jinc.InceptionV3()
    want = _flax_leaves(jmodel, (1, 299, 299, 3))
    model = tinc.InceptionV3(device="cpu")
    assert _port_leaves(model) == want
    rng = np.random.default_rng(15)
    trees: dict = {"params": {}, "batch_stats": {}}
    for (collection, *path), shape in want.items():
        node = trees[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = rng.standard_normal(shape).astype(np.float32)
    model.load_state_dict(convert.cnn_params_from_flax(
        trees["params"], trees["batch_stats"], model))
    params, stats = convert.cnn_params_to_flax(model.state_dict())
    for got, ref in ((params, trees["params"]),
                     (stats, trees["batch_stats"])):
        assert_trees_close(got, ref, atol=0.0)


def test_cnn_leaf_order_is_the_flax_flatten_order():
    """Sixteen bottleneck blocks: BottleneckBlock_10 sorts before
    BottleneckBlock_2, and upper case before bn_init."""
    jmodel = jres.ResNet50(num_filters=8, num_classes=10)
    tmodel = tres.ResNet50(num_filters=8, num_classes=10, device="cpu")
    tree = jax.eval_shape(partial(jmodel.init, train=False),
                          jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    want = [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_leaves_with_path(tree["params"])]
    got = [convert._cnn_path(n)[1] for n in convert.cnn_leaf_order(tmodel)]
    assert got == want
    order = convert.cnn_leaf_order(tmodel)
    assert order.index("BottleneckBlock_10.Conv_0.weight") \
        < order.index("BottleneckBlock_2.Conv_0.weight") \
        < order.index("bn_init.bias")
