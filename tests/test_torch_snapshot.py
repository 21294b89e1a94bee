"""The port's state images (``horovod_tpu_torch/statesync/snapshot.py``)
against the JAX package's: the same weights give the same bytes and the
same digest, and the ring-shard re-layout is the same, bitwise.

- gpt_tiny's params (flax init, carried across by ``convert``) and a
  small ResNet's (drawn with numpy), flattened in the flax leaf order
  (``training._leaf_order``) through ``convert.flax_layouts``, against
  ``flatten_state`` over the flax tree;
- bf16 leaves (numpy has none: the bytes go through ``view``);
- ``reshard_ring_state`` 4→2, 2→4 and 3→1 on the same numpy shards, with
  the plain and the block-aligned (int8) layout;
- ``unflatten_state`` refuses an image of the wrong size, as the
  reference's does.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import resnet as jres
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import GradSyncConfig as JSync
from horovod_tpu.statesync import snapshot as js
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import GradSyncConfig as TSync
from horovod_tpu_torch.statesync import snapshot as ts
from horovod_tpu_torch.training import _leaf_order
from torch_cnn_util import load, random_variables


def _port_tree(model):
    params = dict(model.named_parameters())
    return {n: params[n] for n in _leaf_order(model)}


def _gpt_tiny():
    cfg = jtr.gpt_tiny(dtype=jnp.float32)
    variables = jtr.TransformerLM(cfg).init(jax.random.key(3),
                                            jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tcfg = ttr.gpt_tiny(dtype=torch.float32)
    model = ttr.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_flax(params, tcfg))
    return params, model


def _resnet():
    flax_model = jres.ResNet(stage_sizes=(1, 1),
                             block_cls=jres.BottleneckBlock, num_filters=8,
                             num_classes=10, dtype=jnp.float32)
    variables = random_variables(flax_model, (2, 16, 16, 3), seed=4)
    model = tres.ResNet((1, 1), tres.BottleneckBlock, num_filters=8,
                        num_classes=10, dtype=torch.float32, device="cpu")
    load(model, variables)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return params, model


@pytest.mark.parametrize("make", [_gpt_tiny, _resnet],
                         ids=["gpt_tiny", "resnet"])
def test_image_and_digest_are_the_references(make):
    params, model = make()
    layouts = convert.flax_layouts(model)
    tree = _port_tree(model)
    image = ts.flatten_state(tree, layouts)
    ref = js.flatten_state(params)
    assert len(image) == len(ref) == ts.state_nbytes(tree) \
        == js.state_nbytes(params)
    assert bytes(image) == bytes(ref)
    assert ts.state_digest(image) == js.state_digest(ref)
    snap = ts.Snapshot(tree, "e1", 7, layouts)
    ref_snap = js.Snapshot(params, "e1", 7)
    assert snap.stamp.as_meta() == ref_snap.stamp.as_meta()
    assert ts.SnapshotStamp.from_meta(ref_snap.stamp.as_meta()) == snap.stamp
    # The inverse, through the layouts: the port's own tensors back,
    # bitwise, as new tensors and in place.
    back = ts.unflatten_state(ref, tree, layouts)
    assert list(back) == list(tree)
    for name, t in tree.items():
        assert torch.equal(back[name], t.detach()), name
    zeros = {n: torch.zeros_like(t) for n, t in tree.items()}
    ts.load_state_into(bytes(ref), zeros, layouts)
    for name, t in tree.items():
        assert torch.equal(zeros[name], t.detach()), name


def test_bf16_and_integer_leaves_keep_their_bytes():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 1 << 16, (3, 5), dtype=np.uint16)
    bits[(bits & 0x7f80) == 0x7f80] = 0x3f80     # no NaN or inf patterns
    ref_tree = {"a_bf16": jnp.asarray(bits).view(jnp.bfloat16),
                "b_f32": rng.standard_normal(7).astype(np.float32),
                "c_count": np.int32(9)}
    tree = {"a_bf16": torch.from_numpy(bits.view(np.int16)).view(
                torch.bfloat16),
            "b_f32": torch.from_numpy(ref_tree["b_f32"]),
            "c_count": torch.tensor(9, dtype=torch.int32)}
    image = ts.flatten_state(tree)
    assert bytes(image) == bytes(js.flatten_state(ref_tree))
    back = ts.unflatten_state(image, tree)
    for name in tree:
        assert back[name].dtype == tree[name].dtype
        assert torch.equal(back[name], tree[name]), name
    assert ts.fnv1a_fold(b"horovod") == js.fnv1a_fold(b"horovod")
    blob = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    assert ts.state_digest(blob) == js.state_digest(blob)


def _shards(world, n, chunk, seed):
    rng = np.random.default_rng(seed)
    full_mu = rng.standard_normal(n).astype(np.float32)
    full_nu = rng.random(n).astype(np.float32)
    shards = []
    for r in range(world):
        shard = {}
        for name, full in (("mu", full_mu), ("nu", full_nu)):
            padded = np.zeros(chunk * world, np.float32)
            padded[:n] = full
            shard[name] = padded[r * chunk:(r + 1) * chunk].copy()
        shards.append({"count": np.int32(5), **shard})
    return shards


@pytest.mark.parametrize("old,new", [(4, 2), (2, 4), (3, 1)])
@pytest.mark.parametrize("codec", [None, "int8"])
def test_reshard_is_the_references(old, new, codec):
    n = 23
    tcfg = TSync(compression=codec, compression_block_size=4)
    jcfg = JSync(compression=codec, compression_block_size=4)
    chunk = ts.ring_chunk(n, old, tcfg)
    assert chunk == js.ring_chunk(n, old, jcfg)
    shards = _shards(old, n, chunk, seed=old * 10 + new)
    full = ts.concat_ring_shards([s["mu"] for s in shards], n)
    np.testing.assert_array_equal(
        full, js.concat_ring_shards([s["mu"] for s in shards], n))
    for rank in range(new):
        got = ts.reshard_ring_state(shards, n, new, rank, tcfg)
        want = js.reshard_ring_state(shards, n, new, rank, jcfg)
        assert list(got) == sorted(want)
        for name in got:
            assert got[name].dtype == np.asarray(want[name]).dtype
            np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(
            ts.shard_for_rank(full, n, new, rank, tcfg),
            js.shard_for_rank(full, n, new, rank, jcfg))


def test_reshard_refuses_what_the_reference_refuses():
    n, chunk = 9, 5
    shards = _shards(2, n, chunk, seed=1)
    shards[1]["count"] = np.int32(6)             # a torn pair of shards
    for mod in (ts, js):
        with pytest.raises(ValueError, match="different steps"):
            mod.reshard_ring_state(shards, n, 1, 0)
        with pytest.raises(ValueError, match="at least one shard"):
            mod.reshard_ring_state([], n, 1, 0)
        with pytest.raises(ValueError, match="n_params"):
            mod.concat_ring_shards([np.zeros(3, np.float32)], 4)


def test_unflatten_refuses_a_wrong_sized_image():
    tree = {"w": torch.zeros(3, 4), "b": torch.zeros(4)}
    ref_tree = {"b": np.zeros(4, np.float32), "w": np.zeros((3, 4),
                                                            np.float32)}
    image = ts.flatten_state(tree)
    for mod, template in ((ts, tree), (js, ref_tree)):
        with pytest.raises(ValueError, match="state image is 60 bytes but "
                                             "the template flattens to 64"):
            mod.unflatten_state(bytes(image)[:-4], template)
    with pytest.raises(ValueError, match="template flattens to 64"):
        ts.load_state_into(bytes(image) + b"\0" * 4, tree)
