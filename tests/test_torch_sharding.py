"""The port's sharding rules, placement and conversion against the JAX
package, in one process.

- Every case of ``tests/test_parallel.py``'s ``TestSharding`` runs
  through both packages on the same tables and trees: ``spec_for``,
  the placement of ``shard_params``, first match, search not anchored,
  the empty spec, the rank skip, and ``validate``'s problems, equal
  string for string.
- ``shard_params``, ``shard_state_dict`` and the Trainer's chunks are the
  numpy slices of the flax leaves, for every rank of a ``dp=2, tp=2``
  and of a ``fsdp=4`` mesh, and ``unshard_state_dict`` puts them back
  bit for bit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from horovod_tpu.parallel import ShardingRules as JRules
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu.parallel import shard_params as jshard_params
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import sharding as tsh

AXES = tmesh.DEFAULT_AXES


def _port_mesh(**sizes) -> tmesh.Mesh:
    """A mesh record of these sizes (rank 0's coordinates), built by hand:
    no process group is needed to read rules against it."""
    shape = {a: sizes.get(a, 1) for a in AXES}
    return tmesh.Mesh(shape=shape, group=None, device=torch.device("cpu"),
                      groups={}, coords=dict.fromkeys(AXES, 0))


@pytest.fixture(scope="module")
def meshes():
    return jbuild_mesh(dp=4, tp=2), _port_mesh(dp=4, tp=2)


def _both(table):
    """The same table as the reference's and the port's rules."""
    return (JRules([(pat, JP(*spec)) for pat, spec in table]),
            tsh.ShardingRules([(pat, tsh.P(*spec)) for pat, spec in table]))


SPEC_FOR = [
    # first match wins
    ([(r"attn.*kernel", (None, "tp")), (r".*kernel", ("dp", None))],
     [("attn/q/kernel", None), ("mlp/up/kernel", None)]),
    # searched, not anchored
    ([(r"mlp/up", (None, "tp")), (r"^bias$", ("dp",))],
     [("layer0/mlp/up/kernel", None), ("bias", None),
      ("layer0/bias", None)]),
    # the empty spec wins for its paths and never rank-skips
    ([(r"norm", ()), (r".*", ("dp",))],
     [("norm/scale", (4,)), ("w", (4,))]),
    # a spec longer than the leaf's ndim is skipped
    ([(r".*", (None, "tp")), (r"bias", ("dp",))],
     [("bias", (4,)), ("kernel", (4, 4)), ("x", None)]),
]


@pytest.mark.parametrize("table,queries", SPEC_FOR,
                         ids=["first-match", "searched", "empty-spec",
                              "rank-skip"])
def test_spec_for_matches_jax(table, queries):
    jrules, trules = _both(table)
    for path, shape in queries:
        leaf = None if shape is None else np.zeros(shape, np.float32)
        want = tuple(jrules.spec_for(path, leaf))
        got = trules.spec_for(path, leaf)
        assert tuple(got) == want, path
        assert isinstance(got, tsh.P)


PLACEMENT = [
    ([(r"attn.*kernel", (None, "tp"))],
     {"attn": {"kernel": (8, 16)}, "bias": (16,)}),
    ([(r".*", (None, "tp"))], {"bias": (4,)}),
]


@pytest.mark.parametrize("table,tree", PLACEMENT,
                         ids=["places", "rank-mismatch-falls-through"])
def test_placement_matches_jax(meshes, table, tree):
    jmesh, pmesh = meshes
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), tree,
        is_leaf=lambda x: isinstance(x, tuple))
    jrules, trules = _both(table)
    placed = jshard_params(params, jmesh, jrules)
    specs = trules.tree_specs(params)
    jflat = dict(jax.tree_util.tree_leaves_with_path(placed))
    tflat = dict(jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, tsh.P)))
    assert jflat.keys() == tflat.keys()
    for path, arr in jflat.items():
        assert tuple(arr.sharding.spec) == tuple(tflat[path])
    # Every rank's chunk is the device's shard of the placed array.
    sizes = dict(pmesh.shape)
    by_device = {}
    for path, arr in jflat.items():
        for shard in arr.addressable_shards:
            by_device.setdefault(shard.device.id, {})[path] = \
                np.asarray(shard.data)
    devices = np.asarray(jmesh.devices).reshape(-1)
    for rank in range(8):
        chunks = dict(jax.tree_util.tree_leaves_with_path(
            tsh.shard_params(params, sizes, trules, rank=rank)))
        for path, chunk in chunks.items():
            np.testing.assert_array_equal(
                chunk, by_device[devices[rank].id][path])


VALIDATE = [
    ("unknown-axis", [(r".*kernel", (None, "model"))],
     {"attn": {"kernel": (2, 2)}}),
    ("unknown-axes", [(r".*kernel", ("rows", "model"))],
     {"attn": {"kernel": (2, 2)}}),
    ("dead-rule", [(r"decoder.*kernel", (None, "tp"))],
     {"attn": {"kernel": (2, 2)}}),
    ("uncovered-sibling", [(r"attn/wq", (None, "tp"))],
     {"attn": {"wq": (2, 2), "wk": (2, 2)}}),
    ("clean", [(r"attn/w[qk]", (None, "tp"))],
     {"attn": {"wq": (2, 2), "wk": (2, 2)}}),
]


@pytest.mark.parametrize("name,table,tree", VALIDATE,
                         ids=[v[0] for v in VALIDATE])
def test_validate_matches_jax_string_for_string(meshes, name, table, tree):
    jmesh, pmesh = meshes
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s, np.float32), tree,
        is_leaf=lambda x: isinstance(x, tuple))
    jrules, trules = _both(table)
    want = jrules.validate(jmesh, params)
    assert trules.validate(pmesh, params) == want
    assert (want == []) == (name == "clean")
    if name == "uncovered-sibling":
        assert any("HVD801 uncovered path" in p and "attn/wk" in p
                   for p in want)


TP = [(r"attn/w[qkv]/kernel", (None, "tp", None)),
      (r"attn/wo/kernel", ("tp", None, None)),
      (r"mlp/(gate|up)/kernel", (None, "tp")),
      (r"mlp/down/kernel", ("tp", None))]
FSDP = [(r"embedding|kernel", ("fsdp",))]
STRIDED = [(r"attn/w[qkv]/kernel", (None, None, "tp")),
           (r"attn/wo/kernel", (None, "tp", None)),
           (r"lm_head/kernel", (("dp", "tp"), None))]


def test_gpt_tree_validates_clean_in_both_packages():
    """The canonical table on gpt_tiny's flax tree, and on the port's
    model read in its flax view."""
    from horovod_tpu.models import transformer as jtr
    cfg = jtr.gpt_tiny(dtype=jnp.float32)
    tree = jax.eval_shape(lambda: jtr.TransformerLM(cfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    jrules, trules = _both(TP)
    jmesh = jbuild_mesh(dp=4, tp=2)
    model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                              device="cpu")
    assert jrules.validate(jmesh, tree) == []
    assert trules.validate(_port_mesh(dp=4, tp=2), model) == []
    # A dead rule and an unknown axis read the same in both.
    jrules, trules = _both(TP + [(r"decoder", ("model",))])
    want = jrules.validate(jmesh, tree)
    assert want and trules.validate(_port_mesh(dp=4, tp=2), model) == want


def _flax_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    model = ttr.TransformerLM(cfg, device="cpu")
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                              .astype(np.float32))
          for k, v in model.state_dict().items()}
    return model, sd, convert.params_to_flax(sd, cfg)


@pytest.mark.parametrize("sizes,table", [
    ({"dp": 2, "tp": 2}, TP), ({"fsdp": 4}, FSDP),
    ({"dp": 2, "tp": 2}, STRIDED)], ids=["dp2-tp2", "fsdp4", "strided"])
def test_chunks_are_the_flax_slices(sizes, table):
    """Each rank's chunk in the port's layout is, in the flax view, the
    numpy slice of the flax leaf the reference places on that device;
    the round trip through every rank's chunks is bitwise."""
    cfg = ttr.gpt_tiny(dtype=torch.float32)
    model, sd, flax_tree = _flax_params(cfg)
    jrules, trules = _both(table)
    jmesh = jbuild_mesh(**sizes, devices=jax.devices()[:4])
    placed = jshard_params(flax_tree, jmesh, jrules)
    devices = np.asarray(jmesh.devices).reshape(-1)
    full = {a: sizes.get(a, 1) for a in AXES}
    views = convert.leaf_views(model)
    chunks = []
    for rank in range(4):
        mine = convert.shard_state_dict(sd, trules, full, rank, model)
        chunks.append(mine)
        flax_chunks = tsh.shard_params(flax_tree, full, trules, rank=rank)
        for name, view in views.items():
            keys = view.path.split("/")
            arr, want_chunk = placed, flax_chunks
            for k in keys:
                arr, want_chunk = arr[k], want_chunk[k]
            shard = [s for s in arr.addressable_shards
                     if s.device == devices[rank]][0]
            want = np.asarray(shard.data)
            np.testing.assert_array_equal(want_chunk, want, name)
            got = view.to_flax(mine[name], want.shape)
            np.testing.assert_array_equal(got.numpy(), want, name)
    back = convert.unshard_state_dict(chunks, trules, full, model)
    for name, value in sd.items():
        assert torch.equal(back[name], value), name


def test_uneven_dims_and_unknown_axes_are_refused():
    cfg = ttr.gpt_tiny(dtype=torch.float32)
    model, sd, _ = _flax_params(cfg)
    # gpt_tiny has 4 heads: 8 ranks do not divide them.
    rules = tsh.ShardingRules([(r"attn/wq/kernel", (None, "tp", None))])
    with pytest.raises(ValueError, match="not divisible"):
        tsh.plan_sharding(model, {**dict.fromkeys(AXES, 1), "tp": 8}, rules)
    with pytest.raises(ValueError, match="not divisible"):
        tsh.shard_params({"w": np.zeros((3, 4))},
                         {**dict.fromkeys(AXES, 1), "tp": 2},
                         tsh.ShardingRules([("w", ("tp",))]), rank=0)
    mesh = _port_mesh(dp=2, tp=2)
    x = torch.zeros(4, 4)
    assert tsh.constrain(x, mesh, (None, "tp")) is x
    with pytest.raises(ValueError, match="absent"):
        tsh.constrain(x, mesh, ("model",))
    with pytest.raises(ValueError, match="more entries"):
        tsh.constrain(x, mesh, (None, None, "tp"))
    placement = tsh.named_sharding(mesh, ("dp", "tp"))
    assert placement.spec == tsh.P("dp", "tp") and placement.mesh is mesh
    assert tsh.replicated(mesh).spec == tsh.P()
    with pytest.raises(ValueError, match="absent"):
        tsh.named_sharding(mesh, ("model",))


def test_spec_tokens_match_the_reference():
    from horovod_tpu.analysis.hvdshard import specs as jspecs
    from horovod_tpu_torch.analysis.hvdshard import specs as tspecs
    for spec in (None, "(tp)", (), (None, "tp"), (("dp", "fsdp"), None),
                 tsh.P(None, ("dp", "tp"))):
        token = jspecs.spec_token(spec)
        assert tspecs.spec_token(spec) == token
        assert tspecs.token_axes(token) == jspecs.token_axes(token)
        assert tspecs.missing_axes(token, ("dp",)) \
            == jspecs.missing_axes(token, ("dp",))
    table = [(r"attn/wq", "(*,tp)"), (r"nothing", "(dp)"), (r"[bad", "*")]
    paths = ["attn/wq", "attn/wk", "mlp/up"]
    assert tspecs.rule_coverage(table, paths) \
        == jspecs.rule_coverage(table, paths)


def test_gspmd_quantized_wire_splits_and_statesync_refuses_the_state(
        tmp_path):
    """The reference quantizes whole gradients in its pure-GSPMD step, and
    so does the port: an int8 or uint4 wire there takes sharded leaves
    (gathered before the sync, cut after it).  The split is the model's
    (``apply_tensor_parallel``) and a later Trainer without rules clears
    it.  statesync's tree of such a state, in a 2-rank gloo world at
    tp=2: refused without ``gather=True``; with it, the whole tree
    (whose template a fresh unsharded state gives too), and
    ``load_train_state`` cuts it into a fresh sharded Trainer, whose
    tree is the same again and whose chunks are the first state's; a
    tree of other leaves or dtypes raises."""
    from horovod_tpu_torch import GradSyncConfig, Trainer
    for codec in ("int8", "uint4"):
        model = ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32),
                                  device="cpu")
        whole = model.layers[0].attn.wq.weight.shape
        mesh = _port_mesh(tp=2)
        mesh.groups["tp"] = None
        state = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                        mesh, sync=GradSyncConfig(axes=(), compression=codec),
                        param_rules=tsh.ShardingRules(TP)).init()
        assert model.layers[0].attn.wq.weight.shape \
            == (whole[0] // 2, whole[1])
        assert all(b.attn.split is not None and b.mlp.split is not None
                   for b in model.layers)
    Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
            _port_mesh())
    assert all(b.attn.split is None and b.mlp.split is None
               for b in model.layers)
    found = _statesync_round_trip_world(tmp_path, 2)
    assert found == {f"{codec}/{check}": True
                     for codec in ("int8", "uint4")
                     for check in ("refused", "templates", "round_trip",
                                   "chunks", "refuses_leaves",
                                   "refuses_dtype")}, found


def _statesync_round_trip_world(tmp_path, world: int) -> dict:
    """``tests/torch_sharding_worker.py statesync`` in a gloo world."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(here.parent), os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, str(here / "torch_sharding_worker.py"), "statesync",
         str(r), str(world), str(tmp_path / "store"),
         str(tmp_path / f"found{r}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    found = [json.loads((tmp_path / f"found{r}.json").read_text())
             for r in range(world)]
    assert all(f == found[0] for f in found), found
    return found[0]
