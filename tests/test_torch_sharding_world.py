"""Sharded parameters of the port in one gloo world of 4 ranks against the
JAX ``Trainer`` with the same rule tables on 4 of the 8 CPU devices.

The world (``tests/torch_sharding_worker.py``) starts once and runs every
configuration in sequence, one compute thread a rank; the JAX side runs
in this process meanwhile.  fp32, 2 steps, weights and batches from a
numpy seed (gpt_tiny's from the JAX Trainer's own init).  The
configurations (each evaluated with ``eval_step`` after its steps):

- ``tp-manual``: gpt_tiny, manual ``dp=2, tp=2``, the canonical
  tensor-parallel table (attention heads and MLP columns over ``tp``);
- ``tp-gspmd``: gpt_tiny, pure-GSPMD ``tp=4``: the layers compute on
  their chunks (dense attention on both sides), with SGD(0.1, 0.9),
  whose steps show a gradient's scale (AdamW's hide it);
- ``tp-gspmd-flash``: the same with flash attention: the reference's
  Pallas kernels interpreted (which its GSPMD step partitions on the
  CPU) against the port's flash wrappers, which run their plain
  versions on CPU tensors;
- ``fsdp-manual``: gpt_tiny, manual ``fsdp=4``, every kernel and the
  embedding sharded on dim 0;
- ``moe-gspmd``: MoE gpt_tiny (4 experts, a capacity that binds),
  pure-GSPMD ``dp=2 x ep=2``, the experts held over ``ep``;
- ``resnet-head``: the small ResNet with the reference's head table
  (``test_trainer_tp_sharded_head``) at manual ``dp=2, tp=2``, SGD;
- ``fsdp-ckpt``: gpt_tiny at manual ``dp=2 x fsdp=2`` (port only);
- ``knobs-*`` (port only): the manual step's other sync knobs with
  sharded leaves: the int8 wire with loss scaling and a clip that binds
  and the hierarchical fp16 reduction (fsdp), the optimizer-in-ring and
  Adasum (tp).  ``tp-gspmd`` clips too: its chunks' squares are summed
  over tp;
- ``gspmd-int8`` (port only): the MoE leg's table and an ``lm_head``
  sharded over ``dp`` (gathered at use) in the pure-GSPMD step with the
  int8 wire, loss scaling and a clip, whose blocks run over whole
  leaves.  The reference's pure-GSPMD step raises with a quantized wire,
  with rules or without (``compress/jax_ops.dequantize_rows`` indexes
  the scales of an exchange over no axis), so this leg is held to the
  port's unsharded run.

The states of ``tp-manual`` and ``fsdp-ckpt`` are checkpointed and
restored at ``dp=4`` and resharded onto the other leg's layout, and
``tp-manual``'s Trainer runs ``fit`` under ``BestModelCheckpoint``.  The
world runs under ``HOROVOD_METRICS=on``, and each leg's MFU gauges count
the batch the whole mesh consumes over the peak of its four ranks.

Limits: losses within 1e-5 relative and the gathered parameters within
1e-5 max abs of the JAX run's (under AdamW on all but isolated elements,
at most one in a thousand, where the update's normalisation amplifies
round-off, and those within 2 lr a step); in the manual legs and the MoE
legs the sharded run equals the port's own run without rules on the same
mesh bit for bit (the tp split within the same 1e-5); every rank holds
exactly the chunk bytes that JAX's ``NamedSharding.shard_shape`` reckons
for its parameters, and the optimizer's moments mirror them (two a
parameter for AdamW, one for SGD's momentum; the reference lays its
moments out by shape, so that gpt_tiny's ``lm_head`` moments take the
``mlp/gate`` spec of the same shape, and its own bytes are not the
reckoning); a checkpoint of a sharded state has the unsharded state's
digest and restores bitwise.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from horovod_tpu import training as jtrain
from horovod_tpu.models import resnet as jres
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import GradSyncConfig as JSync
from horovod_tpu.parallel import MeshSpec as JMeshSpec
from horovod_tpu.parallel import ShardingRules as JRules
from horovod_tpu.parallel import build_mesh as jbuild_mesh
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.parallel.sharding import ShardingRules
from horovod_tpu_torch.telemetry import perfmodel as tperf
from torch_cnn_util import random_variables

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_sharding_worker.py"
WORLD, STEPS, LR, B, T = 4, 2, 3e-4, 4, 16
TOL = 1e-5

TP = [[r"attn/w[qkv]/kernel", [None, "tp", None]],
      [r"attn/wo/kernel", ["tp", None, None]],
      [r"mlp/(gate|up)/kernel", [None, "tp"]],
      [r"mlp/down/kernel", ["tp", None]]]
FSDP = [[r"embedding|kernel", ["fsdp"]]]
EXPERTS = [[r"moe/w[io]$", ["ep"]]]
HEAD = [[r"head/kernel", [None, "tp"]], [r"head/bias", ["tp"]]]
# gather_params' round trip: chunks over D (strided in the port's
# layout) and over two axes at once.
GATHER = [[r"attn/w[qkv]/kernel", [None, None, "tp"]],
          [r"lm_head/kernel", [["dp", "tp"], None]],
          [r"mlp/down/kernel", ["tp", "dp"]]]

LEGS = {
    "tp-manual": dict(model="gpt", mesh={"dp": 2, "tp": 2},
                      sync={"axes": ["dp"]}, batch_spec=["dp"], rules=TP,
                      twin=True, fit_ckpt=True,
                      ckpt_reshard={"mesh": {"fsdp": 4},
                                    "sync": {"axes": ["fsdp"]},
                                    "rules": FSDP}),
    "tp-gspmd": dict(model="gpt", mesh={"tp": 4},
                     sync={"axes": [], "clip_global_norm": 0.05},
                     batch_spec=["dp"], rules=TP, twin=True, opt="sgd"),
    "tp-gspmd-flash": dict(model="gpt", model_kw={"attention": "flash"},
                           jax_kw={"flash_interpret": True, "block_q": 16,
                                   "block_k": 16},
                           mesh={"tp": 4}, sync={"axes": []},
                           batch_spec=["dp"], rules=TP),
    "fsdp-manual": dict(model="gpt", mesh={"fsdp": 4},
                        sync={"axes": ["fsdp"]}, batch_spec=["fsdp"],
                        rules=FSDP, twin=True),
    "moe-gspmd": dict(model="gpt",
                      model_kw={"moe_experts": 4,
                                "moe_capacity_factor": 0.5},
                      mesh={"dp": 2, "ep": 2}, sync={"axes": []},
                      batch_spec=[["dp", "ep"]], rules=EXPERTS, twin=True),
    "resnet-head": dict(model="resnet", mesh={"dp": 2, "tp": 2},
                        sync={"axes": ["dp"]}, batch_spec=["dp"],
                        rules=HEAD, twin=True),
    "fsdp-ckpt": dict(model="gpt", mesh={"dp": 2, "fsdp": 2},
                      sync={"axes": ["dp", "fsdp"]},
                      batch_spec=[["dp", "fsdp"]], rules=FSDP, twin=True,
                      ckpt_reshard={"mesh": {"dp": 2, "tp": 2},
                                    "sync": {"axes": ["dp"]},
                                    "rules": TP}),
    # The manual step's other sync knobs, against the twin only.
    "knobs-int8": dict(model="gpt", mesh={"dp": 2, "fsdp": 2},
                       sync={"axes": ["dp", "fsdp"], "compression": "int8",
                             "loss_scale": 4.0, "clip_global_norm": 0.05},
                       batch_spec=[["dp", "fsdp"]], rules=FSDP, twin=True),
    "knobs-hierarchical": dict(model="gpt", mesh={"dp": 2, "fsdp": 2},
                               sync={"axes": ["dp", "fsdp"],
                                     "compression": "fp16",
                                     "hierarchical": True},
                               batch_spec=[["dp", "fsdp"]], rules=FSDP,
                               twin=True),
    "knobs-ring": dict(model="gpt", mesh={"dp": 2, "tp": 2},
                       sync={"axes": ["dp"], "compression": "bf16",
                             "optimizer_in_ring": True},
                       batch_spec=["dp"], rules=TP, twin=True),
    "knobs-adasum": dict(model="gpt", mesh={"dp": 2, "tp": 2},
                         sync={"axes": ["dp"], "op": "adasum",
                               "compression": "bf16"},
                         batch_spec=["dp"], rules=TP, twin=True),
    # The pure-GSPMD step's int8 wire over whole leaves: the experts held
    # over ep and an lm_head gathered at use over dp.
    "gspmd-int8": dict(model="gpt",
                       model_kw={"moe_experts": 4,
                                 "moe_capacity_factor": 0.5},
                       mesh={"dp": 2, "ep": 2},
                       sync={"axes": [], "compression": "int8",
                             "loss_scale": 4.0, "clip_global_norm": 0.05},
                       batch_spec=[["dp", "ep"]],
                       rules=EXPERTS + [[r"lm_head/kernel", [None, "dp"]]],
                       twin=True),
}
KNOBS = ("knobs-int8", "knobs-hierarchical", "knobs-ring", "knobs-adasum")
MANUAL = ("tp-manual", "fsdp-manual", "resnet-head", "fsdp-ckpt", *KNOBS)
WITH_JAX = ("tp-manual", "tp-gspmd", "tp-gspmd-flash", "fsdp-manual",
            "moe-gspmd", "resnet-head")


def _jspec(entries):
    return JP(*[tuple(e) if isinstance(e, list) else e for e in entries])


def _jrules(rules):
    return JRules([(pat, _jspec(spec)) for pat, spec in rules])


def _jmesh(shape):
    return jbuild_mesh(JMeshSpec(**{"dp": 1, **shape}),
                       devices=jax.devices()[:WORLD])


def _flax_resnet():
    return jres.ResNet(stage_sizes=(1, 1), block_cls=jres.BottleneckBlock,
                       num_filters=8, num_classes=10, dtype=jnp.float32)


def _port_model(leg):
    job = LEGS[leg]
    if job["model"] == "resnet":
        return tres.ResNet((1, 1), tres.BottleneckBlock, num_filters=8,
                           num_classes=10, dtype=torch.float32, device="cpu")
    return ttr.TransformerLM(ttr.gpt_tiny(dtype=torch.float32,
                                          **job.get("model_kw", {})),
                             device="cpu")


def _jax_trainer(leg, j, arrays):
    """The JAX Trainer of a leg and its initial state; the initial state
    dict goes to the port's world in ``arrays``."""
    job = LEGS[leg]
    mesh = _jmesh(job["mesh"])
    sync = JSync(**{"op": "average", **job["sync"],
                    "axes": tuple(job["sync"]["axes"])})
    spec = _jspec(job["batch_spec"])
    rules = _jrules(job["rules"])
    tx = optax.sgd(0.1, momentum=0.9) if _opt(leg) == "sgd" \
        else optax.adamw(LR)
    if job["model"] == "resnet":
        flax_model = _flax_resnet()
        trainer = jtrain.Trainer(flax_model, tx,
                                 mesh, sync=sync, batch_spec=spec,
                                 param_rules=rules)
        images = arrays[f"{j}/images"]
        variables = random_variables(flax_model, images.shape, seed=j)
        state = trainer.init(jax.random.key(j),
                             {"image": jnp.asarray(images)})
        # The drawn weights, placed as init placed its own.
        params = jax.tree_util.tree_map(
            lambda v, leaf: jax.device_put(jnp.asarray(v), leaf.sharding),
            variables["params"], state.params)
        state = dataclasses.replace(
            state, params=params, opt_state=trainer._init_opt_state(params),
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]))
        sd = convert.cnn_params_from_flax(variables["params"],
                                          variables["batch_stats"],
                                          _port_model(leg))
    else:
        cfg = jtr.gpt_tiny(dtype=jnp.float32, mesh=mesh,
                           **job.get("model_kw", {}),
                           **job.get("jax_kw", {}))
        trainer = jtrain.Trainer(jtr.TransformerLM(cfg), tx, mesh,
                                 sync=sync, batch_spec=spec,
                                 param_rules=rules)
        state = trainer.init(jax.random.key(j), {
            "input": jnp.asarray(arrays[f"{j}/inputs"], jnp.int32)})
        sd = convert.params_from_flax(
            jax.tree_util.tree_map(np.asarray, state.params),
            ttr.gpt_tiny(**job.get("model_kw", {})))
    for name, v in sd.items():
        arrays[f"{j}/state/{name}"] = v.numpy()
    return trainer, state


def _run_jax(leg, j, trainer, state, arrays):
    job = LEGS[leg]
    if job["model"] == "resnet":
        batch = {"image": jnp.asarray(arrays[f"{j}/images"]),
                 "label": jnp.asarray(arrays[f"{j}/labels"], jnp.int32)}
    else:
        batch = {"input": jnp.asarray(arrays[f"{j}/inputs"], jnp.int32),
                 "label": jnp.asarray(arrays[f"{j}/labels"], jnp.int32)}
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    param_bytes = sum(_chunk_bytes(leaf)
                      for leaf in jax.tree_util.tree_leaves(state.params))
    moments = 1 if _opt(leg) == "sgd" else 2
    losses = []
    for _ in range(STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    losses.append(float(trainer.eval_step(state, batch)["loss"]))
    return {"losses": np.array(losses), "params0": params0,
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "bytes": [param_bytes, moments * param_bytes]}


def _opt(leg) -> str:
    spec = LEGS[leg]
    return spec.get("opt", "sgd" if spec["model"] == "resnet" else "adamw")


def _chunk_bytes(leaf) -> int:
    """One device's bytes of a placed array, reckoned by JAX."""
    sharding = leaf.sharding
    shape = sharding.shard_shape(leaf.shape) \
        if isinstance(sharding, NamedSharding) else leaf.shape
    return int(np.prod(shape)) * leaf.dtype.itemsize


def _jobs(tmp_path):
    rng = np.random.default_rng(17)
    jobs, arrays = [], {}
    for j, (leg, spec) in enumerate(LEGS.items()):
        job = {"kind": "trainer", "name": leg, "steps": STEPS,
               **spec, "opt": _opt(leg)}
        job["lr"] = 0.1 if job["opt"] == "sgd" else LR
        if spec["model"] == "resnet":
            arrays[f"{j}/images"] = rng.standard_normal(
                (8, 16, 16, 3)).astype(np.float32)
            arrays[f"{j}/labels"] = rng.integers(0, 10, 8)
        else:
            tokens = rng.integers(0, 256, (B, T + 1))
            arrays[f"{j}/inputs"] = tokens[:, :-1]
            arrays[f"{j}/labels"] = tokens[:, 1:]
        if "ckpt_reshard" in spec:
            job["ckpt"] = str(tmp_path / f"ckpt{j}")
        if spec.get("fit_ckpt"):
            job["fit_ckpt"] = str(tmp_path / f"fit{j}")
        jobs.append(job)
    return jobs, arrays


def _start(tmp_path, jobs, arrays):
    np.savez(tmp_path / "inputs.npz", jobs=np.array(json.dumps(jobs)),
             gather_rules=np.array(json.dumps(GATHER)), **arrays)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               HOROVOD_METRICS="on")
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD),
         str(tmp_path / "store"), str(tmp_path / "inputs.npz"),
         str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every leg's job, the ranks' outputs and the JAX references."""
    tmp = tmp_path_factory.mktemp("shardworld")
    jobs, arrays = _jobs(tmp)
    trainers = {j: _jax_trainer(job["name"], j, arrays)
                for j, job in enumerate(jobs) if job["name"] in WITH_JAX}
    for j, job in enumerate(jobs):
        if job["name"] not in WITH_JAX:       # the port's own init
            for name, v in _port_model(job["name"]).state_dict().items():
                arrays[f"{j}/state/{name}"] = v.numpy()
    procs = _start(tmp, jobs, arrays)
    refs = {}
    try:
        for j, (trainer, state) in trainers.items():
            refs[j] = _run_jax(jobs[j]["name"], j, trainer, state, arrays)
    finally:
        try:
            logs = [p.communicate(timeout=240)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    results = [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]
    return jobs, results, refs


def _leg(world, leg):
    jobs, results, refs = world
    j = [job["name"] for job in jobs].index(leg)
    return j, jobs[j], results, refs.get(j)


def _gathered(leg, j, results, prefix="state/"):
    """The whole state dict from every rank's chunks."""
    job = LEGS[leg]
    chunks = [{k[len(f"{j}/{prefix}"):]: torch.from_numpy(v)
               for k, v in r.items() if k.startswith(f"{j}/{prefix}")}
              for r in results]
    sizes = {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1,
             **job["mesh"]}
    return convert.unshard_state_dict(
        chunks, ShardingRules([(p, tuple(tuple(e) if isinstance(e, list)
                                         else e for e in s))
                               for p, s in job["rules"]]), sizes,
        _port_model(leg))


def _to_flax(leg, state_dict):
    if LEGS[leg]["model"] == "resnet":
        return convert.cnn_params_to_flax(state_dict)[0]
    return convert.params_to_flax(
        state_dict, ttr.gpt_tiny(**LEGS[leg].get("model_kw", {})))


@pytest.mark.parametrize("leg", WITH_JAX)
def test_sharded_leg_matches_jax(world, leg):
    j, _, results, ref = _leg(world, leg)
    for r in results:
        np.testing.assert_allclose(r[f"{j}/losses"], ref["losses"],
                                   rtol=TOL, atol=0)
    got = _to_flax(leg, _gathered(leg, j, results))
    want = dict(jax.tree_util.tree_leaves_with_path(ref["params"]))
    start = dict(jax.tree_util.tree_leaves_with_path(ref["params0"]))
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat.keys() == want.keys()
    adamw = _opt(leg) == "adamw"
    moved = 0.0
    for path, w in want.items():
        label = jax.tree_util.keystr(path)
        err = np.abs(np.asarray(flat[path]) - w)
        if adamw:
            # AdamW divides each update by the gradient's own magnitude:
            # where a gradient is round-off of a cancellation, the two
            # packages' round-off moves the update by a few % of lr.  Such
            # elements are isolated (one in 16384 in this world), and the
            # port's sharded run is its unsharded run bit for bit.
            assert (err > TOL).mean() <= 1e-3, (label, err.max())
            assert err.max() <= 2 * LR * STEPS, (label, err.max())
        else:
            assert err.max() <= TOL, (label, err.max())
        moved = max(moved, np.abs(w - start[path]).max())
    assert moved > 10 * TOL           # the steps moved the weights


@pytest.mark.parametrize("leg", MANUAL)
def test_manual_leg_is_the_unsharded_run_bitwise(world, leg):
    j, _, results, _ = _leg(world, leg)
    whole = _gathered(leg, j, results)
    for r in results:
        np.testing.assert_array_equal(r[f"{j}/losses"],
                                      r[f"{j}/plain/losses"])
        for name, value in whole.items():
            np.testing.assert_array_equal(
                value.numpy(), r[f"{j}/plain/state/{name}"], err_msg=name)


def test_gspmd_tp_leg_is_close_to_the_unsharded_run(world):
    """The split sums each layer's partial products over tp: another
    order than the whole matmul's, so close, not bitwise."""
    j, _, results, _ = _leg(world, "tp-gspmd")
    whole = _gathered("tp-gspmd", j, results)
    for r in results:
        np.testing.assert_allclose(r[f"{j}/losses"], r[f"{j}/plain/losses"],
                                   rtol=TOL, atol=0)
        for name, value in whole.items():
            np.testing.assert_allclose(value.numpy(),
                                       r[f"{j}/plain/state/{name}"],
                                       rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("leg", ("moe-gspmd", "gspmd-int8"))
def test_gspmd_moe_leg_is_the_unsharded_run_bitwise(world, leg):
    """An expert's gradient is the same sum over the ranks that route to
    it, divided by the same rank count: the held experts step as the
    replicated ones do, bit for bit.  With the int8 wire each chunk's
    gradient is gathered whole for the codec, whose blocks are then the
    unsharded run's."""
    j, _, results, _ = _leg(world, leg)
    whole = _gathered(leg, j, results)
    for r in results:
        np.testing.assert_array_equal(r[f"{j}/losses"],
                                      r[f"{j}/plain/losses"])
        for name, value in whole.items():
            np.testing.assert_array_equal(
                value.numpy(), r[f"{j}/plain/state/{name}"], err_msg=name)


@pytest.mark.parametrize("leg", WITH_JAX)
def test_each_rank_holds_the_reckoned_chunk_bytes(world, leg):
    j, _, results, ref = _leg(world, leg)
    for r in results:
        assert r[f"{j}/bytes"].tolist() == ref["bytes"]
    # Something is sharded: less than the whole parameters a rank.
    whole = sum(p.numel() * 4 for p in _port_model(leg).parameters())
    assert ref["bytes"][0] < whole


@pytest.mark.parametrize("leg", ("tp-manual", "fsdp-ckpt"))
def test_sharded_checkpoint_restores_into_other_meshes(world, leg):
    j, _, results, _ = _leg(world, leg)
    for r in results:
        flags = {k.split("/", 2)[2]: int(v) for k, v in r.items()
                 if k.startswith(f"{j}/ckpt/")}
        assert flags == {"same_digest": 1, "restore_dp4": 1,
                         "restore_resharded": 1, "resharded_tree": 1}


def test_fit_saves_a_sharded_state_on_every_rank(world):
    """``Trainer.fit`` with the tp table under ``BestModelCheckpoint``
    finishes (every rank takes part in the sharded state's gather) and
    its checkpoint restores at ``dp=4`` bit for bit."""
    j, _, results, _ = _leg(world, "tp-manual")
    for r in results:
        assert int(r[f"{j}/fit/improved"]) == 1
        assert int(r[f"{j}/fit/restored"]) == 1


def test_gather_params_inverts_shard_params(world):
    _, results, _ = world
    assert [int(r["gather/roundtrip"]) for r in results] == [1] * WORLD


def _mesh_batch_flops(leg) -> float:
    """The FLOPs of one step on the leg's whole global batch."""
    if LEGS[leg]["model"] == "resnet":
        return 3.0 * 8 * tperf.resnet_forward_flops((1, 1), True, 8, 16)
    return tperf.transformer_train_flops(
        ttr.gpt_tiny(**LEGS[leg].get("model_kw", {})), B, T)


@pytest.mark.parametrize("leg", ("tp-manual", "tp-gspmd", "tp-gspmd-flash",
                                 "fsdp-manual", "moe-gspmd", "resnet-head"))
def test_mfu_gauges_count_the_mesh_batch(world, leg):
    """``horovod_train_step_flops`` is the count of the global batch on
    every rank, whether tp repeats it (tp-gspmd: B rows a rank), dp splits
    it (dp x tp: B/2) or fsdp or dp x ep do (B/4); the peak is one CPU's
    nominal 1e12 times the mesh's 4 ranks, and the MFU gauge is the count
    over the step time it was read from and that peak."""
    j, _, results, _ = _leg(world, leg)
    want = _mesh_batch_flops(leg)
    for r in results:
        flops, peak, mfu, step_ms = r[f"{j}/perf"]
        assert flops == want
        assert peak == tperf.NOMINAL_PEAK_FLOPS * WORLD
        assert step_ms > 0.0
        assert mfu == pytest.approx(flops / (step_ms / 1e3) / peak,
                                    rel=1e-9)
