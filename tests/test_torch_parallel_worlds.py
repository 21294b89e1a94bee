"""Sequence, expert and pipeline parallelism of the port in gloo worlds of
2 and 4 ranks against the JAX package on 2- and 4-device CPU meshes built
in rank order.

One world a size runs every job of ``tests/torch_parallel_worker.py``,
one at a time, one compute thread a rank; the JAX side runs in this
process meanwhile.  Inputs come from a numpy seed.  Tolerances are the
JAX tests' own (``tests/test_attention.py``, ``tests/test_parallel.py``):

- ring and Ulysses attention at sp = n, causal and not: outputs within
  2e-5, the gradients of ``sum(out**2)`` within 5e-5;
- ``pipeline_apply`` at pp = n with 4 microbatches: outputs 1e-5/1e-6
  (rtol/atol), every stage's gradients 1e-4/1e-5;
- the MoE layer at ep = n, with capacity_factor = E (nothing dropped)
  and 0.5 (capacities bind): outputs 1e-4/1e-5, gradients 1e-3/1e-4
  (the parameters' summed over the ranks, which each hold every expert);
- the Trainer at 4 ranks, 3 AdamW steps of fp32 gpt_tiny from the JAX
  Trainer's initial parameters on the same global batch, each rank
  passing its shard: ring and Ulysses on dp=2 x sp=2 in manual mode
  (``batch_spec=("dp", "sp")``, sync over both), and MoE on dp=2 x ep=2
  in pure-GSPMD mode (``batch_spec=(("dp", "ep"),)``) with a capacity
  that binds, so that routing over other rows than the reference's
  would show, once more with every block checkpointed (``remat``), whose
  recompute must route over the same rows; and Ulysses on dp=2 x sp=2
  in pure-GSPMD mode (``batch_spec=("dp",)``: every sp rank holds the
  whole sequence); and dense, Ulysses and ring attention on dp=2 x sp=2
  in pure-GSPMD mode with the sequence sharded too (``batch_spec=("dp",
  "sp")``, against the JAX Trainer's ``P("dp", "sp")``): the ring and
  Ulysses models take their chunk as it is, the dense one gets the
  sequence gathered at the step's entry.
  Losses within 1e-5, and the parameters' updates as in
  ``tests/test_torch_training.py``; the input shape the MFU gauge counts
  is the global batch's in every case.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import training as jtrain
from horovod_tpu.common.jax_compat import shard_map
from horovod_tpu.models import transformer as jtr
from horovod_tpu.models.moe import MoEMLP as JMoE
from horovod_tpu.parallel import GradSyncConfig as JSync
from horovod_tpu.parallel.mesh import DEFAULT_AXES
from horovod_tpu.parallel.pipeline import pipeline_apply as jpipeline
from horovod_tpu.parallel.ring_attention import ring_attention as jring
from horovod_tpu.parallel.ulysses import ulysses_attention as julysses
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import transformer as ttr
from torch_world_lock import world_lock

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLDS = (2, 4)
ATTENTION = [(kind, causal) for kind in ("ring", "ulysses")
             for causal in (False, True)]
MOE_FACTORS = ("E", 0.5)
TRAINERS = {
    "ring-dp2xsp2": dict(model=dict(attention="ring"),
                         mesh={"dp": 2, "sp": 2},
                         sync=dict(axes=["dp", "sp"], op="average"),
                         batch_spec=["dp", "sp"]),
    "ulysses-dp2xsp2": dict(model=dict(attention="ulysses"),
                            mesh={"dp": 2, "sp": 2},
                            sync=dict(axes=["dp", "sp"], op="average"),
                            batch_spec=["dp", "sp"]),
    "ulysses-dp2xsp2-gspmd": dict(model=dict(attention="ulysses"),
                                  mesh={"dp": 2, "sp": 2},
                                  sync=dict(axes=[], op="average"),
                                  batch_spec=["dp"]),
    **{f"{kind}-dp2xsp2-gspmd-seq": dict(model=dict(attention=kind),
                                         mesh={"dp": 2, "sp": 2},
                                         sync=dict(axes=[], op="average"),
                                         batch_spec=["dp", "sp"])
       for kind in ("dense", "ulysses", "ring")},
    "moe-dp2xep2-gspmd": dict(model=dict(moe_experts=4,
                                         moe_capacity_factor=0.5),
                              mesh={"dp": 2, "ep": 2},
                              sync=dict(axes=[], op="average"),
                              batch_spec=[["dp", "ep"]]),
    "moe-dp2xep2-gspmd-remat": dict(model=dict(moe_experts=4,
                                               moe_capacity_factor=0.5,
                                               remat=True),
                                    mesh={"dp": 2, "ep": 2},
                                    sync=dict(axes=[], op="average"),
                                    batch_spec=[["dp", "ep"]]),
}
STEPS, LR, B, T = 3, 3e-4, 4, 16


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _jobs(world: int):
    """The jobs of a world and their inputs (``j/<name>`` arrays)."""
    rng = _rng(world)
    jobs, arrays = [], {}

    def add(job, **named):
        j = len(jobs)
        jobs.append(job)
        for name, value in named.items():
            arrays[f"{j}/{name}"] = value

    for kind, causal in ATTENTION:
        add(dict(kind=kind, causal=causal), q=_f32(rng, 2, 16, 4, 8),
            k=_f32(rng, 2, 16, 4, 8), v=_f32(rng, 2, 16, 4, 8))
    add(dict(kind="pipeline", microbatches=4),
        W=_f32(rng, world, 6, 6, scale=0.3), b=_f32(rng, world, 6,
                                                    scale=0.1),
        x=_f32(rng, 8, 6))
    for factor in MOE_FACTORS:
        e = 2 * world
        x = _f32(rng, 4 * world, 4, 6)
        params = JMoE(num_experts=e, d_ff=16).init(
            jax.random.key(world), jnp.asarray(x))["params"]
        add(dict(kind="moe", experts=e,
                 capacity_factor=float(e) if factor == "E" else factor),
            x=x, router=np.asarray(params["router"]["kernel"]),
            wi=np.asarray(params["wi"]), wo=np.asarray(params["wo"]))
    if world == 4:
        for name, spec in TRAINERS.items():
            tokens = rng.integers(0, 256, (B, T + 1))
            add(dict(kind="trainer", name=name, steps=STEPS, lr=LR, **spec),
                inputs=tokens[:, :-1], labels=tokens[:, 1:])
    return jobs, arrays


def _start_world(tmp_path, world: int, jobs, arrays):
    inputs = {"jobs": np.array(json.dumps(jobs)), **arrays}
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / "inputs.npz"),
         str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join_world(tmp_path, procs, timeout=180.0):
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(tmp_path / f"out{r}.npz"))
            for r in range(len(procs))]


def _mesh(shape: dict) -> Mesh:
    """A 6-axis CPU mesh with the devices in rank order."""
    sizes = [shape.get(a, 1) for a in DEFAULT_AXES]
    n = int(np.prod(sizes))
    return Mesh(np.array(jax.devices()[:n]).reshape(sizes), DEFAULT_AXES)


def _jax_attention(job, a, n):
    fn = jring if job["kind"] == "ring" else julysses
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    mapped = shard_map(partial(fn, axis="sp", causal=job["causal"],
                               axis_size=n),
                       mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                       out_specs=P(None, "sp"))
    qkv = [jnp.asarray(a[k]) for k in ("q", "k", "v")]
    out = jax.jit(mapped)(*qkv)
    grads = jax.jit(jax.grad(lambda *x: (mapped(*x) ** 2).sum(),
                             argnums=(0, 1, 2)))(*qkv)
    return {"out": np.asarray(out),
            **{f"d{k}": np.asarray(g) for k, g in zip("qkv", grads)}}


def _jax_pipeline(job, a, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))

    def stage(params, h):
        w, b = params
        return jnp.tanh(h @ w + b)

    def piped(ws, bs, x):
        return shard_map(
            lambda w, b, xx: jpipeline(stage, (w[0], b[0]), xx, axis="pp",
                                       num_microbatches=job["microbatches"],
                                       axis_size=n),
            mesh=mesh, in_specs=(P("pp"), P("pp"), P()), out_specs=P(),
            axis_names=frozenset({"pp"}), check_vma=False)(ws, bs, x)
    args = [jnp.asarray(a[k]) for k in ("W", "b", "x")]
    out = jax.jit(piped)(*args)
    grads = jax.jit(jax.grad(lambda *x: jnp.sum(piped(*x) ** 2),
                             argnums=(0, 1, 2)))(*args)
    return {"out": np.asarray(out),
            **{k: np.asarray(g) for k, g in zip(("dW", "db", "dx"), grads)}}


def _jax_moe(job, a, n):
    layer = JMoE(num_experts=job["experts"], d_ff=a["wi"].shape[-1],
                 capacity_factor=job["capacity_factor"],
                 ep_mesh=Mesh(np.array(jax.devices()[:n]), ("ep",)),
                 ep_axis="ep")
    variables = {"params": {"router": {"kernel": jnp.asarray(a["router"])},
                            "wi": jnp.asarray(a["wi"]),
                            "wo": jnp.asarray(a["wo"])}}
    x = jnp.asarray(a["x"])
    out = jax.jit(layer.apply)(variables, x)
    gv, gx = jax.jit(jax.grad(lambda v, xx: jnp.sum(layer.apply(v, xx) ** 2),
                              argnums=(0, 1)))(variables, x)
    g = gv["params"]
    return {"out": np.asarray(out), "dx": np.asarray(gx),
            "drouter": np.asarray(g["router"]["kernel"]),
            "dwi": np.asarray(g["wi"]), "dwo": np.asarray(g["wo"])}


def _jax_trainer(job):
    """The JAX Trainer built and initialised (its parameters go to the
    port's world), and a function running its steps."""
    mesh = _mesh(job["mesh"])
    cfg = jtr.gpt_tiny(dtype=jnp.float32, mesh=mesh, **job["model"])
    spec = P(*[tuple(e) if isinstance(e, list) else e
               for e in job["batch_spec"]])
    trainer = jtrain.Trainer(
        jtr.TransformerLM(cfg), optax.adamw(job["lr"]), mesh,
        sync=JSync(axes=tuple(job["sync"]["axes"]), op=job["sync"]["op"]),
        batch_spec=spec)
    return trainer


def _run_jax_trainer(trainer, state, a):
    batch = {"input": jnp.asarray(a["inputs"], jnp.int32),
             "label": jnp.asarray(a["labels"], jnp.int32)}
    losses = []
    for _ in range(STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    return {"losses": np.array(losses),
            "params": jax.tree_util.tree_map(np.asarray, state.params)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's jobs, inputs, per-rank outputs and JAX references."""
    out = {}
    for world in WORLDS:
        jobs, arrays = _jobs(world)
        trainers = {}
        for j, job in enumerate(jobs):
            if job["kind"] == "trainer":
                trainer = _jax_trainer(job)
                tokens = jnp.asarray(arrays[f"{j}/inputs"], jnp.int32)
                state = trainer.init(jax.random.key(j), {"input": tokens})
                params0 = jax.tree_util.tree_map(np.asarray, state.params)
                tcfg = ttr.gpt_tiny(**job["model"])
                for name, v in convert.params_from_flax(params0,
                                                        tcfg).items():
                    arrays[f"{j}/state/{name}"] = v.numpy()
                trainers[j] = (trainer, state, params0)
        tmp = tmp_path_factory.mktemp(f"world{world}")
        with world_lock(world):
            procs = _start_world(tmp, world, jobs, arrays)
            refs = {}
            try:
                for j, job in enumerate(jobs):
                    a = {k.split("/", 1)[1]: v for k, v in arrays.items()
                         if k.startswith(f"{j}/")}
                    kind = job["kind"]
                    if kind in ("ring", "ulysses"):
                        refs[j] = _jax_attention(job, a, world)
                    elif kind == "pipeline":
                        refs[j] = _jax_pipeline(job, a, world)
                    elif kind == "moe":
                        refs[j] = _jax_moe(job, a, world)
                    else:
                        trainer, state, params0 = trainers[j]
                        refs[j] = {**_run_jax_trainer(trainer, state, a),
                                   "params0": params0}
            finally:
                results = _join_world(tmp, procs)
        out[world] = (jobs, arrays, results, refs)
    return out


def _find(worlds, world, **match):
    jobs, arrays, results, refs = worlds[world]
    for j, job in enumerate(jobs):
        if all(job.get(k) == v for k, v in match.items()):
            return j, job, results, refs[j]
    raise KeyError(match)


def _ranks(results, j, name):
    return [r[f"{j}/{name}"] for r in results]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind,causal", ATTENTION)
def test_sequence_parallel_attention_matches_jax(worlds, world, kind,
                                                 causal):
    j, _, results, ref = _find(worlds, world, kind=kind, causal=causal)
    for name, tol in (("out", 2e-5), ("dq", 5e-5), ("dk", 5e-5),
                      ("dv", 5e-5)):
        got = np.concatenate(_ranks(results, j, name), axis=1)
        np.testing.assert_allclose(got, ref[name], atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_jax(worlds, world):
    j, _, results, ref = _find(worlds, world, kind="pipeline")
    for out in _ranks(results, j, "out"):       # replicated on every stage
        np.testing.assert_allclose(out, ref["out"], rtol=1e-5, atol=1e-6)
    for name in ("dW", "db"):
        np.testing.assert_allclose(np.stack(_ranks(results, j, name)),
                                   ref[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(sum(_ranks(results, j, "dx")), ref["dx"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("factor", MOE_FACTORS)
def test_expert_parallel_moe_matches_jax(worlds, world, factor):
    e = 2 * world
    cf = float(e) if factor == "E" else factor
    j, _, results, ref = _find(worlds, world, kind="moe",
                               capacity_factor=cf)
    for name in ("out", "dx"):
        got = np.concatenate(_ranks(results, j, name))
        tol = (1e-4, 1e-5) if name == "out" else (1e-3, 1e-4)
        np.testing.assert_allclose(got, ref[name], rtol=tol[0],
                                   atol=tol[1], err_msg=name)
    for name in ("drouter", "dwi", "dwo"):
        np.testing.assert_allclose(sum(_ranks(results, j, name)), ref[name],
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    if factor != "E":
        # The capacity binds: some token's output is dropped to zero.
        assert (np.abs(ref["out"]).sum(-1) == 0).any()


@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_over_mesh_matches_jax(worlds, name):
    j, job, results, ref = _find(worlds, 4, kind="trainer", name=name)
    tcfg = ttr.gpt_tiny(**job["model"])
    for r in results:
        np.testing.assert_allclose(r[f"{j}/losses"], ref["losses"],
                                   rtol=1e-5, atol=1e-5)
        assert r[f"{j}/mesh_shape"].tolist() == [B, T]
    assert ref["losses"][-1] < ref["losses"][0]
    # Every rank ends with the same parameters.
    prefix = f"{j}/state/"
    for r in results[1:]:
        for k in r:
            if k.startswith(prefix):
                np.testing.assert_array_equal(r[k], results[0][k], k)
    final = convert.params_to_flax(
        {k[len(prefix):]: torch.from_numpy(v)
         for k, v in results[0].items() if k.startswith(prefix)}, tcfg)
    # As in tests/test_torch_training.py: AdamW moves each weight by about
    # lr a step; compare the updates, almost all to 1% or a few ulps of
    # the weight, none by more than 2 lr.
    jflat = jax.tree_util.tree_leaves_with_path(ref["params"])
    tflat = jax.tree_util.tree_leaves(final)
    p0 = jax.tree_util.tree_leaves(ref["params0"])
    for (path, jv), tv, start in zip(jflat, tflat, p0):
        label = jax.tree_util.keystr(path)
        dj, dt = jv - start, tv - start
        assert np.abs(dt - dj).max() <= 2 * LR * STEPS, label
        close = np.abs(dt - dj) <= 1e-2 * np.abs(dj) \
            + 4 * np.spacing(np.abs(start))
        assert close.mean() > 0.99, (label, close.mean())
