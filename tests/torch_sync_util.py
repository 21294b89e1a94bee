"""Helpers of the gradient-sync parity tests: a gloo world running
``tests/torch_sync_worker.py``, the JAX package's sync on a CPU mesh, the
flax trees of the test models' gradients, and the tolerance of the
quantized codecs."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.common.jax_compat import shard_map
from horovod_tpu.parallel import grad_sync as jsync

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_sync_worker.py"


def run_gloo_world(tmp_path, world: int, sets: dict, jobs: list,
                   timeout: float = 180) -> list:
    """Run ``jobs`` in a ``world``-rank gloo world.  ``sets`` maps a set
    name to ``{"names": [...], "ranks": [{name: array}] * world}`` and,
    optionally, ``"params": {name: array}``.  Returns each rank's
    outputs (``np.load`` of its npz)."""
    inputs = {"jobs": np.array(json.dumps(jobs)),
              "sets": np.array(json.dumps(
                  {s: v["names"] for s, v in sets.items()}))}
    for s, v in sets.items():
        for r, grads in enumerate(v["ranks"]):
            for n in v["names"]:
                inputs[f"{s}/{r}/{n}"] = grads[n]
        for n, p in v.get("params", {}).items():
            inputs[f"{s}/p/{n}"] = p
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # One compute thread a rank: the worlds share the host's cores.
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / "inputs.npz"),
         str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [np.load(tmp_path / f"out{r}.npz") for r in range(world)]


def jax_mesh(shape: dict) -> tuple[Mesh, tuple[str, ...]]:
    """A CPU mesh over the axes of ``shape`` (row-major devices)."""
    axes = tuple(shape)
    n = int(np.prod(list(shape.values())))
    devices = np.array(jax.devices()[:n]).reshape(tuple(shape.values()))
    return Mesh(devices, axes), axes


def stack(per_rank: list):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(
        [jnp.asarray(x) for x in xs]), *per_rank)


def unstack(tree, world: int) -> list:
    return [jax.tree_util.tree_map(lambda x: np.asarray(x)[r], tree)
            for r in range(world)]


def jax_sync(per_rank: list, shape: dict, **kwargs) -> list:
    """The reference's ``sync_gradients`` on a CPU mesh of ``shape``, on
    rank r's tree ``per_rank[r]`` (rank r is the stacked input's slice
    r); each rank's result."""
    mesh, axes = jax_mesh(shape)
    cfg = jsync.GradSyncConfig(axes=axes, **kwargs)
    out = jax.jit(shard_map(
        lambda g: jsync.sync_gradients(g, cfg), mesh=mesh,
        in_specs=P(axes), out_specs=P(axes), check_vma=False))(
            stack(per_rank))
    return unstack(out, len(per_rank))


def jax_sync_ef(steps: list, shape: dict, **kwargs) -> list:
    """``sync_gradients_ef`` over the steps (each a per-rank list of
    trees), residuals from ``init_error_feedback``: a list over steps of
    (per-rank synced, per-rank residuals)."""
    mesh, axes = jax_mesh(shape)
    cfg = jsync.GradSyncConfig(axes=axes, **kwargs)

    def run(*gs):
        res = jsync.init_error_feedback(gs[0])
        outs = []
        for g in gs:
            synced, res = jsync.sync_gradients_ef(g, res, cfg)
            outs.append((synced, res))
        return tuple(outs)
    world = len(steps[0])
    out = jax.jit(shard_map(
        run, mesh=mesh, in_specs=tuple(P(axes) for _ in steps),
        out_specs=P(axes), check_vma=False))(*[stack(s) for s in steps])
    return [(unstack(g, world), unstack(r, world)) for g, r in out]


def jax_ring(tx, steps: list, params, shape: dict, **kwargs) -> list:
    """The reference's ``sync_and_apply`` over the steps from ``params``:
    the parameters after each step (the same on every rank)."""
    mesh, axes = jax_mesh(shape)
    cfg = jsync.GradSyncConfig(axes=axes, optimizer_in_ring=True, **kwargs)
    world = len(steps[0])

    def run(params, *gs):
        state = jsync.init_ring_optimizer_state(tx, params, world, cfg)
        outs = []
        for g in gs:
            params, state = jsync.sync_and_apply(tx, g, params, state, cfg)
            outs.append(params)
        return tuple(outs)
    out = jax.jit(shard_map(
        run, mesh=mesh, in_specs=(P(),) + tuple(P(axes) for _ in steps),
        out_specs=P(), check_vma=False))(
            jax.tree_util.tree_map(jnp.asarray, params),
            *[stack(s) for s in steps])
    return [jax.tree_util.tree_map(np.asarray, p) for p in out]


def random_tree(shapes, seed: int, scale: float = 2.0):
    """A tree of normal fp32 arrays of the shapes in ``shapes`` (a tree of
    objects with ``.shape``)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (scale * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def _bucket_blocks(tree, threshold: int, block_size: int, world: int):
    """``tree``'s leaves (flatten order) bucketed at ``threshold`` wire
    bytes (1 an element) and cut as ``quantized_allreduce`` cuts a bucket:
    yields (member leaf indices, leaves, the bucket padded to world x chunk
    as [blocks, block_size] fp32, its unpadded length)."""
    leaves = [np.asarray(x, np.float32) for x in
              jax.tree_util.tree_leaves(tree)]
    for bucket in jsync._bucketize(leaves, threshold, 1):
        flat = np.concatenate([leaves[i].reshape(-1) for i in bucket])
        n = flat.size
        chunk = -(-n // world)
        chunk = -(-chunk // block_size) * block_size
        yield bucket, leaves, np.pad(flat, (0, chunk * world - n)).reshape(
            -1, block_size), n


def _per_element(out, bucket, leaves, values, n):
    """Scatter per-element ``values`` ([k, blocks*block_size]) of one
    bucket back onto its leaves."""
    offset = 0
    for i in bucket:
        k = leaves[i].size
        out[i] = values[:, offset:offset + k].reshape(
            (values.shape[0],) + leaves[i].shape)
        offset += k


def _scales(blocks, levels):
    lo, hi = blocks.min(1), blocks.max(1)
    return lo, np.where(hi > lo, (hi - lo) / np.float32(levels - 1),
                        np.float32(1.0)).astype(np.float32)


def block_levels(tree, threshold: int, block_size: int, levels: int,
                 world: int) -> list[np.ndarray]:
    """For each leaf of ``tree`` (in flatten order) and each of its
    elements, the quantization level (scale) and the largest magnitude
    of the block that the element falls in."""
    out: list = [None] * len(jax.tree_util.tree_leaves(tree))
    for bucket, leaves, blocks, n in _bucket_blocks(tree, threshold,
                                                    block_size, world):
        _, scale = _scales(blocks, levels)
        mag = np.abs(blocks).max(1)
        _per_element(out, bucket, leaves, np.stack(
            [np.repeat(scale, block_size), np.repeat(mag, block_size)]), n)
    return out


def quantization_profile(per_rank: list, threshold: int, block_size: int,
                         levels: int, op: str | None = None) -> list:
    """For each leaf, per element: [tie, magnitude].  ``tie`` marks where
    a quantization value (x - lo) / scale lies within round-off of a half
    level, so that rounding it may go either way: in any rank's
    quantization of its input, or in the requantization of the reduced
    buffer (``op`` "sum" or "average").  ``magnitude`` is the sum over
    the ranks of their input block's largest |x|: what the round-off of
    the exchange is relative to.  With ``op=None``, the same for the
    quantization of ``per_rank[0]`` alone (in a world of
    ``len(per_rank)``): the error-feedback residual's."""
    world = len(per_rank)
    ranks = per_rank if op is not None else per_rank[:1]
    parts = [list(_bucket_blocks(t, threshold, block_size, world))
             for t in ranks]
    out: list = [None] * len(jax.tree_util.tree_leaves(per_rank[0]))

    def ties_of(x):
        lo, scale = _scales(x, levels)
        v = (x - lo[:, None]) / scale[:, None]
        return (np.abs(v - np.floor(v) - 0.5) <= 8 * 2.0 ** -23 * levels,
                np.clip(np.round(v), 0, levels - 1) * scale[:, None]
                + lo[:, None])
    for b, (bucket, leaves, blocks, n) in enumerate(parts[0]):
        tie = np.zeros(blocks.shape, bool)
        mag = np.zeros(blocks.shape, np.float32)
        red = np.zeros(blocks.shape, np.float32)
        for rank_parts in parts:
            x = rank_parts[b][2]
            t, deq = ties_of(x)
            tie |= t
            mag += np.abs(x).max(1, keepdims=True)
            red = red + deq
        if op is not None:
            t, _ = ties_of(red / np.float32(world) if op == "average"
                           else red)
            tie |= t
        _per_element(out, bucket, leaves,
                     np.stack([tie.reshape(-1), mag.reshape(-1)]), n)
    return out


# fp32 round-off of the exchange: some 16 operations (quantize,
# dequantize, sum, divide, requantize, dequantize), each within 2^-24 of
# the magnitudes it works on; the two sides differ in where XLA fuses
# (a multiply-add) and in a reciprocal for a division.
ROUNDOFF = 2.0 ** -20


def assert_quantized_close(got, want, levels_tree, label: str,
                           profile) -> None:
    """Every element of ``got`` within round-off of ``want``, except where
    ``profile`` (``quantization_profile``) marks a half level that the two
    sides may round either way: there within one quantization level of
    the element's block (plus round-off)."""
    g_leaves = jax.tree_util.tree_leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves) == len(levels_tree) \
        == len(profile), label
    for g, w, lv, pr in zip(g_leaves, w_leaves, levels_tree, profile):
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32).reshape(w.shape)
        scale, mag_out = lv[0].reshape(w.shape), lv[1].reshape(w.shape)
        tie, mag_in = pr[0].reshape(w.shape) > 0, pr[1].reshape(w.shape)
        d = np.abs(g - w)
        tol = ROUNDOFF * (mag_in + mag_out + np.abs(w))
        bad = (d > tol) & ~tie
        assert not bad.any(), (label, int(bad.sum()), g[bad][:4], w[bad][:4])
        assert (d <= scale + tol).all(), (label, float(d.max()))
