"""Helpers of the CNN parity tests: flax variables drawn from a numpy seed,
the port's model loaded with them, NHWC/NCHW carriers, and the gloo
worlds of ``tests/torch_cnn_worker.py``."""
from __future__ import annotations

import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu_torch import convert

REPO = Path(__file__).resolve().parent.parent
CNN_WORKER = Path(__file__).resolve().parent / "torch_cnn_worker.py"


def random_variables(flax_model, input_shape, seed: int) -> dict:
    """Every leaf of ``flax_model``'s variables drawn with numpy: kernels
    with std 1/sqrt(fan_in), BatchNorm scales near 1 (not flax's zeros, so
    no branch is switched off), small biases and means, variances in
    [0.5, 1.5]."""
    params = inspect.signature(type(flax_model).__call__).parameters
    kwargs = {"train": False} if "train" in params else {}
    shapes = jax.eval_shape(
        lambda: flax_model.init(jax.random.key(0),
                                jnp.zeros(input_shape, jnp.float32),
                                **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, shape)
        else:
            raise KeyError(name)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def load(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    model.load_state_dict(convert.cnn_params_from_flax(
        variables["params"], variables.get("batch_stats", {}), model))
    return model


def batch_stats(model: torch.nn.Module) -> dict:
    return convert.cnn_params_to_flax(model.state_dict())[1]


def to_nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor with channels_last strides."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def max_rel_err(got, want) -> float:
    """max|got - want| over max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_trees_close(got: dict, want: dict, atol: float,
                       rtol: float = 0.0) -> None:
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(flat_got[path]),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def run_cnn_world(tmp_path, inputs: dict, world: int) -> list:
    """``tests/torch_cnn_worker.py`` over a gloo world of ``world`` ranks
    (FileStore under ``tmp_path``) on ``inputs`` (the worker's
    INPUTS.npz entries); each rank's OUT.npz, loaded."""
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # One compute thread a rank: the worlds share the host's cores.
    env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(CNN_WORKER), str(r), str(world),
         str(tmp_path / "store"), str(tmp_path / "inputs.npz"),
         str(tmp_path / f"out{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [np.load(tmp_path / f"out{r}.npz") for r in range(world)]
