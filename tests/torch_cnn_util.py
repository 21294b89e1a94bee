"""Helpers of the CNN parity tests: flax variables drawn from a numpy seed,
the port's model loaded with them, and NHWC/NCHW carriers."""
from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu_torch import convert


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
