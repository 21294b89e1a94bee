"""Bayesian optimization: GP surrogate + expected-improvement acquisition.

The port's own copy of ``horovod_tpu/common/optim/bayesian_optimization.py``
(numpy, a ``RandomState`` seeded at construction).

Reference: horovod/common/optim/bayesian_optimization.cc — same structure:
normalise parameters to the unit box, fit the GP on observed (params, score)
pairs, and pick the next sample by maximising expected improvement over a
candidate set (dense grid here instead of L-BFGS restarts; the search space
is 2-D and tiny).
"""
from __future__ import annotations

import math

import numpy as np

from .gaussian_process import GaussianProcess


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class BayesianOptimization:
    def __init__(self, bounds: list[tuple[float, float]],
                 alpha: float = 0.8, xi: float = 0.01,
                 seed: int = 0) -> None:
        self.bounds = np.asarray(bounds, dtype=np.float64)
        self.gp = GaussianProcess(length_scale=0.2, alpha=alpha)
        self.xi = xi
        self._x: list[np.ndarray] = []
        self._y: list[float] = []
        self._rng = np.random.RandomState(seed)

    @property
    def dim(self) -> int:
        return len(self.bounds)

    def _to_unit(self, x: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (x - lo) / np.maximum(hi - lo, 1e-12)

    def _from_unit(self, u: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + u * (hi - lo)

    def add_sample(self, x, y: float) -> None:
        self._x.append(self._to_unit(np.asarray(x, dtype=np.float64)))
        self._y.append(float(y))
        self.gp.fit(np.stack(self._x), np.asarray(self._y))

    def suggest_next(self) -> np.ndarray:
        if not self._x:
            return self._from_unit(self._rng.uniform(size=self.dim))
        candidates = self._rng.uniform(size=(256, self.dim))
        mu, std = self.gp.predict(candidates)
        best = max(self._y)
        imp = mu - best - self.xi
        z = imp / std
        ei = imp * _norm_cdf(z) + std * _norm_pdf(z)
        ei[std < 1e-9] = 0.0
        return self._from_unit(candidates[int(np.argmax(ei))])

    def best(self) -> tuple[np.ndarray, float] | None:
        if not self._y:
            return None
        i = int(np.argmax(self._y))
        return self._from_unit(self._x[i]), self._y[i]

    @property
    def num_samples(self) -> int:
        return len(self._y)
