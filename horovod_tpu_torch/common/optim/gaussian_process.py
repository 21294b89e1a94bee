"""Gaussian-process regressor (RBF kernel) for the autotuner.

The port's own copy of ``horovod_tpu/common/optim/gaussian_process.py``:
numpy, the same arithmetic in the same order, so its numbers are the
reference's bit for bit.

Reference: horovod/common/optim/gaussian_process.cc — the reference fits
kernel hyperparameters with Eigen + L-BFGS on the log marginal
likelihood.  Here the search space is the unit box and samples number
<= ~20, so a dense log-spaced length-scale sweep maximizing the same log
marginal likelihood (closed form via Cholesky per candidate) reaches the
same optimum without a line-search dependency; targets are normalized to
zero-mean/unit-variance before fitting so the noise term `alpha` is
scale-free against real step-time jitter.
"""
from __future__ import annotations

import numpy as np

_LOG_2PI = float(np.log(2.0 * np.pi))


class GaussianProcess:
    def __init__(self, length_scale: float = 1.0, sigma_f: float = 1.0,
                 alpha: float = 1e-6, optimize: bool = True) -> None:
        self.length_scale = length_scale
        self.sigma_f = sigma_f
        self.alpha = alpha   # observation noise on the diagonal
        self.optimize = optimize
        self._x: np.ndarray | None = None
        self._y: np.ndarray | None = None
        self._k_inv: np.ndarray | None = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self.last_lml: float | None = None   # observability/tests

    def _kernel(self, a: np.ndarray, b: np.ndarray,
                length_scale: float | None = None) -> np.ndarray:
        # RBF: sigma_f^2 * exp(-|a-b|^2 / (2 l^2))
        ls = self.length_scale if length_scale is None else length_scale
        sq = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.sigma_f ** 2 * np.exp(-0.5 * sq / ls ** 2)

    def _lml(self, x: np.ndarray, y: np.ndarray,
             length_scale: float) -> float:
        """Log marginal likelihood of the normalized targets under the
        RBF kernel with the given length scale (gaussian_process.cc
        computes the same objective for its L-BFGS fit)."""
        k = self._kernel(x, x, length_scale) + self.alpha * np.eye(len(x))
        try:
            chol = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            return -np.inf
        alpha_v = np.linalg.solve(chol.T, np.linalg.solve(chol, y))
        return float(-0.5 * y @ alpha_v
                     - np.log(np.diag(chol)).sum()
                     - 0.5 * len(x) * _LOG_2PI)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y_raw = np.asarray(y, dtype=np.float64).reshape(-1)
        # Normalize targets: bytes/sec scores span orders of magnitude
        # across hardware; the kernel amplitude and noise stay O(1).
        self._y_mean = float(y_raw.mean())
        self._y_std = float(y_raw.std()) or 1.0
        yn = (y_raw - self._y_mean) / self._y_std

        if self.optimize and len(x) >= 3:
            # Dense sweep over length scales spanning "one candidate
            # apart" to "the whole unit box" — the 1-D analogue of the
            # reference's gradient fit, robust to LML multimodality.
            candidates = np.logspace(-1.3, 0.3, 17)
            scored = [(self._lml(x, yn, ls), ls) for ls in candidates]
            self.last_lml, self.length_scale = max(scored)
        else:
            self.last_lml = self._lml(x, yn, self.length_scale) \
                if len(x) else None

        k = self._kernel(x, x) + self.alpha * np.eye(len(x))
        self._x, self._y = x, yn
        self._k_inv = np.linalg.inv(k)

    def predict(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Return (mean, std) at query points, in the RAW target scale."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        if self._x is None:
            return np.zeros(len(x)), np.ones(len(x))
        k_s = self._kernel(x, self._x)
        k_ss = self._kernel(x, x)
        mu = k_s @ self._k_inv @ self._y
        cov = k_ss - k_s @ self._k_inv @ k_s.T
        std = np.sqrt(np.maximum(np.diag(cov), 1e-12))
        return (mu * self._y_std + self._y_mean), std * self._y_std
