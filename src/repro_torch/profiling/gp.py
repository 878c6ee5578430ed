"""Minimal Gaussian Process regressor (RBF + noise) in numpy.

Supports the profiling engine's needs: posterior mean/variance over the
embedded strategy space, feasibility probability under an accuracy
threshold, and incremental refits as observations accumulate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class GaussianProcess:
    length_scale: float = 1.0
    signal_var: float = 1.0
    noise_var: float = 1e-4
    normalize_y: bool = True

    _x: Optional[np.ndarray] = field(default=None, repr=False)
    _alpha: Optional[np.ndarray] = field(default=None, repr=False)
    _l_chol: Optional[np.ndarray] = field(default=None, repr=False)
    _y_mean: float = 0.0
    _y_std: float = 1.0

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal_var * np.exp(-0.5 * d2 / self.length_scale**2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64).ravel()
        if self.normalize_y and len(y) > 1:
            self._y_mean = float(y.mean())
            self._y_std = float(y.std() + 1e-9)
        else:
            self._y_mean, self._y_std = 0.0, 1.0
        yn = (y - self._y_mean) / self._y_std
        k = self._kernel(x, x) + self.noise_var * np.eye(len(x))
        self._l_chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._l_chol.T, np.linalg.solve(self._l_chol, yn))
        self._x = x
        return self

    def predict(self, xq: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior (mean, std) at query points."""
        xq = np.atleast_2d(np.asarray(xq, dtype=np.float64))
        if self._x is None:
            return (np.zeros(len(xq)) + self._y_mean,
                    np.full(len(xq), np.sqrt(self.signal_var)) * self._y_std)
        ks = self._kernel(xq, self._x)
        mean = ks @ self._alpha
        v = np.linalg.solve(self._l_chol, ks.T)
        var = np.clip(self.signal_var - (v**2).sum(0), 1e-12, None)
        return mean * self._y_std + self._y_mean, np.sqrt(var) * self._y_std

    def prob_greater(self, xq: np.ndarray, threshold: float) -> np.ndarray:
        """P(f(x) >= threshold) under the Gaussian posterior."""
        mean, std = self.predict(xq)
        z = (mean - threshold) / np.maximum(std, 1e-9)
        return _norm_cdf(z)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))


def _erf(x: np.ndarray) -> np.ndarray:
    # Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7)
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y
