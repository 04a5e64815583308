"""Gaussian-process regression + Expected Improvement (counterpart of
``horovod_tpu/obs/gaussian_process.py``).

Parity surface: ``horovod/common/optim/gaussian_process.cc``
(``GaussianProcessRegressor`` — RBF kernel, Cholesky solve, EI) and
``bayesian_optimization.cc`` (``BayesianOptimization::NextSample``).

Like the reference, the math lives in native code
(``native/src/gaussian_process.cc``); this numpy implementation is the
executable-spec twin, taken with ``HVTPU_FORCE_PY_GP=1``, before the
first fit, or where the C++ call declines a singular Gram matrix.  A
native library that fails to build or load raises: there is no quiet
fallback.  ``tests/test_torch_port_native.py`` holds the two within
1e-9 of each other.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


class GaussianProcess:
    """GP regressor with an RBF kernel (parity: gaussian_process.cc
    alpha=noise, length_scale fixed — the reference also skips
    hyperparameter optimization)."""

    def __init__(self, length_scale: float = 1.0, noise: float = 1e-6,
                 signal_variance: float = 1.0):
        self.length_scale = length_scale
        self.noise = noise
        self.signal_variance = signal_variance
        self._x: Optional[np.ndarray] = None
        self._raw_y: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self._alpha: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal_variance * np.exp(
            -0.5 * d2 / (self.length_scale ** 2)
        )

    def fit(self, x: np.ndarray, y: np.ndarray):
        """Record the data and standardisation; the O(n^3) Cholesky is
        deferred — the native path refactors from raw (x, y) itself, so
        factoring here would do the cubic work twice per suggest."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64).reshape(-1)
        self._raw_y = y
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        self._chol = None
        self._alpha = None
        self._x = x

    def _ensure_factor(self):
        if self._chol is not None:
            return
        yn = (self._raw_y - self._y_mean) / self._y_std
        k = self._kernel(self._x, self._x) + self.noise * np.eye(
            len(self._x)
        )
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, yn)
        )

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior (mean, std) at ``x`` in the ORIGINAL y units.
        Routes through the native implementation when available."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        if self._x is None:
            return (np.full(len(x), self._y_mean),
                    np.full(len(x), self._y_std))
        native = _native_predict(self, x)
        if native is not None:
            return native
        self._ensure_factor()
        ks = self._kernel(x, self._x)
        mu = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        # RBF prior variance is constant on the diagonal — no need to
        # build the full candidate kernel matrix
        var = np.clip(
            self.signal_variance - (v * v).sum(0), 1e-12, None
        )
        return (mu * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)


def _native_call(fn_name: str, gp: "GaussianProcess", cand, **extra):
    """Shared native-dispatch policy for the GP entry points: disabled
    by HVTPU_FORCE_PY_GP=1 or before fit; None (-> the numpy twin) when
    the C++ call declines a singular Gram matrix.  A library that cannot
    be built or loaded raises."""
    import os

    if (getattr(gp, "_raw_y", None) is None
            or os.environ.get("HVTPU_FORCE_PY_GP", "0") == "1"):
        return None
    from ..native import core as native_core

    fn = getattr(native_core, fn_name)
    return fn(
        gp._x, gp._raw_y, cand,
        length_scale=gp.length_scale, noise=gp.noise,
        signal_variance=gp.signal_variance, **extra,
    )


def _native_predict(gp: "GaussianProcess", cand):
    """Posterior via native/src/gaussian_process.cc; None -> fall back
    to the numpy twin."""
    return _native_call("gp_predict", gp, cand)


_erf = np.vectorize(math.erf)


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _norm_cdf(z):
    return 0.5 * (1.0 + _erf(z / math.sqrt(2.0)))


def expected_improvement(gp: GaussianProcess, candidates: np.ndarray,
                         best_y: float, xi: float = 0.01) -> np.ndarray:
    """EI acquisition (maximization; parity: the EI computation in
    bayesian_optimization.cc).  One native fit+predict+EI call, the
    numpy twin where ``_native_call`` keeps it."""
    candidates = np.atleast_2d(np.asarray(candidates, np.float64))
    if gp._x is not None:
        ei = _native_call("gp_expected_improvement", gp, candidates,
                          best_y=best_y, xi=xi)
        if ei is not None:
            return ei
    mu, sigma = gp.predict(candidates)
    imp = mu - best_y - xi
    z = imp / sigma
    ei = imp * _norm_cdf(z) + sigma * _norm_pdf(z)
    ei[sigma < 1e-12] = 0.0
    return ei


class BayesianOptimizer:
    """Sequential maximizer over a box (parity: BayesianOptimization).

    Coordinates are normalized to [0, 1]^d; ``suggest`` returns the
    next point (seed points first, then argmax-EI over a random
    candidate cloud), ``observe`` records a score.
    """

    def __init__(self, bounds: List[Tuple[float, float]],
                 seed_points: Optional[List] = None,
                 n_candidates: int = 256, rng_seed: int = 0):
        self.bounds = np.asarray(bounds, np.float64)
        self._rng = np.random.RandomState(rng_seed)
        self._gp = GaussianProcess(length_scale=0.3, noise=1e-4)
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []
        self._seeds = [np.asarray(p, np.float64)
                       for p in (seed_points or [])]
        self._n_candidates = n_candidates

    def _to_unit(self, x):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (np.asarray(x, np.float64) - lo) / (hi - lo)

    def _from_unit(self, u):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + np.asarray(u, np.float64) * (hi - lo)

    def suggest(self) -> np.ndarray:
        if len(self._xs) < len(self._seeds):
            return self._seeds[len(self._xs)]
        if not self._xs:
            return self._from_unit(self._rng.rand(len(self.bounds)))
        self._gp.fit(
            np.stack([self._to_unit(x) for x in self._xs]),
            np.asarray(self._ys),
        )
        cand = self._rng.rand(self._n_candidates, len(self.bounds))
        ei = expected_improvement(self._gp, cand, max(self._ys))
        return self._from_unit(cand[int(np.argmax(ei))])

    def observe(self, x, y: float):
        self._xs.append(np.asarray(x, np.float64))
        self._ys.append(float(y))

    @property
    def best_index(self) -> int:
        return int(np.argmax(self._ys))

    @property
    def best(self) -> Tuple[np.ndarray, float]:
        i = self.best_index
        return self._xs[i], self._ys[i]

    @property
    def num_observations(self) -> int:
        return len(self._ys)
