"""Online autotuning of fusion threshold / cycle time (counterpart of
``horovod_tpu/obs/autotune.py``).

Parity surface: ``horovod/common/parameter_manager.cc``
(``ParameterManager``) + ``horovod/common/optim/bayesian_optimization.cc``
— enabled by ``HVTPU_AUTOTUNE=1``, scoring each sampled configuration by
observed throughput and converging on the best, optionally logging every
sample to ``HVTPU_AUTOTUNE_LOG`` as CSV.

Two search strategies:

* ``gp`` (default, reference parity): a Gaussian process with Expected
  Improvement over (log2 fusion threshold, cycle time), seeded with the
  reference's default operating points, sampling
  ``autotune_gp_samples`` configurations before pinning the best.
* ``grid``: successive sweep of a discrete log-grid (cheap-and-robust
  fallback; also what the tests drive deterministically).

Each candidate gets ``autotune_steps_per_sample`` steps; scores are
bytes/sec moved by the eager controller.  Rank 0's controller scores
each cycle and publishes the tuner's values in its ResponseLists, so
every rank applies the same ones (``eager/controller.py``).  What it
tunes is the controller's path: the async ops and their fused groups.
``DistributedOptimizer``'s fixed bucket plan does not go through the
controller and is not tuned.
"""

from __future__ import annotations

import csv
import time
from typing import List, Optional, Tuple

# (fusion_threshold_bytes, cycle_time_ms) candidates — log grid around
# the reference defaults (64 MB, 1-5 ms).
_DEFAULT_GRID: List[Tuple[int, float]] = [
    (2 * 1024 * 1024, 1.0),
    (8 * 1024 * 1024, 1.0),
    (32 * 1024 * 1024, 1.0),
    (64 * 1024 * 1024, 1.0),
    (64 * 1024 * 1024, 2.5),
    (128 * 1024 * 1024, 2.5),
    (128 * 1024 * 1024, 5.0),
]

# GP search box: log2(bytes) in [2 MB, 256 MB], cycle time 0.5-10 ms
_GP_BOUNDS = [(21.0, 28.0), (0.5, 10.0)]
# seed points (log2 threshold, cycle ms): the reference defaults
_GP_SEEDS = [(26.0, 1.0), (21.0, 1.0), (27.0, 5.0)]


class Autotuner:
    def __init__(self, config, grid: Optional[List[Tuple[int, float]]] = None,
                 mode: Optional[str] = None):
        self._steps_per_sample = max(1, config.autotune_steps_per_sample)
        self._warmup = max(0, config.autotune_warmup_samples)
        self._log_path = config.autotune_log
        # an explicit grid ALWAYS means grid mode (callers/tests chose
        # their candidates); otherwise the config decides
        if grid is not None:
            self.mode = "grid"
        else:
            self.mode = (mode
                         or getattr(config, "autotune_mode", None)
                         or "gp")
        self._grid = list(grid or _DEFAULT_GRID)
        self._max_gp_samples = getattr(config, "autotune_gp_samples", 12)
        if self.mode == "gp":
            from .gaussian_process import BayesianOptimizer

            self._bo = BayesianOptimizer(_GP_BOUNDS, seed_points=_GP_SEEDS)
            self._active = self._point_to_params(self._bo.suggest())
        else:
            self._bo = None
            self._active = self._grid[0]
        self._candidate = 0
        self._scores: List[float] = []
        # raw params per GP observation: pinning must return the EXACT
        # candidate that was run, not a log2/2** float round-trip of it
        # (the round-trip can shift the integer threshold by 1 ulp,
        # yielding a "best" config that was never actually sampled)
        self._gp_observed: List[Tuple[int, float]] = []
        self._steps = 0
        self._bytes = 0
        self._t_start = time.monotonic()
        self._pinned: Optional[Tuple[int, float]] = None
        self._warmup_left = self._warmup
        if self._log_path:
            with open(self._log_path, "w", newline="") as f:
                csv.writer(f).writerow(
                    ["fusion_threshold", "cycle_time_ms", "bytes_per_sec"]
                )

    @staticmethod
    def _point_to_params(pt) -> Tuple[int, float]:
        log2_thr, cyc = float(pt[0]), float(pt[1])
        return int(2.0 ** log2_thr), round(cyc, 3)

    @staticmethod
    def _params_to_point(params):
        import math

        thr, cyc = params
        return (math.log2(max(thr, 1)), cyc)

    @property
    def current(self) -> Tuple[int, float]:
        """Active (fusion_threshold_bytes, cycle_time_ms)."""
        if self._pinned is not None:
            return self._pinned
        return self._active

    @property
    def done(self) -> bool:
        return self._pinned is not None

    def _log_sample(self, score: float):
        if self._log_path:
            thr, cyc = self._active
            with open(self._log_path, "a", newline="") as f:
                csv.writer(f).writerow([thr, cyc, f"{score:.1f}"])

    def record_step(self, nbytes: int):
        """Report one training/communication step of ``nbytes`` reduced.

        Drives the sampling schedule; call once per step from the eager
        controller cycle (or a training loop).
        """
        if self._pinned is not None:
            return
        if self._warmup_left > 0:
            self._warmup_left -= 1
            self._t_start = time.monotonic()
            return
        self._steps += 1
        self._bytes += nbytes
        if self._steps < self._steps_per_sample:
            return
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        score = self._bytes / elapsed
        self._log_sample(score)
        self._steps = 0
        self._bytes = 0
        if self.mode == "gp":
            self._bo.observe(self._params_to_point(self._active), score)
            self._gp_observed.append(self._active)
            if self._bo.num_observations >= self._max_gp_samples:
                self._pinned = self._gp_observed[self._bo.best_index]
            else:
                self._active = self._point_to_params(self._bo.suggest())
        else:
            self._scores.append(score)
            self._candidate += 1
            if self._candidate >= len(self._grid):
                best = max(range(len(self._scores)),
                           key=self._scores.__getitem__)
                self._pinned = self._grid[best]
            else:
                self._active = self._grid[self._candidate]
        self._t_start = time.monotonic()
