"""Traffic-driven autoscaling hooks for fleet jobs (the port's copy of
``horovod_tpu/fleet/autoscale.py``).

A serving-shaped job wants its world
size to track load: grow toward ``max_np`` when a queue-depth or
request-rate signal runs hot, shrink toward ``min_np`` when it runs
cold.  The mechanism reuses what already exists:

- **Signal intake** rides the notice-file idiom: a
  :class:`FileSignal` polls a small file (written by a load balancer,
  a queue exporter, a test) holding one number.  No new transport.
- **Shrink** goes through the SAME planned-drain channel priority
  preemption uses (per-rank ``core/preempt.py`` notice files): a
  scale-down is a planned resize — zero lost steps, no restart-budget
  or blacklist strike.
- **Grow** widens the job's allocation; the elastic driver's own
  discovery poll notices and resets the world at the next commit
  boundary (the existing scale-up semantics, including its budget
  accounting).
- **Time** flows exclusively through the ``core/clock.py`` seam:
  the arbiter passes ``clock.monotonic()`` into :meth:`evaluate`, so
  a simulator can drive debounce windows on virtual time and
  tests use a fake clock with no real sleeps.

Debounce: the signal must stay beyond a watermark CONTINUOUSLY for
``debounce_s`` before an action fires, and after any action the scaler
holds fire for ``cooldown_s`` — a noisy signal crossing the watermark
once per poll can never thrash the world size.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

__all__ = ["Autoscaler", "FileSignal"]


def _default_debounce_s() -> float:
    return float(
        os.environ.get("HVTPU_FLEET_AUTOSCALE_DEBOUNCE_SECONDS", "10")
        or 10)


class FileSignal:
    """Queue-depth / request-rate intake over the notice-file channel:
    the file holds one number; absent or unparseable reads as "no
    signal" (None), which resets the debounce timers rather than
    triggering anything."""

    def __init__(self, path: str):
        self.path = path

    def __call__(self) -> Optional[float]:
        try:
            with open(self.path) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return None

    def __repr__(self) -> str:
        return f"FileSignal({self.path!r})"


class Autoscaler:
    """Debounced two-watermark policy over one scalar signal.

    ``evaluate(now)`` returns ``("grow", step)``, ``("shrink", step)``
    or None; the arbiter applies the decision against the job's
    min/max and the pool's free capacity.  Pure logic over caller-
    provided ``now`` — no threads, no sleeps, no host clock."""

    def __init__(self, signal_fn: Callable[[], Optional[float]], *,
                 high: float, low: float, step: int = 1,
                 debounce_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None):
        if low >= high:
            raise ValueError(
                f"autoscale watermarks inverted: low={low} >= "
                f"high={high}")
        self.signal_fn = signal_fn
        self.high = float(high)
        self.low = float(low)
        self.step = max(1, int(step))
        self.debounce_s = (_default_debounce_s()
                           if debounce_s is None else float(debounce_s))
        self.cooldown_s = (self.debounce_s if cooldown_s is None
                           else float(cooldown_s))
        self.last_signal: Optional[float] = None
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_action_t: Optional[float] = None

    @classmethod
    def from_spec(cls, spec: dict) -> Optional["Autoscaler"]:
        """Build from a JobSpec's validated ``autoscale`` block; the
        signal file falls back to ``HVTPU_FLEET_AUTOSCALE_SIGNAL_FILE``.
        Returns None when no signal source is configured anywhere."""
        path = spec.get("signal_file") or os.environ.get(
            "HVTPU_FLEET_AUTOSCALE_SIGNAL_FILE")
        if not path:
            return None
        return cls(FileSignal(path),
                   high=float(spec["high"]), low=float(spec["low"]),
                   step=int(spec.get("step", 1)),
                   debounce_s=spec.get("debounce_s"),
                   cooldown_s=spec.get("cooldown_s"))

    def evaluate(self, now: float) -> Optional[Tuple[str, int]]:
        """One arbiter-tick evaluation at virtual-or-real time ``now``."""
        value = self.signal_fn()
        self.last_signal = value
        if value is None:
            # no signal ≠ low load: reset, never act on absence
            self._above_since = None
            self._below_since = None
            return None
        if (self._last_action_t is not None
                and now - self._last_action_t < self.cooldown_s):
            return None
        if value > self.high:
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since >= self.debounce_s:
                self._above_since = None
                self._last_action_t = now
                return ("grow", self.step)
        elif value < self.low:
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since >= self.debounce_s:
                self._below_since = None
                self._last_action_t = now
                return ("shrink", self.step)
        else:
            self._above_since = None
            self._below_since = None
        return None

    def debug_state(self) -> dict:
        return {
            "signal": self.last_signal,
            "high": self.high, "low": self.low, "step": self.step,
            "debounce_s": self.debounce_s,
            "cooldown_s": self.cooldown_s,
        }
