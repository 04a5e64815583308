"""Online anomaly detection: robust per-signal detectors → structured
Incidents that name the offending ranks.

Counterpart of ``horovod_tpu/obs/anomaly.py``, copied as it is so that
the port imports nothing of the JAX package: the same detectors, scores
and incidents on the same series, whose counts feed the fleet
health rollup (``fleet/health.py``) as the reference's do.

The metrics plane (PR 1), tracing (PR 7), and the overlap profiler
(PR 12) *measure*; nothing *watches*.  This module closes that gap with
detectors cheap enough to run on every step:

- **Rolling median/MAD robust z-score** — per signal, a bounded window
  (``HVTPU_ANOMALY_WINDOW``) whose median is the baseline and whose
  MAD (×1.4826, the Gaussian consistency constant) is the scale; a
  sample scoring ``z ≥ HVTPU_ANOMALY_THRESHOLD`` above the median is
  anomalous.  Median/MAD, unlike mean/σ, don't let the anomaly inflate
  its own yardstick.
- **EWMA baseline** — a smoothed level rides along in every verdict so
  incident records carry "what normal looked like" even while the
  robust window is still absorbing a level shift.
- A **relative floor** (``HVTPU_ANOMALY_MIN_REL``) suppresses firing
  on micro-jitter when the MAD collapses toward zero (perfectly steady
  signals would otherwise make any wiggle infinitely significant).

Signals watched per step (fed by ``metrics.note_step`` from the
stepprof record): step wall time, exposed-comm seconds, data-wait
fraction, KV retry rate.  On rank 0 the controller's arrival-skew
drain feeds per-collective skew plus the last-arriving rank, so
straggler incidents *name the rank* (joining the same counters behind
``hvtpu_collective_last_arriver_total``).

Every fired Incident is counted in ``hvtpu_incidents_total{kind}``,
appended to the flight ring (obs/flight), emitted as a trace instant,
kept in a bounded recent-incidents ring surfaced via the ``anomaly``
``/debug`` provider, and summarized into the fleet health rollup
(fleet/health).

Zero-cost-when-off: seams guard with ``if anomaly.ACTIVE:`` — one
module attribute test when disabled (``HVTPU_ANOMALY=0``), timeit-
enforced in tests.  Time flows through ``core/clock`` so the fabric
simulator runs the *real* detectors on virtual time.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Deque, Dict, List, Optional

from ..core import clock as _clock
from . import metrics as _metrics

__all__ = [
    "ACTIVE",
    "AnomalyConfig",
    "RobustDetector",
    "AnomalyEngine",
    "install",
    "uninstall",
    "on_step",
    "on_arrival_skew",
    "get_engine",
    "env_enabled",
    "KINDS",
]

# Incident kinds, one per watched signal.
KINDS = ("step_time", "exposed_comm", "data_wait", "kv_retry",
         "straggler")

# 1.4826 ≈ 1/Φ⁻¹(3/4): scales MAD to σ under normality.
_MAD_SIGMA = 1.4826

_M_INCIDENTS = _metrics.counter(
    "hvtpu_incidents_total",
    "Anomaly incidents raised, labeled by kind (step_time, "
    "exposed_comm, data_wait, kv_retry, straggler).")


def env_enabled() -> bool:
    """``HVTPU_ANOMALY`` gate (default on)."""
    return os.environ.get("HVTPU_ANOMALY", "1").lower() not in (
        "0", "false", "off")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclasses.dataclass
class AnomalyConfig:
    """Detector knobs (env-derived by default; the sim passes explicit
    values for determinism)."""

    window: int = 64        # rolling median/MAD window (samples)
    warmup: int = 16        # no verdicts before this many samples
    threshold: float = 8.0  # robust z-score to fire at
    ewma_alpha: float = 0.15
    min_rel: float = 0.25   # value must exceed baseline by ≥25%
    cooldown_s: float = 30.0  # per-kind refractory period

    @classmethod
    def from_env(cls) -> "AnomalyConfig":
        return cls(
            window=max(8, _env_int("HVTPU_ANOMALY_WINDOW", 64)),
            warmup=max(4, _env_int("HVTPU_ANOMALY_WARMUP", 16)),
            threshold=_env_float("HVTPU_ANOMALY_THRESHOLD", 8.0),
            min_rel=_env_float("HVTPU_ANOMALY_MIN_REL", 0.25),
            cooldown_s=_env_float("HVTPU_ANOMALY_COOLDOWN_S", 30.0),
        )


def _median(sorted_vals: List[float]) -> float:
    n = len(sorted_vals)
    mid = n // 2
    if n % 2:
        return sorted_vals[mid]
    return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])


class RobustDetector:
    """One signal's rolling median/MAD z-score + EWMA baseline.

    ``update(value)`` scores the sample against the window *before*
    admitting it (the anomaly must not shift its own baseline), then
    appends.  Returns a verdict dict when anomalous, else None.  A
    sustained level shift therefore fires until roughly half the
    window has absorbed the new level — by design: a regime change IS
    an incident, and the refractory period upstream rate-limits it.
    Only high-side deviations fire; every watched signal is
    "bigger is worse"."""

    def __init__(self, config: AnomalyConfig):
        self.cfg = config
        self._vals: Deque[float] = collections.deque(
            maxlen=config.window)
        self.ewma: Optional[float] = None
        self.samples = 0

    def update(self, value: float) -> Optional[dict]:
        verdict = None
        vals = self._vals
        if len(vals) >= self.cfg.warmup:
            s = sorted(vals)
            med = _median(s)
            mad = _median(sorted(abs(v - med) for v in s))
            # scale floor: MAD of a flat series is 0; fall back to a
            # fraction of the baseline so z stays finite and the
            # relative floor governs.
            scale = max(_MAD_SIGMA * mad,
                        abs(med) * self.cfg.min_rel / self.cfg.threshold,
                        1e-12)
            z = (value - med) / scale
            if (z >= self.cfg.threshold
                    and value > med * (1.0 + self.cfg.min_rel)):
                verdict = {
                    "value": value,
                    "baseline": med,
                    "ewma": self.ewma,
                    "zscore": round(z, 3),
                    "n": len(vals),
                }
        vals.append(value)
        self.samples += 1
        a = self.cfg.ewma_alpha
        self.ewma = (value if self.ewma is None
                     else (1.0 - a) * self.ewma + a * value)
        return verdict


class AnomalyEngine:
    """Per-process detector bank + incident ring.

    ``on_step`` consumes the stepprof step record; ``on_arrival_skew``
    (rank 0) consumes the controller's per-collective skew drain.
    Incidents land in a bounded ring (``/debug`` provider ``anomaly``),
    ``hvtpu_incidents_total{kind}``, the flight ring, and as trace
    instants."""

    def __init__(self, *, rank: int = 0, size: int = 1,
                 config: Optional[AnomalyConfig] = None,
                 incident_window: int = 256):
        self.rank = rank
        self.size = size
        self.cfg = config or AnomalyConfig.from_env()
        self._lock = threading.Lock()
        self._det: Dict[str, RobustDetector] = {  # guarded-by(_lock)
            kind: RobustDetector(self.cfg) for kind in KINDS}
        self._incidents: Deque[dict] = collections.deque(
            maxlen=incident_window)  # hvtpulint: guarded-by(_lock)
        self._counts: Dict[str, int] = {}  # hvtpulint: guarded-by(_lock)
        self._last_fire: Dict[str, float] = {}  # guarded-by(_lock)
        self._kv_retries_prev: Optional[float] = None
        # recent last-arriving ranks: the straggler incident blames the
        # dominant one, mirroring hvtpu_collective_last_arriver_total.
        self._arrivers: Deque[int] = collections.deque(maxlen=64)

    # -- feeds -----------------------------------------------------------
    def on_step(self, rec: dict) -> List[dict]:
        """One stepprof step record: ``{"step_wall_s", "steps",
        "exposed_comm_s", "data_wait_s", ...}``."""
        wall = float(rec.get("step_wall_s") or 0.0)
        if wall <= 0.0:
            return []
        fired = []
        steps = float(rec.get("steps") or 1.0)
        fired += self._check("step_time", wall / max(steps, 1.0))
        fired += self._check(
            "exposed_comm", float(rec.get("exposed_comm_s") or 0.0))
        fired += self._check(
            "data_wait",
            float(rec.get("data_wait_s") or 0.0) / wall)
        cur = _metrics.counter("hvtpu_kv_retries_total").value()
        prev, self._kv_retries_prev = self._kv_retries_prev, cur
        if prev is not None:
            fired += self._check("kv_retry", max(0.0, cur - prev) / wall)
        return fired

    def on_arrival_skew(self, name: str, skew_s: float,
                        last_rank: int) -> List[dict]:
        """One drained arrival-skew sample (rank 0's controller):
        collective ``name`` closed with ``skew_s`` between first and
        last arrival; ``last_rank`` arrived last."""
        with self._lock:
            self._arrivers.append(int(last_rank))
        return self._check("straggler", float(skew_s),
                           tensor=name, last_rank=int(last_rank))

    # -- core ------------------------------------------------------------
    def _check(self, kind: str, value: float, **detail) -> List[dict]:
        with self._lock:
            verdict = self._det[kind].update(value)
            if verdict is None:
                return []
            now = _clock.monotonic()
            last = self._last_fire.get(kind)
            if last is not None and now - last < self.cfg.cooldown_s:
                return []
            self._last_fire[kind] = now
            ranks = self._blame_locked(kind, detail)
            incident = {
                "kind": kind,
                "t_wall": round(_clock.wall(), 6),
                "ranks": ranks,
                **verdict,
            }
            if detail:
                incident["detail"] = detail
            self._incidents.append(incident)
            self._counts[kind] = self._counts.get(kind, 0) + 1
        self._emit(incident)
        return [incident]

    def _blame_locked(self, kind: str, detail: dict) -> List[int]:
        """Name offending ranks.  A straggler incident blames the
        anomalous sample's own last-arriver, plus any rank arriving
        last in a majority of the recent window (a persistent
        straggler even when it isn't last in this one sample — healthy
        jitter never gives any rank a majority).  Process-local
        signals blame this rank."""
        if kind == "straggler":
            blamed = set()
            last = detail.get("last_rank")
            if last is not None:
                blamed.add(int(last))
            n = len(self._arrivers)
            # only trust the majority tally once the window has real
            # depth: a dozen healthy samples can crown a rank by
            # coincidence.
            if n >= (self._arrivers.maxlen or 64) // 2:
                tally: Dict[int, int] = {}
                for r in self._arrivers:
                    tally[r] = tally.get(r, 0) + 1
                blamed.update(
                    r for r, c in tally.items() if c * 2 > n)
            if blamed:
                return sorted(blamed)
        return [self.rank]

    def _emit(self, incident: dict) -> None:
        _M_INCIDENTS.inc(kind=incident["kind"])
        try:
            from . import flight as _flight
            if _flight.ACTIVE:
                _flight.note("incident", **incident)
        except Exception:
            pass
        try:
            from . import tracing as _tracing
            if _tracing.ACTIVE:
                _tracing.instant(
                    "incident", kind=incident["kind"],
                    zscore=incident.get("zscore"),
                    value=incident.get("value"),
                    ranks=incident.get("ranks"))
        except Exception:
            pass

    # -- read side -------------------------------------------------------
    def incidents(self) -> List[dict]:
        with self._lock:
            return list(self._incidents)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "active": True,
                "rank": self.rank,
                "config": dataclasses.asdict(self.cfg),
                "counts": dict(self._counts),
                "ewma": {k: (round(d.ewma, 9)
                             if d.ewma is not None else None)
                         for k, d in self._det.items()},
                "samples": {k: d.samples for k, d in self._det.items()},
                "recent": list(self._incidents)[-16:],
            }


# ---------------------------------------------------------------------------
# module plumbing (ACTIVE flag + None-checked shims, as obs/tracing)
# ---------------------------------------------------------------------------

ACTIVE = False
_engine: Optional[AnomalyEngine] = None
_install_lock = threading.Lock()


def install(*, rank: int = 0, size: int = 1,
            config: Optional[AnomalyConfig] = None
            ) -> Optional[AnomalyEngine]:
    """Create the process engine, flip :data:`ACTIVE`, register the
    ``anomaly`` /debug provider.  No-op when ``HVTPU_ANOMALY=0`` or
    already installed."""
    global ACTIVE, _engine
    if not env_enabled():
        return None
    with _install_lock:
        if _engine is not None:
            return _engine
        eng = AnomalyEngine(rank=rank, size=size, config=config)
        _engine = eng
        ACTIVE = True
    _metrics.register_debug_provider("anomaly", eng.debug_state)
    return eng


def uninstall() -> None:
    global ACTIVE, _engine
    with _install_lock:
        ACTIVE = False
        eng, _engine = _engine, None
    if eng is None:
        return
    try:
        _metrics.unregister_debug_provider("anomaly")
    except Exception:
        pass


def get_engine() -> Optional[AnomalyEngine]:
    return _engine


def on_step(rec: dict) -> None:
    """Feed one step record; callers guard with ``if anomaly.ACTIVE``."""
    e = _engine
    if e is not None:
        e.on_step(rec)


def on_arrival_skew(name: str, skew_s: float, last_rank: int) -> None:
    e = _engine
    if e is not None:
        e.on_arrival_skew(name, skew_s, last_rank)
