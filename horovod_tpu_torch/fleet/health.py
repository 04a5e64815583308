"""Fleet health rollup: job-side publish, arbiter-side read (the port's
copy of ``horovod_tpu/fleet/health.py``: the same summary and file, so
each package's :func:`read_file` reads the other's).

The arbiter (fleet/arbiter.py) schedules jobs it otherwise cannot see
inside: a RUNNING row says nothing about whether the job is making
steps, throwing incidents, or wedged in a stall.  This module closes
the loop with one compact JSON summary per job:

- **Job side** — rank 0 runs a :class:`HealthReporter` (installed by
  ``core/state.init`` when ``HVTPU_FLEET_JOB`` names the owning fleet
  job) that every ``HVTPU_HEALTH_INTERVAL_S`` seconds summarizes the
  process's own telemetry (optimizer steps + EWMA step rate from the
  metrics registry, per-kind incident counts from obs/anomaly, the
  elastic generation, and a stall age derived from the flight ring's
  ``step`` vs ``stall_warning`` recency) and writes it at key
  ``health`` under the job's prefixed KV namespace
  (``fleet/<job>/health`` — see fleet/job.py's ``prefixed_client``).
- **Arbiter side** — :func:`read` fetches a job's summary; the arbiter
  attaches it to the job row in ``state.json`` each tick and exports
  the fleet gauges, and the CLI's ``top`` renders the table.

In a real deployment each job's coordination KV is private to its own
world — the arbiter process is not a member and cannot read it.  The
reporter therefore also mirrors every summary to an atomic file in
``HVTPU_FLEET_HEALTH_DIR`` (a job-scoped directory the fleet runner
injects alongside ``HVTPU_FLEET_JOB``), and the arbiter falls back to
:func:`read_file` when it has no shared KV client.  The KV channel
remains primary where one exists (a shared store client).

Time flows through ``core/clock`` so the rollup behaves identically
under an installed virtual clock.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, Optional

from ..core import clock
from ..core.retry import unstamp
from ..obs import metrics as obs_metrics
from .job import prefixed_client

__all__ = ["HEALTH_KEY", "HEALTH_FILE", "summarize", "HealthReporter",
           "read", "read_file", "health_interval_s"]

logger = logging.getLogger("horovod_tpu_torch")

#: key under the job's prefixed namespace (full: ``fleet/<job>/health``)
HEALTH_KEY = "health"

#: filename inside ``HVTPU_FLEET_HEALTH_DIR`` (the file channel)
HEALTH_FILE = "health.json"

# A summary whose publish wall-clock age exceeds this many intervals is
# reported with "stale": true by read() so the CLI's `top` can flag a
# job that stopped publishing (wedged or dead) without guessing.
STALE_INTERVALS = 3.0


def health_interval_s() -> float:
    """``HVTPU_HEALTH_INTERVAL_S``: publish cadence (seconds)."""
    try:
        return max(1.0, float(
            os.environ.get("HVTPU_HEALTH_INTERVAL_S", "15")))
    except ValueError:
        return 15.0


def summarize(*, rank: int = 0, generation: Optional[int] = None
              ) -> Dict[str, Any]:
    """One compact health summary from this process's own telemetry.
    Pure read: registry counters/gauges, the anomaly engine's incident
    counts, and the flight ring's event recency."""
    reg = obs_metrics.REGISTRY
    steps = reg.counter("hvtpu_optimizer_steps_total").value()
    rate = reg.gauge("hvtpu_steps_per_second").value()
    if generation is None:
        generation = int(reg.gauge("hvtpu_elastic_generation").value())
    out: Dict[str, Any] = {
        "t_wall": round(clock.wall(), 3),
        "rank": rank,
        "generation": generation,
        "restarts": generation,
        "steps": steps,
        "step_rate": round(rate, 4),
        "incidents": {},
        "incidents_total": 0,
        "stall_age_s": 0.0,
        "interval_s": health_interval_s(),
    }
    try:
        from ..obs import anomaly as _anomaly
        eng = _anomaly.get_engine()
        if eng is not None:
            counts = eng.counts()
            out["incidents"] = counts
            out["incidents_total"] = sum(counts.values())
    except Exception:
        pass
    try:
        from ..obs import flight as _flight
        rec = _flight.get_recorder()
        if rec is not None:
            warn_t = rec.last_event_t("stall_warning")
            step_t = rec.last_event_t("step")
            if warn_t is not None and (step_t is None or warn_t > step_t):
                # a stall warning newer than the last completed step:
                # the job is (still) stalled; age from the last step
                # it did finish, else from the warning itself.
                now = clock.monotonic()
                out["stall_age_s"] = round(
                    now - (step_t if step_t is not None else warn_t), 3)
    except Exception:
        pass
    return out


class HealthReporter:
    """Rank 0's background publisher.  ``client`` is the coordination
    KV (already-resilient) — None for file-only publishing;
    ``job_name`` selects the prefixed namespace.  ``file_dir``
    (default: ``HVTPU_FLEET_HEALTH_DIR``) additionally mirrors each
    summary to an atomic file the arbiter can read without being a
    member of the job's coordination world.  ``start()`` spawns a
    daemon loop on the publish cadence; :meth:`publish_once` is the
    synchronous unit (tests drive it directly)."""

    def __init__(self, client, job_name: str, *, rank: int = 0,
                 interval_s: Optional[float] = None,
                 file_dir: Optional[str] = None):
        self.job_name = job_name
        self.rank = rank
        self.interval_s = (health_interval_s()
                           if interval_s is None else interval_s)
        self._kv = (prefixed_client(client, job_name)
                    if client is not None else None)
        self.file_dir = (os.environ.get("HVTPU_FLEET_HEALTH_DIR")
                         if file_dir is None else file_dir)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish_once(self) -> Optional[Dict[str, Any]]:
        """Summarize and write; never raises (health must not take the
        job down).  Returns the published summary, or None when every
        channel failed."""
        try:
            summary = summarize(rank=self.rank)
            summary["job"] = self.job_name
            payload = json.dumps(summary, sort_keys=True)
        except Exception:
            logger.debug("fleet health summarize failed", exc_info=True)
            return None
        ok = False
        if self._kv is not None:
            try:
                self._kv.key_value_set(HEALTH_KEY, payload)
                ok = True
            except Exception:
                logger.debug("fleet health KV publish failed",
                             exc_info=True)
        if self.file_dir:
            try:
                os.makedirs(self.file_dir, exist_ok=True)
                tmp = os.path.join(
                    self.file_dir, f".{HEALTH_FILE}.{os.getpid()}.part")
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(payload)
                os.replace(tmp, os.path.join(self.file_dir, HEALTH_FILE))
                ok = True
            except OSError:
                logger.debug("fleet health file publish failed",
                             exc_info=True)
        return summary if ok else None

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.publish_once()
            clock.sleep(self.interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="hvtpu-health", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        # no join: the loop may be inside clock.sleep; daemon threads
        # die with the process and publish_once is crash-safe.
        self._thread = None


def _parse(raw, now_wall: Optional[float]) -> Optional[Dict[str, Any]]:
    # The reporter side writes through a fenced client (core/retry.py
    # FencedKV), so the summary may carry a generation-fencing stamp;
    # the arbiter reads with its own raw client and must stay
    # stamp-tolerant.  unstamp() is a no-op on unstamped payloads.
    if isinstance(raw, bytes):
        try:
            raw = raw.decode("utf-8")
        except UnicodeDecodeError:
            return None
    _tok, raw = unstamp(raw)
    try:
        summary = json.loads(raw)
    except (TypeError, ValueError):
        return None
    if not isinstance(summary, dict):
        return None
    t = summary.get("t_wall")
    interval = summary.get("interval_s") or health_interval_s()
    if isinstance(t, (int, float)):
        now = clock.wall() if now_wall is None else now_wall
        summary["stale"] = bool(
            now - t > STALE_INTERVALS * float(interval))
    return summary


def read(client, job_name: str,
         *, now_wall: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Arbiter-side fetch of a job's latest summary (None when the job
    never published or the read failed).  Adds ``"stale": true`` when
    the summary's publish time is older than ``STALE_INTERVALS`` times
    its own cadence."""
    try:
        kv = prefixed_client(client, job_name)
        raw = kv.key_value_try_get(HEALTH_KEY)
    except Exception:
        return None
    if raw is None:
        return None
    return _parse(raw, now_wall)


def read_file(file_dir: str,
              *, now_wall: Optional[float] = None
              ) -> Optional[Dict[str, Any]]:
    """File-channel twin of :func:`read`: load the summary the
    reporter mirrored into ``file_dir`` (None when the job never
    published there or the file is unreadable/torn)."""
    try:
        with open(os.path.join(file_dir, HEALTH_FILE),
                  encoding="utf-8") as f:
            raw = f.read()
    except OSError:
        return None
    return _parse(raw, now_wall)
