"""Black-box flight recorder: a bounded ring of structured events plus
crash postmortems.

Counterpart of ``horovod_tpu/obs/flight.py``, copied so that the port
imports nothing of the JAX package; the ring, the postmortem JSON
(``hvtpu-postmortem-v1``) and ``python -m tools.hvtputrace postmortem``
are shared.  The port's seams today: step records (``metrics.note_step``
via obs/stepprof), controller mispredicts and resyncs, KV retries and
fences (core/retry), stall warnings and aborts (comm/stall and the
controller), wire retries and reroutes (comm/wirefault), fault-harness
windows and kills (core/faults), and anomaly incidents.  The drain,
elastic, audit and durable-writer seams of the reference come with
those planes.

Aviation flight recorders answer "what was the aircraft doing in the
last N minutes" after the fact; this module does the same for a
training job.  Every interesting seam the runtime already has —
step-boundary records (obs/stepprof), controller mispredicts/resyncs
(eager/controller), KV retries (core/retry), stall warnings
(comm/stall), drain transitions (core/preempt), elastic restarts,
audit verdicts (core/audit), durable-writer commits (core/durable),
anomaly incidents (obs/anomaly) — appends ONE cheap event to a
per-process ring (``deque(maxlen=HVTPU_FLIGHT_WINDOW)``).  The ring
costs a tuple and a deque append per event and is always on unless
``HVTPU_FLIGHT=0``.

When a job dies on a *fatal* path — stall abort,
``HvtpuMismatchError``/``HvtpuDivergenceError``, restart-budget
exhaustion, an unhandled worker exception, drain-grace force-exit —
or on demand via ``SIGUSR2``, :func:`dump_postmortem` writes
``postmortem-<rank>-<gen>.json`` into ``HVTPU_FLIGHT_DIR`` (default:
the trace dir, else CWD) containing the ring, every registered
``/debug`` provider snapshot, and a final metrics snapshot.
``python -m tools.hvtputrace postmortem <dir>`` merges the per-rank
dumps into one clock-corrected causal timeline.

Zero-cost-when-off contract (same as obs/tracing): hot seams guard
with ``if flight.ACTIVE: flight.note(...)`` — a single module
attribute test when disabled, timeit-enforced in tests/test_flight.py.

Event timestamps are read through the ``core/clock`` seam so the
fabric simulator records deterministic virtual-time rings.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import threading
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..core import clock as _clock
from . import metrics as _metrics

__all__ = [
    "ACTIVE",
    "FlightRecorder",
    "install",
    "uninstall",
    "note",
    "dump_postmortem",
    "get_recorder",
    "env_enabled",
    "env_window",
    "POSTMORTEM_SCHEMA",
]

POSTMORTEM_SCHEMA = "hvtpu-postmortem-v1"

_M_EVENTS = _metrics.counter(
    "hvtpu_flight_events_total",
    "Structured events appended to the flight-recorder ring.")
_M_POSTMORTEMS = _metrics.counter(
    "hvtpu_postmortems_total",
    "Postmortem dumps written, labeled by trigger reason.")


def env_enabled() -> bool:
    """``HVTPU_FLIGHT`` gate (default on — the recorder is the black
    box; opt *out*, not in)."""
    return os.environ.get("HVTPU_FLIGHT", "1").lower() not in (
        "0", "false", "off")


def env_window() -> int:
    """``HVTPU_FLIGHT_WINDOW``: ring capacity in events."""
    try:
        n = int(os.environ.get("HVTPU_FLIGHT_WINDOW", "2048"))
    except ValueError:
        return 2048
    return max(16, n)


def _env_dir() -> str:
    # explicit flight dir > trace dir > the job's durable state dir >
    # CWD as the last resort (the reference's order)
    return (os.environ.get("HVTPU_FLIGHT_DIR")
            or os.environ.get("HVTPU_TRACE")
            or os.environ.get("HVTPU_ELASTIC_STATE_DIR")
            or ".")


class FlightRecorder:
    """The per-process ring.  Appends store ``(t_mono, kind, fields)``
    tuples — no per-event dict churn; dicts materialize only at dump
    time.  Thread-safe: one lock around the deque."""

    def __init__(self, *, rank: Any = 0, size: int = 1,
                 generation: int = 0, out_dir: Optional[str] = None,
                 window: Optional[int] = None):
        self.rank = rank
        self.size = size
        self.generation = generation
        self.out_dir = out_dir or _env_dir()
        self._lock = threading.Lock()
        self._ring: Deque[Tuple[float, str, Optional[dict]]] = \
            collections.deque(maxlen=window or env_window())
        self._dropped = 0          # hvtpulint: guarded-by(_lock)
        self._appended = 0         # hvtpulint: guarded-by(_lock)
        self._last_t: Dict[str, float] = {}  # hvtpulint: guarded-by(_lock)
        self._reasons: List[str] = []
        # wall↔monotonic anchor pair: dump converts ring timestamps to
        # wall time as wall_anchor + (t - mono_anchor), and the merge
        # tool cross-corrects ranks from these plus the tracing offset.
        self.wall_anchor = _clock.wall()
        self.mono_anchor = _clock.monotonic()

    # -- hot path --------------------------------------------------------
    def note(self, kind: str, fields: Optional[dict] = None) -> None:
        t = _clock.monotonic()
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append((t, kind, fields))
            self._appended += 1
            self._last_t[kind] = t
        _M_EVENTS.inc()

    # -- read side -------------------------------------------------------
    def last_event_t(self, kind: str) -> Optional[float]:
        """Monotonic timestamp of the newest event of ``kind`` (None if
        never seen) — the fleet health summary's stall-age input."""
        with self._lock:
            return self._last_t.get(kind)

    def events(self) -> List[dict]:
        """Ring contents as dicts with wall-clock timestamps (oldest
        first)."""
        with self._lock:
            ring = list(self._ring)
        base = self.wall_anchor - self.mono_anchor
        out = []
        for t, kind, fields in ring:
            ev = {"t_wall": round(t + base, 6), "kind": kind}
            if fields:
                ev.update(fields)
            out.append(ev)
        return out

    def debug_state(self) -> dict:
        with self._lock:
            n = len(self._ring)
            kinds: Dict[str, int] = {}
            for _, kind, _f in self._ring:
                kinds[kind] = kinds.get(kind, 0) + 1
            return {
                "active": True,
                "rank": self.rank,
                "generation": self.generation,
                "window": self._ring.maxlen,
                "events": n,
                "appended": self._appended,
                "dropped": self._dropped,
                "kinds": kinds,
                "reasons": list(self._reasons),
            }

    # -- postmortem ------------------------------------------------------
    def dump(self, reason: str, **fields) -> Optional[str]:
        """Write ``postmortem-<rank>-<gen>.json`` (atomic replace).
        Repeated dumps overwrite — the newest ring wins — with every
        trigger reason accumulated in ``reasons``.  Never raises: a
        postmortem failure must not mask the original fatal error."""
        try:
            with self._lock:
                if reason not in self._reasons:
                    self._reasons.append(reason)
                reasons = list(self._reasons)
            clock_meta: Dict[str, Any] = {
                "wall_anchor": self.wall_anchor,
                "mono_anchor": self.mono_anchor,
            }
            try:
                from . import tracing as _tracing
                tracer = _tracing.get_tracer()
                if tracer is not None:
                    clock_meta["offset_us"] = tracer.offset_us
                    clock_meta["error_bound_us"] = tracer.offset_error_us
            except Exception:
                pass
            doc = {
                "schema": POSTMORTEM_SCHEMA,
                "rank": self.rank,
                "size": self.size,
                "generation": self.generation,
                "reason": reason,
                "reasons": reasons,
                "t_wall": round(_clock.wall(), 6),
                "clock": clock_meta,
                "events": self.events(),
                "debug": _metrics.debug_snapshot(),
                "metrics": _metrics.snapshot(),
            }
            if fields:
                doc["detail"] = fields
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"postmortem-{self.rank}-{self.generation}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True, default=str)
                f.write("\n")
            os.replace(tmp, path)
            _M_POSTMORTEMS.inc(reason=reason)
            return path
        except Exception:
            return None


# ---------------------------------------------------------------------------
# module plumbing (mirrors obs/tracing.py: ACTIVE flag + None-checked shims)
# ---------------------------------------------------------------------------

ACTIVE = False
_recorder: Optional[FlightRecorder] = None
_prev_sigusr2: Any = None
_install_lock = threading.Lock()


def install(*, rank: Any = 0, size: int = 1, generation: int = 0,
            out_dir: Optional[str] = None,
            window: Optional[int] = None,
            sigusr2: bool = True) -> Optional[FlightRecorder]:
    """Create the process recorder, flip :data:`ACTIVE`, register the
    ``flight`` /debug provider, and (main thread only) hook ``SIGUSR2``
    for on-demand postmortems.  No-op when ``HVTPU_FLIGHT=0`` or
    already installed."""
    global ACTIVE, _recorder, _prev_sigusr2
    if not env_enabled():
        return None
    with _install_lock:
        if _recorder is not None:
            return _recorder
        rec = FlightRecorder(rank=rank, size=size, generation=generation,
                             out_dir=out_dir, window=window)
        _recorder = rec
        ACTIVE = True
    _metrics.register_debug_provider("flight", rec.debug_state)
    if sigusr2:
        try:
            _prev_sigusr2 = signal.signal(signal.SIGUSR2, _on_sigusr2)
        except (ValueError, OSError, AttributeError):
            _prev_sigusr2 = None  # non-main thread or odd platform
    rec.note("flight_start",
             {"rank": rank, "size": size, "generation": generation})
    return rec


def uninstall() -> None:
    """Idempotent teardown: flips ACTIVE off first so racing hot-path
    callers see a plain ``False`` before the recorder goes away."""
    global ACTIVE, _recorder, _prev_sigusr2
    with _install_lock:
        ACTIVE = False
        rec, _recorder = _recorder, None
        prev, _prev_sigusr2 = _prev_sigusr2, None
    if rec is None:
        return
    try:
        _metrics.unregister_debug_provider("flight")
    except Exception:
        pass
    if prev is not None:
        try:
            signal.signal(signal.SIGUSR2, prev)
        except (ValueError, OSError):
            pass


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def note(kind: str, **fields) -> None:
    """Append one event.  Callers guard with ``if flight.ACTIVE`` so
    the disabled path is a single attribute test."""
    r = _recorder
    if r is not None:
        r.note(kind, fields or None)


def dump_postmortem(reason: str, *, rank: Any = None,
                    **fields) -> Optional[str]:
    """Write a postmortem now.  Works with no recorder installed (e.g.
    the elastic *driver* on restart-budget exhaustion): a transient
    recorder captures the metrics/debug snapshots with an empty ring —
    but only when ``HVTPU_FLIGHT_DIR`` names a destination, so library
    code calling this on fatal paths never litters an unconfigured
    process's CWD.  Returns the file path, or None (disabled / no
    recorder and no dir / write failure)."""
    r = _recorder
    if r is None:
        if not env_enabled() or not os.environ.get("HVTPU_FLIGHT_DIR"):
            return None
        gen = int(os.environ.get("HVTPU_ELASTIC_GENERATION", "0") or 0)
        r = FlightRecorder(
            rank="driver" if rank is None else rank, generation=gen)
    return r.dump(reason, **fields)


def _on_sigusr2(signum, frame):  # pragma: no cover - signal path
    """On-demand black-box dump (``kill -USR2 <pid>``)."""
    try:
        if ACTIVE:
            note("sigusr2")
        dump_postmortem("sigusr2")
    except Exception:
        pass
    prev = _prev_sigusr2
    if callable(prev):
        try:
            prev(signum, frame)
        except Exception:
            pass
