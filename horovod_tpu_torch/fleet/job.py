"""Per-job spec, validation, lifecycle state machine, and job-scoped
coordination-KV prefixing for the fleet arbiter (the port's copy of
``horovod_tpu/fleet/job.py``: the same messages, the same key layout).

A *job* is one elastic workload sharing the pool with others: a
command, a priority tier, and a min/max world size.  The arbiter
(:mod:`.arbiter`) owns the lifecycle; this module owns the pieces that
are pure data + validation:

- :class:`JobSpec` — the submit-time contract.  ``from_dict`` /
  ``load`` validate every field and raise :class:`FleetSpecError`
  naming exactly the malformed field, so the CLI's ``submit --spec``
  can fail fast with a precise diagnostic (exit 2), mirroring
  the launcher's ``--fault-spec`` validation.

- The lifecycle state machine::

      PENDING → RUNNING → DONE | FAILED
                   ↓  ↑
               DRAINING → RESIZING → RUNNING

  ``DRAINING`` means an arbiter-initiated planned shrink (priority
  preemption or autoscale) is in flight through the core/preempt.py
  notice channel; ``RESIZING`` covers the window between the drain
  commit and the relaunched incarnation.  Transitions are validated —
  an illegal edge is an arbiter bug, not a recoverable condition.

- :func:`prefixed_client` — a coordination-KV wrapper that namespaces
  every key under ``fleet/<job>/``, so N jobs sharing one KV (the
  reference's simulator; a future shared coordination service) can
  never read each other's drain notices, audit sequences, or elect
  markers.  The wrapper mirrors only the capability tiers the inner
  client actually has (``dir``/``bytes`` probing, same idiom as the
  drain coordinator's ``_dir_entries`` fallback).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

from ..core import clock

__all__ = [
    "DONE",
    "DRAINING",
    "FAILED",
    "FleetSpecError",
    "Job",
    "JobSpec",
    "PENDING",
    "RESIZING",
    "RUNNING",
    "STATES",
    "prefixed_client",
]

PENDING = "PENDING"
RUNNING = "RUNNING"
DRAINING = "DRAINING"
RESIZING = "RESIZING"
DONE = "DONE"
FAILED = "FAILED"

#: Every lifecycle state, in display order (state.json, /debug, gauges).
STATES = (PENDING, RUNNING, DRAINING, RESIZING, DONE, FAILED)

# Legal edges.  DRAINING → RUNNING covers a coarse arbiter tick that
# never observes the intermediate RESIZING phase; DRAINING/RESIZING →
# DONE covers a job finishing while its shrink is still in flight.
_TRANSITIONS = {
    PENDING: {RUNNING, FAILED},
    RUNNING: {DRAINING, RESIZING, DONE, FAILED},
    DRAINING: {RESIZING, RUNNING, DONE, FAILED},
    RESIZING: {RUNNING, DONE, FAILED},
    DONE: set(),
    FAILED: set(),
}


class FleetSpecError(ValueError):
    """A malformed job spec; ``field`` names the offending field so the
    CLI diagnostic (and the unit matrix) can be exact."""

    def __init__(self, field: str, message: str):
        super().__init__(f"field '{field}': {message}")
        self.field = field


# The name becomes a directory (state dir, notice dir) and a KV prefix:
# restrict it accordingly.
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

_SPEC_FIELDS = (
    "name", "command", "priority", "min_np", "max_np", "env",
    "max_restarts", "restart_window", "drain_grace", "autoscale",
    "tenant",
)
_AUTOSCALE_FIELDS = (
    "signal_file", "high", "low", "step", "debounce_s", "cooldown_s",
)


def _require_int(field: str, value: Any, minimum: int) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise FleetSpecError(
            field, f"must be an integer (got {value!r})")
    if value < minimum:
        raise FleetSpecError(
            field, f"must be >= {minimum} (got {value})")
    return value


def _require_num(field: str, value: Any, minimum: float) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise FleetSpecError(
            field, f"must be a number (got {value!r})")
    if value < minimum:
        raise FleetSpecError(
            field, f"must be >= {minimum:g} (got {value})")
    return float(value)


class JobSpec:
    """The submit-time contract for one fleet job."""

    def __init__(self, name: str, command: List[str], *,
                 priority: int = 0, min_np: int = 1,
                 max_np: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None,
                 max_restarts: int = -1, restart_window: float = 0.0,
                 drain_grace: Optional[float] = None,
                 autoscale: Optional[Dict[str, Any]] = None,
                 tenant: Optional[str] = None):
        self.name = name
        # a bare string must reach validate() intact (list("cmd")
        # would explode into single-char "arguments" that pass)
        self.command = (list(command)
                        if isinstance(command, (list, tuple))
                        else command)
        self.priority = priority
        self.min_np = min_np
        self.max_np = max_np
        self.env = (dict(env) if isinstance(env, dict)
                    else ({} if env is None else env))
        self.max_restarts = max_restarts
        self.restart_window = restart_window
        self.drain_grace = drain_grace
        self.autoscale = dict(autoscale) if autoscale else None
        self.tenant = tenant
        self.validate()

    # -- validation -----------------------------------------------------
    def validate(self) -> None:
        """Raise :class:`FleetSpecError` naming the first malformed
        field (the CLI's ``submit --spec`` exit-2 contract)."""
        if not isinstance(self.name, str) or not _NAME_RE.match(
                self.name):
            raise FleetSpecError(
                "name",
                "must match [A-Za-z0-9][A-Za-z0-9._-]{0,63} — it names "
                f"the job's state dir and KV prefix (got {self.name!r})")
        if (not isinstance(self.command, list) or not self.command
                or not all(isinstance(c, str) and c
                           for c in self.command)):
            raise FleetSpecError(
                "command",
                "must be a non-empty list of non-empty strings "
                f"(got {self.command!r})")
        self.priority = _require_int("priority", self.priority, 0)
        self.min_np = _require_int("min_np", self.min_np, 1)
        if self.max_np is not None:
            _require_int("max_np", self.max_np, 1)
            if self.max_np < self.min_np:
                raise FleetSpecError(
                    "max_np",
                    f"must be >= min_np={self.min_np} "
                    f"(got {self.max_np})")
        if not isinstance(self.env, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in self.env.items()):
            raise FleetSpecError(
                "env", f"must be a string→string map (got {self.env!r})")
        self.max_restarts = _require_int(
            "max_restarts", self.max_restarts, -1)
        self.restart_window = _require_num(
            "restart_window", self.restart_window, 0.0)
        if self.drain_grace is not None:
            self.drain_grace = _require_num(
                "drain_grace", self.drain_grace, 0.5)
        if self.tenant is not None and (
                not isinstance(self.tenant, str)
                or not _NAME_RE.match(self.tenant)):
            raise FleetSpecError(
                "tenant",
                "must match [A-Za-z0-9][A-Za-z0-9._-]{0,63} — it keys "
                f"the admission-control quota table (got "
                f"{self.tenant!r})")
        if self.autoscale is not None:
            self._validate_autoscale()

    def _validate_autoscale(self) -> None:
        a = self.autoscale
        if not isinstance(a, dict):
            raise FleetSpecError(
                "autoscale", f"must be an object (got {a!r})")
        for k in a:
            if k not in _AUTOSCALE_FIELDS:
                raise FleetSpecError(
                    f"autoscale.{k}",
                    "unknown field (known: "
                    f"{', '.join(_AUTOSCALE_FIELDS)})")
        for k in ("high", "low"):
            if k not in a:
                raise FleetSpecError(
                    f"autoscale.{k}", "required (signal watermark)")
            _require_num(f"autoscale.{k}", a[k], 0.0)
        if a["low"] >= a["high"]:
            raise FleetSpecError(
                "autoscale.low",
                f"must be < autoscale.high={a['high']} "
                f"(got {a['low']})")
        if "signal_file" in a and (
                not isinstance(a["signal_file"], str)
                or not a["signal_file"]):
            raise FleetSpecError(
                "autoscale.signal_file",
                f"must be a non-empty path (got {a['signal_file']!r})")
        if "step" in a:
            _require_int("autoscale.step", a["step"], 1)
        for k in ("debounce_s", "cooldown_s"):
            if k in a:
                _require_num(f"autoscale.{k}", a[k], 0.0)

    def effective_max(self, cap: Optional[int] = None) -> int:
        """The largest world this job may run at, optionally capped by
        the pool."""
        m = self.max_np if self.max_np is not None else (
            cap if cap is not None else self.min_np)
        return min(m, cap) if cap is not None else m

    # -- (de)serialisation ----------------------------------------------
    @classmethod
    def from_dict(cls, d: Any) -> "JobSpec":
        if not isinstance(d, dict):
            raise FleetSpecError(
                "spec", f"must be a JSON object (got {type(d).__name__})")
        for k in d:
            if k not in _SPEC_FIELDS:
                raise FleetSpecError(
                    k, f"unknown field (known: {', '.join(_SPEC_FIELDS)})")
        for k in ("name", "command"):
            if k not in d:
                raise FleetSpecError(k, "required")
        kwargs = {k: v for k, v in d.items()
                  if k not in ("name", "command")}
        return cls(d["name"], d["command"], **kwargs)

    @classmethod
    def load(cls, path: str) -> "JobSpec":
        """Read + validate a spec file; JSON syntax errors surface as
        ``FleetSpecError('spec', ...)`` so the CLI's exit-2 path is
        uniform."""
        try:
            with open(path) as f:
                raw = json.load(f)
        except OSError as e:
            raise FleetSpecError("spec", f"unreadable: {e}") from e
        except ValueError as e:
            raise FleetSpecError("spec", f"invalid JSON: {e}") from e
        return cls.from_dict(raw)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "command": list(self.command),
            "priority": self.priority, "min_np": self.min_np,
            "max_np": self.max_np, "max_restarts": self.max_restarts,
        }
        if self.env:
            out["env"] = dict(self.env)
        if self.restart_window:
            out["restart_window"] = self.restart_window
        if self.drain_grace is not None:
            out["drain_grace"] = self.drain_grace
        if self.autoscale is not None:
            out["autoscale"] = dict(self.autoscale)
        if self.tenant is not None:
            out["tenant"] = self.tenant
        return out

    @property
    def tenant_key(self) -> str:
        """Admission-control key: the declared tenant, else the shared
        ``default`` bucket."""
        return self.tenant if self.tenant is not None else "default"


class Job:
    """One job's arbiter-side record: spec + state + allocation +
    accounting.  NOT internally locked — every mutation happens under
    the owning arbiter's ``_lock`` (see FleetArbiter)."""

    def __init__(self, spec: JobSpec, submit_seq: int):
        self.spec = spec
        self.submit_seq = submit_seq
        self.state = PENDING
        self.reason = ""
        self.submit_t = clock.monotonic()
        self.start_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.queue_wait_s: Optional[float] = None
        # host → slots granted by the arbiter (the handle may report a
        # smaller live view after an external reclaim; _reap adopts it)
        self.allocation: Dict[str, int] = {}
        self.handle = None  # runner handle, set at start
        self.exit_code: Optional[int] = None
        self.preemptions = 0     # arbiter-initiated planned shrinks
        self.charged_restarts = 0  # budget-charged relaunches observed
        # pre-crash counter recovered from state.json: runner handles
        # count from zero each arbiter incarnation, so _reap reports
        # restarts_base + handle.charged_restarts
        self.restarts_base = 0
        # pending planned shrink: grace deadline — expiry escalates to
        # a charged restart via handle.escalate()
        self.shrink_deadline: Optional[float] = None
        self.shrink_started_t: Optional[float] = None
        self.shrink_escalated = False
        self.cancelled = False
        self.unschedulable_reported = False
        self.aged_reported = False   # starvation-guard boost announced
        self.quota_reported = False  # parked at the tenant ranks cap
        # latest fleet health summary (fleet/health.py), pulled by the
        # arbiter each tick; None until the job publishes one
        self.health: Optional[Dict[str, Any]] = None

    @property
    def name(self) -> str:
        return self.spec.name

    def to(self, state: str, reason: str = "") -> None:
        """Validated lifecycle transition; an illegal edge is an
        arbiter bug and raises."""
        if state == self.state:
            return
        if state not in _TRANSITIONS[self.state]:
            raise RuntimeError(
                f"job {self.name}: illegal transition "
                f"{self.state} → {state}")
        self.state = state
        if reason:
            self.reason = reason
        if state == RUNNING and self.start_t is None:
            self.start_t = clock.monotonic()
            self.queue_wait_s = self.start_t - self.submit_t
        if state in (DONE, FAILED):
            self.finish_t = clock.monotonic()

    @property
    def terminal(self) -> bool:
        return self.state in (DONE, FAILED)

    def info(self) -> Dict[str, Any]:
        """state.json / /debug row (deterministic key order via
        json.dumps(sort_keys=True) downstream)."""
        h = self.handle
        out = {
            "name": self.name,
            # the full spec rides along so a restarted arbiter can
            # resubmit non-terminal jobs from state.json alone
            # (FleetArbiter.recover)
            "spec": self.spec.to_dict(),
            "state": self.state,
            "priority": self.spec.priority,
            "min_np": self.spec.min_np,
            "max_np": self.spec.max_np,
            "allocation": dict(self.allocation),
            "np": h.current_np() if h is not None else 0,
            "reason": self.reason or None,
            "exit_code": self.exit_code,
            "preemptions": self.preemptions,
            "charged_restarts": self.charged_restarts,
            "queue_wait_s": (round(self.queue_wait_s, 6)
                             if self.queue_wait_s is not None else None),
            "health": self.health,
        }
        return out


# ---------------------------------------------------------------------------
# job-scoped KV prefixing
# ---------------------------------------------------------------------------

class _PrefixStr:
    """String-tier prefix wrapper (set/get/try_get/delete)."""

    def __init__(self, client, prefix: str):
        self._kv = client
        self._p = prefix.rstrip("/") + "/"

    def _k(self, key: str) -> str:
        return self._p + key

    def key_value_set(self, key, value):
        return self._kv.key_value_set(self._k(key), value)

    def blocking_key_value_get(self, key, timeout_ms):
        return self._kv.blocking_key_value_get(self._k(key), timeout_ms)

    def key_value_try_get(self, key):
        return self._kv.key_value_try_get(self._k(key))

    def key_value_delete(self, key):
        return self._kv.key_value_delete(self._k(key))


class _PrefixDir(_PrefixStr):
    """Adds the directory tier: results are re-rooted so callers see
    their own namespace, never the prefix."""

    @property
    def nested_dir_get(self) -> bool:
        """The inner client's nested-directory capability (see
        ``core/preempt.py``'s drain scan)."""
        return getattr(self._kv, "nested_dir_get", False) is True

    def key_value_dir_get(self, prefix):
        full = self._k(prefix)
        return [(k[len(self._p):], v)
                for k, v in self._kv.key_value_dir_get(full)]


class _PrefixBytes(_PrefixDir):
    def key_value_set_bytes(self, key, value):
        return self._kv.key_value_set_bytes(self._k(key), value)

    def blocking_key_value_get_bytes(self, key, timeout_ms):
        return self._kv.blocking_key_value_get_bytes(
            self._k(key), timeout_ms)

    def key_value_try_get_bytes(self, key):
        return self._kv.key_value_try_get_bytes(self._k(key))


def prefixed_client(client, job_name: str):
    """Wrap a coordination-KV client so every key lives under
    ``fleet/<job_name>/``.  The wrapper exposes exactly the capability
    tiers the inner client has (probed, like the drain coordinator's
    dir_get fallback), so feature detection downstream stays truthful.
    """
    prefix = f"fleet/{job_name}"
    if hasattr(client, "key_value_set_bytes"):
        return _PrefixBytes(client, prefix)
    if hasattr(client, "key_value_dir_get"):
        return _PrefixDir(client, prefix)
    return _PrefixStr(client, prefix)
