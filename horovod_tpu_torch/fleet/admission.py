"""Admission control above the priority tiers: per-tenant quotas,
weighted fair-share deficit accounting, and the starvation guard (the
port's copy of ``horovod_tpu/fleet/admission.py``; its metrics under the
same names in the port's registry).

Tenancy config lives in ``<fleet_dir>/tenants.json`` and is
hot-reloaded by mtime every arbiter tick::

    {
      "acme":  {"weight": 2.0, "max_ranks": 64, "max_queued": 8},
      "guest": {"weight": 0.5, "max_ranks": 8},
      "*":     {"weight": 1.0}
    }

- ``weight`` (number > 0, default 1): the tenant's fair share of the
  pool is ``weight / sum(weights of tenants with live jobs)``.
- ``max_ranks`` (int >= 0): cap on the tenant's CONCURRENT allocated
  ranks.  Enforced at job-start time only — hot-reloading a quota
  below a tenant's current usage never kills running jobs, it just
  gates new starts until usage drains below the cap.
- ``max_queued`` (int >= 0): cap on the tenant's queued (PENDING)
  jobs, enforced at intake; over-quota submissions are rejected with
  the tenant and quota named.
- ``"*"`` is the default row for tenants without an explicit entry
  (absent: unlimited, weight 1).

Malformed config is rejected field-by-field à la
:class:`~.job.FleetSpecError` — a broken reload keeps the previous
table in force (the arbiter surfaces the error) rather than dropping
all quotas on the floor.

Fair share: among same-priority pending jobs the arbiter schedules the
tenant FURTHEST BELOW its share first (largest deficit =
``share - used_ranks``), so a burst from one tenant cannot lock out
the others within a tier.

Starvation guard: a pending job older than
``HVTPU_FLEET_STARVATION_SECONDS`` is *aged* — it sorts ahead of every
un-aged tier and may preempt as if it outranked all running jobs — so
a min-priority tenant's queue wait under sustained higher-tier load is
bounded by the threshold plus one drain-grace + relaunch cycle.

Thread safety: instances are owned by the arbiter and only touched
under its ``_lock``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from ..obs import metrics as obs_metrics

__all__ = ["AdmissionController", "TenantConfigError", "TenantPolicy",
           "starvation_s", "M_REJECTS"]

M_REJECTS = obs_metrics.counter(
    "hvtpu_fleet_admission_rejections_total",
    "Submissions refused by the fleet front door (label: reason = "
    "queue_full | tenant_queued_quota | spec_invalid | "
    "duplicate_name | corrupt_record).")

_TENANT_FIELDS = ("weight", "max_ranks", "max_queued")
DEFAULT_TENANT = "default"


def starvation_s() -> float:
    """Age at which a pending job is boosted past every tier (0
    disables the guard)."""
    try:
        v = float(os.environ.get("HVTPU_FLEET_STARVATION_SECONDS",
                                 "900") or 900)
    except ValueError:
        v = 900.0
    return max(0.0, v)


class TenantConfigError(ValueError):
    """One tenants.json field is malformed; names tenant and field."""

    def __init__(self, tenant: str, field: str, message: str):
        self.tenant = tenant
        self.field = field
        super().__init__(f"tenant {tenant!r}: field {field!r}: "
                         f"{message}")


class TenantPolicy:
    """One tenant's validated quota row."""

    def __init__(self, name: str, *, weight: float = 1.0,
                 max_ranks: Optional[int] = None,
                 max_queued: Optional[int] = None):
        self.name = name
        self.weight = weight
        self.max_ranks = max_ranks
        self.max_queued = max_queued

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "TenantPolicy":
        if not isinstance(d, dict):
            raise TenantConfigError(name, "row",
                                    "must be an object of quota fields")
        unknown = sorted(set(d) - set(_TENANT_FIELDS))
        if unknown:
            raise TenantConfigError(
                name, unknown[0],
                f"unknown field (known: {', '.join(_TENANT_FIELDS)})")
        weight = d.get("weight", 1.0)
        if not isinstance(weight, (int, float)) or isinstance(
                weight, bool) or not weight > 0:
            raise TenantConfigError(name, "weight",
                                    f"must be a number > 0, got "
                                    f"{weight!r}")
        out = {"weight": float(weight)}
        for field in ("max_ranks", "max_queued"):
            v = d.get(field)
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise TenantConfigError(
                    field=field, tenant=name,
                    message=f"must be an integer >= 0, got {v!r}")
            out[field] = v
        return cls(name, **out)

    def to_dict(self) -> dict:
        d = {"weight": self.weight}
        if self.max_ranks is not None:
            d["max_ranks"] = self.max_ranks
        if self.max_queued is not None:
            d["max_queued"] = self.max_queued
        return d


def _parse(raw: dict) -> Dict[str, TenantPolicy]:
    if not isinstance(raw, dict):
        raise TenantConfigError("*", "root",
                                "tenants.json must be an object of "
                                "tenant rows")
    return {name: TenantPolicy.from_dict(name, row)
            for name, row in sorted(raw.items())}


class AdmissionController:
    """Hot-reloaded tenant table + quota/fair-share arithmetic."""

    def __init__(self, fleet_dir: Optional[str] = None):
        self.path = (os.path.join(fleet_dir, "tenants.json")
                     if fleet_dir else None)
        self._table: Dict[str, TenantPolicy] = {}
        self._mtime: Optional[float] = None
        self.last_error: Optional[str] = None

    # -- config ----------------------------------------------------------
    def maybe_reload(self) -> Optional[str]:
        """Reload tenants.json when its mtime changed.  Returns
        "reloaded" / an error string / None (unchanged).  A broken
        file keeps the previous table in force."""
        if not self.path:
            return None
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            if self._table or self._mtime is not None:
                self._table, self._mtime = {}, None
                return "reloaded"
            return None
        if mtime == self._mtime:
            return None
        self._mtime = mtime
        try:
            with open(self.path) as f:
                raw = json.load(f)
            self._table = _parse(raw)
        except (OSError, ValueError) as e:
            self.last_error = str(e)
            return f"tenants.json rejected (previous table kept): {e}"
        self.last_error = None
        return "reloaded"

    def load_dict(self, raw: dict) -> None:
        """Install a table directly (tests) — same validation."""
        self._table = _parse(raw)

    def policy(self, tenant: str) -> TenantPolicy:
        p = self._table.get(tenant) or self._table.get("*")
        return p if p is not None else TenantPolicy(tenant)

    # -- quota checks ----------------------------------------------------
    def check_queued(self, tenant: str, queued_now: int
                     ) -> Optional[str]:
        """None when admissible; else a rejection naming tenant and
        quota.  ``queued_now`` counts the tenant's PENDING jobs before
        this submission."""
        p = self.policy(tenant)
        if p.max_queued is not None and queued_now >= p.max_queued:
            return (f"tenant {tenant!r} over quota: {queued_now} jobs "
                    f"already queued (max_queued={p.max_queued})")
        return None

    def check_start(self, tenant: str, used_ranks: int,
                    want_ranks: int) -> Optional[str]:
        """Gate a job start against the concurrent-ranks quota; never
        applied to already-running jobs (shrinking a quota below
        current usage only blocks NEW starts)."""
        p = self.policy(tenant)
        if (p.max_ranks is not None
                and used_ranks + want_ranks > p.max_ranks):
            return (f"tenant {tenant!r} over quota: {used_ranks} ranks "
                    f"in use + {want_ranks} wanted > "
                    f"max_ranks={p.max_ranks}")
        return None

    # -- fair share ------------------------------------------------------
    def deficits(self, used_by_tenant: Dict[str, int],
                 slots_total: int) -> Dict[str, float]:
        """Per-tenant ``share - used``: positive means the tenant is
        below its weighted share of the pool.  Tenants are the keys of
        ``used_by_tenant`` (every tenant with a live job, at 0 use)."""
        if not used_by_tenant:
            return {}
        total_w = sum(self.policy(t).weight for t in used_by_tenant)
        if total_w <= 0:
            return {t: 0.0 for t in used_by_tenant}
        return {t: (self.policy(t).weight / total_w) * slots_total
                   - used
                for t, used in used_by_tenant.items()}

    def debug_state(self) -> dict:
        return {"tenants": {n: p.to_dict()
                            for n, p in sorted(self._table.items())},
                "error": self.last_error}
