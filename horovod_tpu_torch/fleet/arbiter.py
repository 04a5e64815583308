"""The multi-job resource arbiter: one pool, N jobs, gang scheduling,
priority preemption via graceful drain, autoscaling hooks (the port's
copy of ``horovod_tpu/fleet/arbiter.py``: the same pool, specs and
clock give the same ``debug_state()``, events and ``state.json`` bytes).

The arbiter promotes the one-job ElasticDriver into a fleet: it owns a
:class:`~horovod_tpu_torch.elastic.discovery.HostManager` over the POOL's
discovery (the same cooldown-blacklist machinery the single-job driver
uses) and divides the discovered slots among jobs.  Everything is
driven by :meth:`tick` — a pure, lock-held scheduling pass over
arbiter state — so the production loop (:meth:`run`, real clock
thread), the CLI server, fake-clock tests, and a simulator calling
``tick()`` on virtual time all run the SAME logic.

Scheduling policy (deterministic by construction):

- **Gang scheduling.**  A job launches only when its full ``min_np``
  allocation is free — never a partial gang.  Pending jobs are visited
  in (priority desc, submit order) order; a small job behind a starved
  big one may backfill (no slot is held idle waiting), because the big
  one acquires its gang through preemption, not accumulation.
- **Start-time expansion.**  When every pending job has been placed,
  freshly-started jobs widen toward ``max_np`` with the leftover slots
  (free — the job has not launched yet).  Already-RUNNING jobs never
  auto-expand; growth is the autoscaler's (or an operator's) call,
  because a grow costs the job a commit-boundary reset.
- **Priority preemption.**  A pending job that cannot fit may reclaim
  slots from strictly-lower-priority RUNNING jobs, shrinking each
  victim toward its ``min_np`` — never evicting below it.  Victim
  order is lowest priority first, and within a tier the YOUNGEST job
  (highest submit_seq) yields first; ``submit_seq`` is unique, so
  selection is a total order (the tie-break determinism tests pin
  this).  The shrink rides the planned-drain channel: per-rank
  ``core/preempt.py`` notice files → coordinated emergency commit →
  ``DRAIN_EXIT_CODE`` exits → a resize with zero lost steps and no
  restart-budget or blacklist strike.  If the drain grace expires, the
  arbiter escalates (SIGTERM) and the victim pays a charged restart.
- **Fail fast.**  A pending job whose ``min_np`` exceeds the pool's
  total discovered capacity can never run; it FAILs immediately with a
  diagnostic naming both numbers.

Thread safety: ``_lock`` guards all arbiter state; ``tick``/``submit``
/``cancel``/``debug_state`` take it.  Job handles have their own
internal locks and never call back into the arbiter.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Callable, Dict, List, Optional

from ..core import clock
from ..elastic.discovery import HostManager
from ..obs import metrics as obs_metrics
from . import admission as admission_mod
from . import intake as intake_mod
from . import job as job_mod
from .autoscale import Autoscaler
from .job import (DONE, DRAINING, FAILED, FleetSpecError, Job, JobSpec,
                  PENDING, RESIZING, RUNNING, STATES)
from .placement import PlacementPolicy

__all__ = ["FleetArbiter"]

_M_JOBS = obs_metrics.gauge(
    "hvtpu_fleet_jobs",
    "Fleet jobs per lifecycle state (label: state).")
_M_SLOTS_TOTAL = obs_metrics.gauge(
    "hvtpu_fleet_pool_slots_total",
    "Schedulable slots in the fleet pool (discovered minus "
    "blacklist-cooldown hosts).")
_M_SLOTS_USED = obs_metrics.gauge(
    "hvtpu_fleet_pool_slots_used",
    "Pool slots currently allocated to live jobs.")
_M_PREEMPTIONS = obs_metrics.counter(
    "hvtpu_fleet_preemptions_total",
    "Planned shrinks the arbiter issued on lower-priority jobs "
    "(priority preemption + autoscale shrinks), via the graceful-"
    "drain channel.")
_M_QUEUE_WAIT = obs_metrics.histogram(
    "hvtpu_fleet_queue_wait_seconds",
    "Submit-to-launch wait per job: how long the gang waited for its "
    "full min-world allocation.")
_M_RESIZE_S = obs_metrics.histogram(
    "hvtpu_fleet_resize_seconds",
    "Arbiter-initiated resize latency: shrink request to the victim "
    "running again at its new size.")
_M_AUTOSCALE = obs_metrics.counter(
    "hvtpu_fleet_autoscale_events_total",
    "Autoscale decisions applied (label: direction = grow | shrink).")
_M_JOB_STEP_RATE = obs_metrics.gauge(
    "hvtpu_fleet_job_step_rate",
    "Per-job EWMA optimizer steps/second from the latest fleet health "
    "summary (label: job; 0 until the job publishes).")
_M_JOB_INCIDENTS = obs_metrics.gauge(
    "hvtpu_fleet_job_incidents",
    "Per-job total anomaly incidents from the latest fleet health "
    "summary (label: job).")
_M_QUEUE_DEPTH = obs_metrics.gauge(
    "hvtpu_fleet_queue_depth",
    "PENDING jobs per priority tier (label: tier).")
_M_JOB_STALL_AGE = obs_metrics.gauge(
    "hvtpu_fleet_job_stall_age_seconds",
    "Per-job stall age from the latest fleet health summary: seconds "
    "since the last completed step while a newer stall warning is "
    "outstanding; 0 when healthy (label: job).")


class FleetArbiter:
    """One shared pool serving N prioritised elastic jobs."""

    def __init__(self, discovery, *,
                 fleet_dir: Optional[str] = None,
                 tick_s: Optional[float] = None,
                 drain_grace_s: Optional[float] = None,
                 runner_factory: Optional[Callable[[Job], object]] = None,
                 event_fn: Optional[Callable[..., None]] = None,
                 blacklist_cooldown: Optional[float] = None,
                 verbose: bool = False,
                 register_debug: bool = True,
                 health_client=None):
        self.hosts = HostManager(discovery,
                                 cooldown_base_s=blacklist_cooldown)
        if fleet_dir is None:
            fleet_dir = os.environ.get("HVTPU_FLEET_DIR")
        self.fleet_dir = fleet_dir
        if tick_s is None:
            tick_s = float(
                os.environ.get("HVTPU_FLEET_TICK_SECONDS", "1") or 1)
        self.tick_s = tick_s
        if drain_grace_s is None:
            drain_grace_s = float(
                os.environ.get("HVTPU_FLEET_DRAIN_GRACE_SECONDS", "30")
                or 30)
        self.drain_grace_s = drain_grace_s
        self._event_fn = event_fn
        self.verbose = verbose
        if runner_factory is None:
            base = (os.path.join(fleet_dir, "jobs") if fleet_dir
                    else tempfile.mkdtemp(prefix="hvtpu_fleet_"))

            def runner_factory(j, _base=base):
                from .runner import ElasticJobRunner

                return ElasticJobRunner(j, _base, verbose=self.verbose)

        self._runner_factory = runner_factory
        # Optional KV client reaching the jobs' prefixed health keys
        # (fleet/health.py): each tick pulls fleet/<job>/health and
        # folds it into state.json + the per-job fleet gauges.
        self._health_client = health_client
        self._lock = threading.RLock()
        self.jobs: Dict[str, Job] = {}  # hvtpulint: guarded-by(_lock)
        self._autoscalers: Dict[str, Autoscaler] = {}  # hvtpulint: guarded-by(_lock)
        self._submit_seq = 0  # hvtpulint: guarded-by(_lock)
        self._pool_seen = False  # hvtpulint: guarded-by(_lock)
        # front door: indexed intake + admission + placement (all
        # touched only under _lock — see their module docstrings)
        self._journal = (intake_mod.SubmitJournal(fleet_dir)
                         if fleet_dir else None)
        self._intake_budget = intake_mod.intake_budget()
        self._admission = admission_mod.AdmissionController(fleet_dir)
        self._placement = PlacementPolicy()
        self._depth_tiers: set = set()  # hvtpulint: guarded-by(_lock)
        self._stop = threading.Event()
        self._registered_debug = register_debug
        if register_debug:
            obs_metrics.register_debug_provider("fleet", self.debug_state)

    # -- events ---------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        if self._event_fn is not None:
            self._event_fn(f"fleet.{kind}", **fields)
        if self.verbose:
            detail = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"hvtpu.fleet: {kind} {detail}", flush=True)

    # -- submit / cancel -------------------------------------------------
    def submit(self, spec: JobSpec) -> Job:
        """Queue a validated spec; duplicate live names are rejected
        (the name keys the state dir and KV prefix)."""
        with self._lock:
            return self._submit_locked(spec)

    def _submit_locked(self, spec: JobSpec) -> Job:  # hvtpulint: requires(_lock)
        existing = self.jobs.get(spec.name)
        if existing is not None and not existing.terminal:
            raise FleetSpecError(
                "name", f"job {spec.name!r} already exists "
                f"(state {existing.state})")
        self._submit_seq += 1
        job = Job(spec, self._submit_seq)
        self.jobs[spec.name] = job
        if spec.autoscale is not None:
            asc = Autoscaler.from_spec(spec.autoscale)
            if asc is not None:
                self._autoscalers[spec.name] = asc
            else:
                self._event("autoscale_unconfigured", job=spec.name)
        self._event("submit", job=spec.name, priority=spec.priority,
                    min_np=spec.min_np, max_np=spec.max_np)
        return job

    def attach_autoscaler(self, name: str, autoscaler: Autoscaler
                          ) -> None:
        with self._lock:
            if name not in self.jobs:
                raise KeyError(f"unknown job {name!r}")
            self._autoscalers[name] = autoscaler

    def cancel(self, name: str) -> bool:
        with self._lock:
            return self._cancel_locked(name)

    def _cancel_locked(self, name: str) -> bool:  # hvtpulint: requires(_lock)
        job = self.jobs.get(name)
        if job is None or job.terminal:
            return False
        job.cancelled = True
        if job.state == PENDING:
            job.to(FAILED, reason="cancelled")
        elif job.handle is not None:
            job.handle.stop()  # whole-job graceful drain
        self._event("cancel", job=name, state=job.state)
        return True

    # -- the scheduling pass ---------------------------------------------
    def tick(self) -> None:
        """One full arbiter pass: journal+spool intake → pool refresh
        → reap → fail-fast → gang schedule (+preempt) → autoscale →
        publish → journal-cursor commit (after state.json persists)."""
        with self._lock:
            # reload tenants BEFORE intake: queued-quota checks on the
            # first post-(re)start tick must see the current table, or
            # a journal backlog slips past admission un-quota'd
            self._reload_tenants()
            self._intake_journal()
            self._intake_spool()
            self._refresh_pool()
            self._reap()
            self._fail_oversized()
            self._schedule()
            self._autoscale_tick()
            self._poll_health()
            self._publish()
            # cursor commit LAST: _publish wrote state.json, so the
            # intaken batch is durable before its records are skipped
            self._commit_journal()

    def _refresh_pool(self) -> None:  # hvtpulint: requires(_lock)
        try:
            self.hosts.refresh()
        except Exception as e:  # noqa: BLE001 — transient discovery failure
            self._event("discovery_error", error=str(e)[:200])
            return
        if self.hosts.last_found:
            self._pool_seen = True

    def _live_jobs(self) -> List[Job]:  # hvtpulint: requires(_lock)
        return [j for j in self.jobs.values() if not j.terminal]

    def _free_map(self) -> Dict[str, int]:  # hvtpulint: requires(_lock)
        """host → unallocated schedulable slots (negative clamped: a
        pool that shrank below its allocations frees nothing)."""
        free = dict(self.hosts.current)
        for j in self._live_jobs():
            for h, n in j.allocation.items():
                if h in free:
                    free[h] -= n
        return {h: n for h, n in free.items() if n > 0}

    def _tenant_used(self) -> Dict[str, int]:  # hvtpulint: requires(_lock)
        """tenant → currently allocated ranks across its live jobs
        (PENDING jobs contribute their tenant key at 0 use)."""
        used: Dict[str, int] = {}
        for j in self._live_jobs():
            t = j.spec.tenant_key
            used[t] = used.get(t, 0) + sum(j.allocation.values())
        return used

    def _reap(self) -> None:  # hvtpulint: requires(_lock)
        """Adopt every handle's view: exits, phase changes, live
        allocations, charged restarts, drain-grace escalation."""
        now = clock.monotonic()
        for j in self._live_jobs():
            h = j.handle
            if h is None:
                continue
            j.charged_restarts = j.restarts_base + h.charged_restarts
            code = h.poll()
            if code is not None:
                j.exit_code = code
                j.allocation = {}
                if j.cancelled:
                    j.to(FAILED, reason="cancelled")
                elif code == 0:
                    j.to(DONE)
                else:
                    j.to(FAILED, reason=f"exit {code}")
                self._event("job_end", job=j.name, state=j.state,
                            code=code,
                            charged_restarts=j.charged_restarts)
                continue
            phase = h.phase()
            if j.state == DRAINING:
                if phase == "resizing":
                    j.to(RESIZING)
                elif phase == "running" and h.target_np() is None:
                    # drain landed and the relaunch won the race with
                    # this tick
                    self._finish_resize(j, now)
                elif (j.shrink_deadline is not None
                      and now >= j.shrink_deadline
                      and not j.shrink_escalated):
                    j.shrink_escalated = True
                    n = h.escalate()
                    self._event("drain_grace_expired", job=j.name,
                                signalled=n)
            elif j.state == RESIZING and phase == "running":
                self._finish_resize(j, now)
            elif j.state == RUNNING and phase == "resizing":
                # an external event (spot reclaim drain, crash) is
                # resizing the job without the arbiter asking
                j.to(RESIZING)
            j.allocation = h.allocation()

    def _finish_resize(self, j: Job, now: float) -> None:
        j.to(RUNNING)
        if j.shrink_started_t is not None:
            _M_RESIZE_S.observe(now - j.shrink_started_t)
            self._event("resized", job=j.name,
                        np=j.handle.current_np(),
                        resize_s=round(now - j.shrink_started_t, 6))
        j.shrink_started_t = None
        j.shrink_deadline = None
        j.shrink_escalated = False

    def _fail_oversized(self) -> None:  # hvtpulint: requires(_lock)
        """A gang that can NEVER fit (min_np > the pool's total
        discovered capacity) fails fast with both numbers named."""
        if not self._pool_seen:
            return
        capacity = sum(self.hosts.last_found.values())
        for j in self._live_jobs():
            if j.state == PENDING and j.spec.min_np > capacity:
                j.to(FAILED, reason=(
                    f"min_np={j.spec.min_np} can never fit: the pool "
                    f"has {capacity} total slots"))
                self._event("job_unschedulable_fatal", job=j.name,
                            min_np=j.spec.min_np, capacity=capacity)

    def _reload_tenants(self) -> None:  # hvtpulint: requires(_lock)
        note = self._admission.maybe_reload()
        if note == "reloaded":
            self._event("tenants_reload")
        elif note:
            self._event("tenants_rejected", error=note[:300])

    def _schedule(self) -> None:  # hvtpulint: requires(_lock)
        """Gang schedule the pending queue in admission order: aged
        (starvation-guarded) jobs first, then priority tiers, same-tier
        ties broken by the tenant FURTHEST BELOW its weighted fair
        share, then submit order.  Quota-deferred jobs (tenant at its
        max_ranks cap) park without blocking anyone else."""
        now = clock.monotonic()
        pending = [j for j in self.jobs.values() if j.state == PENDING]
        if not pending:
            return
        used_by_tenant = self._tenant_used()
        slots_total = sum(self.hosts.current.values())
        deficits = self._admission.deficits(used_by_tenant, slots_total)
        age_s = admission_mod.starvation_s()
        aged = set()
        for j in pending:
            if age_s > 0 and now - j.submit_t >= age_s:
                aged.add(j.name)
                if not j.aged_reported:
                    j.aged_reported = True
                    self._event("job_aged", job=j.name,
                                priority=j.spec.priority,
                                waited_s=round(now - j.submit_t, 3))
        order = sorted(pending, key=lambda j: (
            j.name not in aged, -j.spec.priority,
            -deficits.get(j.spec.tenant_key, 0.0), j.submit_seq))
        free = self._free_map()
        min_running_pri = min(
            (v.spec.priority for v in self.jobs.values()
             if v.state == RUNNING and v.handle is not None),
            default=None)
        started: List[Job] = []
        all_placed = True
        for j in order:
            t = j.spec.tenant_key
            quota_msg = self._admission.check_start(
                t, used_by_tenant.get(t, 0), j.spec.min_np)
            if quota_msg is not None:
                if not j.quota_reported:
                    j.quota_reported = True
                    self._event("quota_wait", job=j.name, tenant=t,
                                detail=quota_msg)
                continue  # deferred by policy, not by capacity
            total = sum(free.values())
            if total >= j.spec.min_np:
                alloc = self._placement.carve(
                    free, j.spec.min_np, self.hosts.current)
                self._start_job(j, alloc)
                j.quota_reported = False
                used_by_tenant[t] = (used_by_tenant.get(t, 0)
                                     + sum(alloc.values()))
                started.append(j)
            else:
                all_placed = False
                boosted = j.name in aged
                # preemption can only help when SOME running job sits
                # below this job's (effective) tier — cheap filter so
                # a deep queue never pays O(running) per waiter
                if min_running_pri is not None and (
                        boosted
                        or min_running_pri < j.spec.priority):
                    self._maybe_preempt(j, total, boosted=boosted)
                elif not j.unschedulable_reported:
                    j.unschedulable_reported = True
                    self._event("job_waiting", job=j.name,
                                min_np=j.spec.min_np, free=total,
                                missing=j.spec.min_np - total)
        # start-time expansion: only when nothing is left waiting
        if all_placed:
            for j in sorted(started,
                            key=lambda j: (-j.spec.priority,
                                           j.submit_seq)):
                self._expand_at_start(j, free, used_by_tenant)
        # launch AFTER expansion so each gang starts once, full-width
        for j in started:
            j.handle.start(j.allocation)
            self._event("job_start", job=j.name,
                        np=sum(j.allocation.values()),
                        queue_wait_s=round(j.queue_wait_s or 0.0, 6))

    def _start_job(self, j: Job, alloc: Dict[str, int]) -> None:
        j.allocation = alloc
        j.handle = self._runner_factory(j)
        j.to(RUNNING)
        if j.queue_wait_s is not None:
            _M_QUEUE_WAIT.observe(j.queue_wait_s)

    def _expand_at_start(self, j: Job, free: Dict[str, int],
                         used_by_tenant: Dict[str, int]
                         ) -> None:  # hvtpulint: requires(_lock)
        total = sum(free.values())
        cur = sum(j.allocation.values())
        cap = j.spec.max_np if j.spec.max_np is not None else cur + total
        t = j.spec.tenant_key
        p = self._admission.policy(t)
        if p.max_ranks is not None:
            # the tenant's quota caps growth too (its current use
            # already includes this job's gang)
            cap = min(cap, cur + max(
                0, p.max_ranks - used_by_tenant.get(t, 0)))
        extra = min(cap - cur, total)
        if extra <= 0:
            return
        more = self._placement.carve(free, extra, self.hosts.current,
                                     near=j.allocation)
        for h, n in more.items():
            j.allocation[h] = j.allocation.get(h, 0) + n
        used_by_tenant[t] = (used_by_tenant.get(t, 0)
                             + sum(more.values()))

    def _maybe_preempt(self, j: Job, free_total: int, *,
                       boosted: bool = False
                       ) -> None:  # hvtpulint: requires(_lock)
        """Reclaim ``min_np - free`` slots from strictly-lower-priority
        RUNNING jobs, shrinking each toward its min.  Victim order:
        priority asc, then YOUNGEST first (submit_seq desc) — a unique
        total order.  A ``boosted`` (starvation-aged) job outranks
        every tier, so its wait is bounded by the aging threshold plus
        one drain cycle."""
        need = j.spec.min_np - free_total
        victims = sorted(
            (v for v in self.jobs.values()
             if v.state == RUNNING and v.handle is not None
             and (boosted or v.spec.priority < j.spec.priority)),
            key=lambda v: (v.spec.priority, -v.submit_seq))
        plan = []
        for v in victims:
            if need <= 0:
                break
            cur = sum(v.allocation.values())
            reclaim = min(cur - v.spec.min_np, need)
            if reclaim > 0:
                plan.append((v, cur - reclaim))
                need -= reclaim
        if need > 0:
            if not j.unschedulable_reported:
                j.unschedulable_reported = True
                self._event("job_waiting", job=j.name,
                            min_np=j.spec.min_np, free=free_total,
                            missing=need)
            return
        j.unschedulable_reported = False
        for v, new_np in plan:
            self._start_shrink(v, new_np,
                               reason=f"preempted for {j.name}")

    def _start_shrink(self, v: Job, new_np: int, reason: str) -> None:
        if not v.handle.request_shrink(new_np):
            return  # between incarnations; retried next tick
        now = clock.monotonic()
        v.preemptions += 1
        v.shrink_started_t = now
        v.shrink_deadline = now + self.drain_grace_s
        v.shrink_escalated = False
        v.to(DRAINING, reason=reason)
        _M_PREEMPTIONS.inc()
        self._event("preempt", victim=v.name, to_np=new_np,
                    reason=reason)

    def _autoscale_tick(self) -> None:  # hvtpulint: requires(_lock)
        now = clock.monotonic()
        for name in sorted(self._autoscalers):
            asc = self._autoscalers[name]
            j = self.jobs.get(name)
            if j is None or j.state != RUNNING or j.handle is None:
                continue
            decision = asc.evaluate(now)
            if decision is None:
                continue
            direction, step = decision
            cur = sum(j.allocation.values())
            if direction == "grow":
                free = self._free_map()
                cap = (j.spec.max_np if j.spec.max_np is not None
                       else cur + sum(free.values()))
                pol = self._admission.policy(j.spec.tenant_key)
                if pol.max_ranks is not None:
                    used = self._tenant_used().get(
                        j.spec.tenant_key, 0)
                    cap = min(cap, cur + max(0, pol.max_ranks - used))
                extra = min(step, cap - cur, sum(free.values()))
                if extra <= 0:
                    continue
                more = self._placement.carve(
                    free, extra, self.hosts.current,
                    near=j.allocation)
                alloc = dict(j.allocation)
                for h, n in more.items():
                    alloc[h] = alloc.get(h, 0) + n
                j.allocation = alloc
                j.handle.update_allocation(alloc)
                _M_AUTOSCALE.inc(direction="grow")
                self._event("autoscale", job=name, direction="grow",
                            np=sum(alloc.values()),
                            signal=asc.last_signal)
            else:
                new_np = max(j.spec.min_np, cur - step)
                if new_np >= cur:
                    continue
                _M_AUTOSCALE.inc(direction="shrink")
                self._event("autoscale", job=name, direction="shrink",
                            np=new_np, signal=asc.last_signal)
                self._start_shrink(j, new_np, reason="autoscale")

    # -- crash recovery ---------------------------------------------------
    def recover(self) -> int:
        """Resume from a previous arbiter incarnation's ``state.json``:
        every non-terminal job is resubmitted as PENDING with its
        restart/preemption accounting restored.  Worker processes were
        children of the dead arbiter, so there is nothing to adopt —
        the next tick gang-launches each recovered job afresh and its
        elastic state dir (the durable commit plane) makes the resume
        exact.  Terminal jobs stay forgotten (their record lives in
        the event log).  Returns the number of jobs recovered; a
        missing or unreadable state.json recovers nothing."""
        d = self.fleet_dir
        if not d:
            return 0
        try:
            with open(os.path.join(d, "state.json")) as f:
                state = json.load(f)
        except (OSError, ValueError):
            return 0
        recovered = 0
        with self._lock:
            for row in state.get("jobs", []):
                if not isinstance(row, dict) or row.get("state") in (
                        DONE, FAILED):
                    continue
                spec_d = row.get("spec")
                if not isinstance(spec_d, dict):
                    # a pre-spec state.json (older arbiter): the job
                    # cannot be reconstructed — surface, don't guess
                    self._event("recover_skipped",
                                job=str(row.get("name")),
                                error="state.json row carries no spec")
                    continue
                try:
                    spec = JobSpec.from_dict(spec_d)
                except FleetSpecError as e:
                    self._event("recover_skipped",
                                job=str(row.get("name")),
                                error=str(e)[:300])
                    continue
                existing = self.jobs.get(spec.name)
                if existing is not None and not existing.terminal:
                    continue  # already resubmitted (idempotent recover)
                job = self._submit_locked(spec)
                try:
                    job.preemptions = int(row.get("preemptions") or 0)
                    job.restarts_base = int(
                        row.get("charged_restarts") or 0)
                    job.charged_restarts = job.restarts_base
                except (TypeError, ValueError):
                    pass
                recovered += 1
                self._event("recover", job=job.name,
                            prior_state=row.get("state"))
        return recovered

    # -- indexed intake (journal ↔ arbiter) ------------------------------
    def _intake_journal(self) -> None:  # hvtpulint: requires(_lock)
        """Apply at most ``intake_budget`` journal records in seq
        order.  The cursor is NOT committed here: that happens in
        :meth:`_commit_journal` at the end of the tick, after
        ``state.json`` has persisted the admitted jobs — a crash
        anywhere in between replays the batch (replayed submits dedupe
        against their live job) instead of losing submissions the CLI
        already acknowledged.  Cancels ordered after their submit in
        the journal can also tombstone a record still sitting in the
        LEGACY spool dir, so a cancelled job never surfaces as
        PENDING."""
        jr = self._journal
        if jr is None:
            return
        batch = jr.read_batch(self._intake_budget)
        for rec in batch:
            op = rec.get("op")
            if op == "submit":
                self._apply_journal_submit(rec)
            elif op == "cancel":
                name = str(rec.get("name") or "")
                if not self._cancel_locked(name):
                    self._tombstone_spooled(name)
            else:
                admission_mod.M_REJECTS.inc(reason="corrupt_record")
                self._event("journal_corrupt",
                            seq=int(rec.get("seq") or 0))

    def _commit_journal(self) -> None:  # hvtpulint: requires(_lock)
        """Commit the journal cursor — only called AFTER the jobs
        admitted this tick are durable in ``state.json``.  Ordering
        matters: committing first would open a window where a crash
        loses acknowledged submissions (advanced cursor skips their
        records, state.json never saw them).  The reverse window —
        state persisted, cursor not yet committed — merely replays the
        batch, which ``_apply_journal_submit`` dedupes."""
        if self._journal is not None:
            self._journal.commit(budget=self._intake_budget,
                                 tick_s=self.tick_s)

    def _apply_journal_submit(self, rec: dict) -> None:  # hvtpulint: requires(_lock)
        seq = int(rec.get("seq") or 0)
        try:
            spec = JobSpec.from_dict(rec.get("spec"))
        except FleetSpecError as e:
            admission_mod.M_REJECTS.inc(reason="spec_invalid")
            self._reject(f"journal-{seq}", str(e))
            return
        existing = self.jobs.get(spec.name)
        if existing is not None and not existing.terminal:
            if existing.spec.to_dict() == spec.to_dict():
                # replay of an already-applied record (crash between
                # apply and cursor commit, or recover() raced it):
                # consume silently — exactly-once at the job level
                self._event("journal_duplicate", job=spec.name,
                            seq=seq)
            else:
                admission_mod.M_REJECTS.inc(reason="duplicate_name")
                self._reject(
                    f"journal-{seq}",
                    f"field 'name': job {spec.name!r} already exists "
                    f"(state {existing.state})")
            return
        t = spec.tenant_key
        queued = sum(1 for j in self.jobs.values()
                     if j.state == PENDING
                     and j.spec.tenant_key == t)
        msg = self._admission.check_queued(t, queued)
        if msg is not None:
            admission_mod.M_REJECTS.inc(reason="tenant_queued_quota")
            self._reject(f"journal-{seq}", msg)
            return
        self._submit_locked(spec)

    def _tombstone_spooled(self, name: str) -> None:  # hvtpulint: requires(_lock)
        """A cancel for a job the arbiter has never seen: consume any
        matching legacy spool file so the job never goes PENDING."""
        if not self.fleet_dir or not name:
            return
        path = os.path.join(self.fleet_dir, "submit", f"{name}.json")
        try:
            os.unlink(path)
        except OSError:
            self._event("cancel_unknown", job=name)
            return
        self._event("cancel_spooled", job=name)

    # -- legacy spool protocol (file-per-submit CLI ↔ arbiter) -----------
    def _intake_spool(self) -> None:  # hvtpulint: requires(_lock)
        d = self.fleet_dir
        if not d:
            return
        # cancel markers FIRST: a marker must be able to tombstone a
        # same-tick spool file before that file becomes a PENDING job
        can = os.path.join(d, "cancel")
        if os.path.isdir(can):
            for fn in sorted(os.listdir(can)):
                if not self._cancel_locked(fn):
                    self._tombstone_spooled(fn)
                try:
                    os.unlink(os.path.join(can, fn))
                except OSError:
                    pass
        sub = os.path.join(d, "submit")
        if os.path.isdir(sub):
            for fn in sorted(os.listdir(sub)):
                if not fn.endswith(".json"):
                    continue
                path = os.path.join(sub, fn)
                try:
                    spec = JobSpec.load(path)
                except FleetSpecError as e:
                    self._reject(fn, str(e))
                else:
                    existing = self.jobs.get(spec.name)
                    if (existing is not None and not existing.terminal
                            and existing.spec.to_dict()
                            == spec.to_dict()):
                        # this exact submit already landed — an
                        # arbiter that crashed between intake and
                        # unlink (or recover() beat the spool to it).
                        # Consume the file instead of rejecting the
                        # live job's own spec as a duplicate.
                        self._event("spool_duplicate", spool=fn,
                                    job=spec.name)
                    else:
                        try:
                            self._submit_locked(spec)
                        except FleetSpecError as e:
                            self._reject(fn, str(e))
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _reject(self, fn: str, message: str) -> None:
        self._event("submit_rejected", spool=fn, error=message[:300])
        d = os.path.join(self.fleet_dir, "rejected")
        try:
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, fn + ".error"), "w") as f:
                f.write(message + "\n")
        except OSError:
            pass

    def _poll_health(self) -> None:  # hvtpulint: requires(_lock)
        """Pull each live job's health summary (fleet/health.py) off
        the shared KV when one exists (a shared store client), else off
        the per-job health-file channel the ElasticJobRunner handle
        exposes as ``health_dir``; a missing/None read keeps the
        previous summary so one flaky tick doesn't blank the rollup."""
        from . import health as health_mod

        for j in self._live_jobs():
            summary = None
            if self._health_client is not None:
                summary = health_mod.read(self._health_client, j.name)
            if summary is None:
                hd = getattr(j.handle, "health_dir", None)
                if hd:
                    summary = health_mod.read_file(hd)
            if summary is not None:
                j.health = summary

    def _publish(self) -> None:  # hvtpulint: requires(_lock)
        counts = {s: 0 for s in STATES}
        for j in self.jobs.values():
            counts[j.state] += 1
        for s, c in counts.items():
            _M_JOBS.set(c, state=s)
        total = sum(self.hosts.current.values())
        used = sum(n for j in self._live_jobs()
                   for n in j.allocation.values())
        _M_SLOTS_TOTAL.set(total)
        _M_SLOTS_USED.set(min(used, total) if total else used)
        depth: Dict[int, int] = {}
        for j in self.jobs.values():
            if j.state == PENDING:
                depth[j.spec.priority] = depth.get(
                    j.spec.priority, 0) + 1
        self._depth_tiers |= set(depth)
        for tier in self._depth_tiers:  # zero emptied tiers, not stale
            _M_QUEUE_DEPTH.set(depth.get(tier, 0), tier=str(tier))
        self._placement.fragmentation(self._free_map(),
                                      self.hosts.current)
        for j in self._live_jobs():
            h = j.health
            if h:
                _M_JOB_STEP_RATE.set(
                    float(h.get("step_rate") or 0.0), job=j.name)
                _M_JOB_INCIDENTS.set(
                    float(h.get("incidents_total") or 0.0), job=j.name)
                _M_JOB_STALL_AGE.set(
                    float(h.get("stall_age_s") or 0.0), job=j.name)
        if self.fleet_dir:
            self._write_state_json()

    def _write_state_json(self) -> None:  # hvtpulint: requires(_lock)
        state = self.debug_state_locked()
        path = os.path.join(self.fleet_dir, "state.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(state, f, sort_keys=True, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass

    # -- read side -------------------------------------------------------
    def debug_state(self) -> dict:
        with self._lock:
            return self.debug_state_locked()

    def debug_state_locked(self) -> dict:  # hvtpulint: requires(_lock)
        free = self._free_map()
        out = {
            "t_wall": round(clock.wall(), 3),
            "pool": {
                "hosts": dict(self.hosts.current),
                "blacklisted": self.hosts.blacklisted_now(),
                "slots_total": sum(self.hosts.current.values()),
                "slots_free": sum(free.values()),
            },
            "jobs": [j.info()
                     for j in sorted(self.jobs.values(),
                                     key=lambda j: j.submit_seq)],
            "autoscalers": {n: a.debug_state()
                            for n, a in sorted(
                                self._autoscalers.items())},
            "admission": self._admission.debug_state(),
        }
        if self._journal is not None:
            out["intake"] = {"backlog": self._journal.depth()}
        return out

    def all_terminal(self) -> bool:
        with self._lock:
            return bool(self.jobs) and all(
                j.terminal for j in self.jobs.values())

    # -- loop ------------------------------------------------------------
    def run(self, until_idle: bool = False) -> None:
        """Tick on ``tick_s`` cadence (through the clock seam) until
        :meth:`stop` — or, with ``until_idle``, until every submitted
        job is terminal."""
        while not self._stop.is_set():
            self.tick()
            if until_idle and self.all_terminal():
                return
            clock.sleep(self.tick_s)

    def stop(self) -> None:
        self._stop.set()

    def close(self) -> None:
        self.stop()
        if self._registered_debug:
            try:
                obs_metrics.unregister_debug_provider("fleet")
            except Exception:  # noqa: BLE001 — already unregistered
                pass


# keep the job module import visible for re-exports (fleet/__init__)
_ = job_mod
