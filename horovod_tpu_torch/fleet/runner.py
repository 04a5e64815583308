"""The production job runner: one ElasticDriver per fleet job (the
port's copy of ``horovod_tpu/fleet/runner.py``, over the port's driver).

The arbiter (:mod:`.arbiter`) talks to jobs through a small handle
protocol — ``start`` / ``poll`` / ``request_shrink`` / ``escalate`` /
``update_allocation`` / ``stop`` plus ``phase()`` / ``current_np()`` /
``allocation()`` — so the scheduling core stays pure logic and a
simulator can substitute a virtual-rank runner.  This module is
the real one: each job wraps its OWN :class:`ElasticDriver` on a
daemon thread, with a job-scoped state dir (durable commits), a
job-scoped notice dir (per-rank ``core/preempt.py`` notice files), and
the job's env overlay.

The planned-shrink dance, in driver terms:

1. ``request_shrink(new_np)`` touches the notice files of the
   incarnation's highest ranks (``rank >= new_np``).  Each victim's
   drain watcher fires with source ``file``; the world performs the
   coordinated emergency commit; victims exit ``DRAIN_EXIT_CODE``
   while peers reset — the driver classifies the incarnation as a
   planned ``drain`` (no restart-budget or blacklist strike).
2. The driver's ``listener`` seam delivers ``incarnation_end``
   SYNCHRONOUSLY on the driver thread, BEFORE it re-polls discovery —
   the handle flips its allocation view to the shrunk grant there, so
   the relaunch can never race back up to the old size.
3. If the drain grace expires first, the arbiter calls
   :meth:`escalate`: the shrunk allocation is applied immediately and
   the victims get a bare SIGTERM, which the driver classifies as a
   crash — a **charged** restart, by design (the job burned its grace).

Grow is the existing scale-up path untouched: the allocation view
widens, the driver's discovery poll notices, SIGUSR1s the workers, and
relaunches at the new size.  The port's driver calls that incarnation's
end a ``reset`` and charges no restart for it (the reference's calls it
``restart`` and charges one): the handle resizes on either and counts
only ``restart`` in ``charged_restarts``.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, List, Optional

from ..core import clock
from ..elastic.driver import ElasticDriver

__all__ = ["AllocationDiscovery", "ElasticJobRunner"]


class AllocationDiscovery:
    """The job driver's host 'discovery': the arbiter's current grant.
    Duck-types HostDiscoveryScript (find_available_hosts_and_slots)."""

    def __init__(self, allocation: Optional[Dict[str, int]] = None):
        self._lock = threading.Lock()
        self._alloc: Dict[str, int] = dict(  # hvtpulint: guarded-by(_lock)
            allocation or {})

    def set(self, allocation: Dict[str, int]) -> None:
        with self._lock:
            self._alloc = dict(allocation)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._alloc)


class ElasticJobRunner:
    """Handle protocol implementation over a real ElasticDriver."""

    def __init__(self, job, base_dir: str, *,
                 discovery_interval: float = 0.5,
                 elastic_timeout: float = 600.0,
                 verbose: bool = False):
        spec = job.spec
        self.name = spec.name
        self._dir = os.path.join(base_dir, spec.name)
        self.state_dir = os.path.join(self._dir, "state")
        self.notice_dir = os.path.join(self._dir, "notice")
        # File channel for the fleet health rollup: rank 0's reporter
        # mirrors summaries here (fleet/health.py) and the arbiter's
        # _poll_health reads them off this handle attribute — the
        # arbiter is not a member of the job's coordination world, so
        # the job's KV alone cannot carry health to it.
        self.health_dir = os.path.join(self._dir, "health")
        os.makedirs(self.state_dir, exist_ok=True)
        os.makedirs(self.notice_dir, exist_ok=True)
        os.makedirs(self.health_dir, exist_ok=True)
        self._discovery = AllocationDiscovery()
        self._driver = ElasticDriver(
            command=list(spec.command),
            discovery=self._discovery,
            min_np=spec.min_np,
            max_np=spec.max_np,
            discovery_interval=discovery_interval,
            elastic_timeout=elastic_timeout,
            state_dir=self.state_dir,
            verbose=verbose,
            max_restarts=spec.max_restarts,
            restart_window=spec.restart_window,
            drain_grace=spec.drain_grace,
            notice_dir=self.notice_dir,
            extra_env=self._job_env(spec),
        )
        self._driver.listener = self._on_driver_event
        self._lock = threading.Lock()
        self._alloc: Dict[str, int] = {}  # hvtpulint: guarded-by(_lock)
        self._pending_alloc: Optional[Dict[str, int]] = None  # hvtpulint: guarded-by(_lock)
        self._victims: List[int] = []  # hvtpulint: guarded-by(_lock)
        self._phase = "pending"  # hvtpulint: guarded-by(_lock)
        self._np = 0  # hvtpulint: guarded-by(_lock)
        self._target_np: Optional[int] = None  # hvtpulint: guarded-by(_lock)
        self.charged_restarts = 0
        self.drains = 0
        self._exit: Optional[int] = None
        self._thread: Optional[threading.Thread] = None

    def _job_env(self, spec) -> Dict[str, str]:
        # Workers learn their fleet job name so rank 0's HealthReporter
        # (installed by core/state.init) publishes under the right
        # fleet/<job>/ KV prefix, and the health-file directory the
        # arbiter polls for the rollup.  Explicit spec.env entries win.
        env = dict(spec.env or {})
        env.setdefault("HVTPU_FLEET_JOB", spec.name)
        env.setdefault("HVTPU_FLEET_HEALTH_DIR", self.health_dir)
        return env

    # -- lifecycle ------------------------------------------------------
    def start(self, allocation: Dict[str, int]) -> None:
        with self._lock:
            self._alloc = dict(allocation)
            self._phase = "running"
        self._discovery.set(allocation)
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-job-{self.name}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            self._exit = self._driver.run()
        except Exception:  # noqa: BLE001 — a driver crash fails the job
            self._exit = 1

    def poll(self) -> Optional[int]:
        if self._thread is None or self._thread.is_alive():
            return None
        return self._exit if self._exit is not None else 1

    def stop(self) -> None:
        """Graceful cancel: the whole-job drain path (the driver's own
        SIGTERM handling) — workers reach a commit boundary, then the
        driver escalates through terminate()."""
        self._driver._drain_requested = True

    # -- driver listener (driver thread) --------------------------------
    def _on_driver_event(self, event: str, info: dict) -> None:
        with self._lock:
            if event == "launch":
                self._np = int(info["size"])
                self._phase = "running"
                return
            if event != "incarnation_end":
                return
            outcome = info.get("outcome")
            if outcome == "restart":
                self.charged_restarts += 1
            if outcome == "drain":
                self.drains += 1
            # the port's driver ends an incarnation whose workers all
            # exited at a commit boundary (a reset, exit 73: a grow's
            # SIGUSR1) as "reset", relaunched without a charge, where
            # the reference's says "restart" and charges it; either way
            # the job is resizing
            resized = outcome in ("drain", "restart", "reset")
            apply_pending = self._pending_alloc is not None and resized
            if apply_pending:
                alloc = self._apply_pending_locked()
            if resized:
                self._phase = "resizing"
        if apply_pending:
            self._discovery.set(alloc)
            self._clear_notices()

    def _apply_pending_locked(self) -> Dict[str, int]:  # hvtpulint: requires(_lock)
        alloc = dict(self._pending_alloc)
        self._alloc = alloc
        self._pending_alloc = None
        self._victims = []
        self._target_np = None
        return alloc

    def _clear_notices(self) -> None:
        try:
            for f in os.listdir(self.notice_dir):
                try:
                    os.unlink(os.path.join(self.notice_dir, f))
                except OSError:
                    pass
        except OSError:
            pass

    # -- arbiter-driven resize ------------------------------------------
    def request_shrink(self, new_np: int) -> bool:
        """Start a planned shrink to ``new_np`` ranks via the per-rank
        notice files.  Returns False when there is nothing to shrink
        (already at/below target, or between incarnations — the caller
        retries next tick)."""
        with self._lock:
            slots = list(self._driver.current_slots)
            live = sorted({s.rank for s in slots})
            if not live or len(live) <= new_np:
                return False
            victims = [r for r in live if r >= new_np]
            keep: Dict[str, int] = {}
            for s in slots:
                if s.rank < new_np:
                    keep[s.hostname] = keep.get(s.hostname, 0) + 1
            self._pending_alloc = keep
            self._victims = victims
            self._target_np = new_np
            self._phase = "draining"
        for r in victims:
            path = os.path.join(self.notice_dir, f"rank{r}")
            try:
                with open(path, "w") as f:
                    f.write(f"drain requested at {clock.wall():.3f}\n")
            except OSError:
                pass
        return True

    def escalate(self) -> int:
        """Drain-grace expiry: apply the shrunk allocation NOW and
        SIGTERM the victims.  The driver classifies a bare SIGTERM as a
        crash, so this relaunch is charged to the restart budget — the
        documented cost of blowing the grace window."""
        with self._lock:
            if self._pending_alloc is None:
                return 0
            victims = list(self._victims)
            alloc = self._apply_pending_locked()
        self._discovery.set(alloc)
        self._clear_notices()
        return self._driver.signal_ranks(victims, signal.SIGTERM)

    def update_allocation(self, allocation: Dict[str, int]) -> None:
        """Grow (or administratively retarget) the job's allocation;
        the driver's discovery poll picks it up and resets the world at
        the next commit boundary (existing scale-up semantics)."""
        with self._lock:
            self._alloc = dict(allocation)
        self._discovery.set(allocation)

    # -- read side ------------------------------------------------------
    def phase(self) -> str:
        with self._lock:
            return self._phase

    def current_np(self) -> int:
        with self._lock:
            return self._np

    def target_np(self) -> Optional[int]:
        with self._lock:
            return self._target_np

    def allocation(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._alloc)

    def info(self) -> dict:
        with self._lock:
            return {
                "phase": self._phase,
                "np": self._np,
                "target_np": self._target_np,
                "allocation": dict(self._alloc),
                "charged_restarts": self.charged_restarts,
                "drains": self.drains,
                "state_dir": self.state_dir,
            }
