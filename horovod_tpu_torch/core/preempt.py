"""Graceful preemption: coordinated drain, emergency commit, and a
planned elastic departure.

Counterpart of ``horovod_tpu/core/preempt.py``.  Cloud and spot GPUs are
lost to *planned* events (reclaims, maintenance) far more often than to
crashes.  Without this module a SIGTERM'd worker dies mid-collective:
peers hit stall aborts, and training rolls back to the last periodic
commit.  With it, the notice window is used:

1. **Notice**: the departing rank learns it is going away from the
   configured signal (``HVTPU_PREEMPT_SIGNAL``, default SIGTERM), a
   polled notice file (``HVTPU_PREEMPT_NOTICE_FILE``), or the
   fault-injection action ``preempt`` (``core/faults.py``).  The watcher
   thread publishes ``hvtdrain/<generation>/notice/<rank>`` through the
   coordination client (``core/kv.py``'s ``StoreKV`` under the fenced,
   journaled wrapper of ``core/retry.py``), so every peer observes the
   pending departure within one poll.

2. **Drain commit**: at its next commit boundary the departing rank
   publishes ``plan/<rank> = commit_count + 1``, the commit count every
   rank must reach before draining.  Commit counts advance in lockstep
   (the elastic contract), so all ranks reach the agreed boundary
   together and the drain commit is made durable on every rank.

3. **Planned exit**: after the drain commit the departing rank exits
   with :data:`DRAIN_EXIT_CODE` (79); peers raise
   :class:`~.exceptions.DrainInterrupt` so the committed state stands
   (no rollback) and exit with the reset code (73).  The next
   incarnation resumes from the drain commit: zero lost steps.

The exchange is bounded by ``HVTPU_DRAIN_GRACE_SECONDS``: with no commit
boundary in time, the departing rank force-exits with
:data:`DRAIN_EXIT_CODE` anyway.  During the grace window the stall
watchdog (``comm/stall.py``) reports "rank N draining" instead of
aborting, and the async controller (``eager/controller.py``) stops
predicting and drains its burst gate at once.

A SIGTERM handler runs on the main thread between bytecodes: a main
thread parked in a long CUDA or gloo wait delays it, while the notice
file is polled by the watcher thread and has no such limit.

Hot-path cost when nothing is draining: one module attribute read
(:data:`PENDING`), the same idiom as ``faults.ACTIVE``.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
from typing import Dict, Optional

from . import clock
from ..obs import flight
from ..obs import metrics as obs_metrics
from ..obs import tracing

logger = logging.getLogger("horovod_tpu_torch")

#: Exit code the elastic driver classifies as a PLANNED departure (no
#: restart-budget strike, no blacklist strike).  Distinct from the
#: worker reset code (73), plain crashes, and signal deaths.
DRAIN_EXIT_CODE = 79

#: Module-level fast path: False means no drain is pending anywhere in
#: the world as seen by this process — commit boundaries and the eager
#: burst gate check this single attribute and skip everything else.
PENDING = False

# KV namespace for the drain protocol; namespaced by the ELASTIC
# generation (env HVTPU_ELASTIC_GENERATION — identical on every rank of
# one incarnation, unlike the per-process init counter) so a relaunched
# world can never read the previous incarnation's markers.
_NS = "hvtdrain"

# Watcher poll interval.  Deliberately a constant, not a knob: at 0.2s
# the notice→peer-visibility latency is far below any realistic grace
# window, and the KV load is one directory read per rank per poll.
_POLL_S = 0.2

_M_NOTICES = obs_metrics.counter(
    "hvtpu_preempt_notices_total",
    "Preemption notices accepted by this rank, by source "
    "(signal | file | fault | api).")
_M_DRAIN_COMMIT_S = obs_metrics.histogram(
    "hvtpu_drain_commit_seconds",
    "Notice-to-drain-commit latency: how much of the preemption grace "
    "window the coordinated emergency commit consumed.")

_coord: Optional["_DrainCoordinator"] = None
_module_lock = threading.Lock()
# Thread-local coordinator override: the fabric simulator (``sim/``)
# installs one _DrainCoordinator a virtual-rank thread, so N ranks' drain
# protocols coexist in one process without sharing the module-global
# fast path.  Nothing else installs one.
_tls = threading.local()



def resolve_signal(name) -> Optional[signal.Signals]:
    """'SIGTERM' / 'TERM' / '15' -> signal.Signals, None if unknown."""
    s = str(name or "").strip()
    if not s:
        return None
    if s.isdigit():
        try:
            return signal.Signals(int(s))
        except ValueError:
            return None
    s = s.upper()
    if not s.startswith("SIG"):
        s = "SIG" + s
    got = getattr(signal, s, None)
    return got if isinstance(got, signal.Signals) else None


def configured_signal() -> signal.Signals:
    """The preemption-notice signal (HVTPU_PREEMPT_SIGNAL, default
    SIGTERM).  Shared with the elastic driver's drain forwarding so
    both sides always speak the same signal."""
    sig = resolve_signal(os.environ.get("HVTPU_PREEMPT_SIGNAL"))
    return sig if sig is not None else signal.SIGTERM


class _DrainCoordinator:
    """Per-process drain state: notice intake, the KV watcher thread,
    and the commit-boundary agreement protocol."""

    def __init__(self, rank: int, size: int, grace_s: float,
                 notice_file: Optional[str], generation: int,
                 client=None, *, start_watcher: bool = True,
                 shared_pending: bool = True, exit_fn=None):
        self._kv = client
        self.rank = rank
        self.size = size
        self.grace_s = max(0.5, float(grace_s))
        self.notice_file = notice_file
        self.gen = generation
        # shared_pending=False (tests): drain state stays per-instance
        # so several coordinators in one process never see each other's
        # notices through the module global.  exit_fn (tests) replaces
        # the process exit.
        self._shared_pending = shared_pending
        self._exit_fn = exit_fn
        self._pending_local = False
        self._lock = threading.Lock()
        # Set from the signal handler WITHOUT the lock (a handler runs
        # on the main thread between bytecodes; taking a non-reentrant
        # lock the interrupted frame may hold would deadlock) — plain
        # attribute writes are atomic under the GIL, and every other
        # accessor tolerates reading them a poll late.
        self._departing = False
        self._reason = ""
        self._notice_t = 0.0
        # watcher-thread-only bookkeeping
        self._notice_posted = False
        # The notice KEY may be posted from either the watcher or the
        # commit thread (see drain_boundary) — separate flag, lock-
        # guarded; a benign double-post of the identical value is the
        # worst a race here can produce.
        self._notice_key_posted = False  # hvtpulint: guarded-by(_lock)
        self._grace_timer: Optional[clock.Timer] = None
        # rank -> first-seen monotonic time of a peer's drain notice
        self._peer_notices: Dict[int, float] = {}  # hvtpulint: guarded-by(_lock)
        self._plans: Dict[int, int] = {}  # hvtpulint: guarded-by(_lock)
        self._plan: Optional[int] = None  # hvtpulint: guarded-by(_lock)
        self._drained = False  # hvtpulint: guarded-by(_lock)
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start_watcher:
            self._thread = threading.Thread(
                target=self._watch_loop, name="hvtpu-preempt-watch",
                daemon=True)
            self._thread.start()

    # -- notice intake (signal-handler safe) ---------------------------
    def notice(self, source: str) -> None:
        """Accept a preemption notice for THIS rank.  Safe to call from
        a signal handler: flag writes and an Event set only — all KV,
        metrics, and tracing work happens on the watcher thread."""
        if self._departing:
            return
        self._reason = source
        self._notice_t = clock.monotonic()
        self._departing = True
        self._mark_pending()
        self._wake.set()

    @property
    def pending(self) -> bool:
        """Any drain pending anywhere in the world, as seen by this
        coordinator (instance state; never the module global)."""
        return self._pending_local

    def _mark_pending(self) -> None:
        self._pending_local = True
        if self._shared_pending:
            global PENDING
            PENDING = True

    # -- watcher -------------------------------------------------------
    def _watch_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                self._poll_once()
            except Exception:
                # the watcher must never take the job down on its own
                logger.debug("preempt watcher error", exc_info=True)
            self._wake.wait(_POLL_S)
            self._wake.clear()

    def _poll_once(self) -> None:
        # 1. polled notice file
        if (not self._departing and self.notice_file
                and os.path.exists(self.notice_file)):
            self.notice("file")
        # 2. publish this rank's departure exactly once
        if self._departing and not self._notice_posted:
            self._notice_posted = True
            _M_NOTICES.inc(source=self._reason)
            logger.warning(
                "preemption notice (%s): rank %d draining; coordinating "
                "an emergency commit within %.0fs grace",
                self._reason, self.rank, self.grace_s)
            if tracing.ACTIVE:
                tracing.instant(
                    "drain_begin", rank=self.rank, source=self._reason,
                    grace_s=self.grace_s)
            if flight.ACTIVE:
                flight.note("drain_begin", rank=self.rank,
                            source=self._reason, grace_s=self.grace_s)
            self._arm_grace_timer()
            self._post_notice_key()
        # 3. observe peers' notices and drain plans
        if self._kv is None or self.size <= 1:
            return
        self._observe_peers()

    def _post_notice_key(self) -> None:
        """Publish this rank's notice marker exactly once (idempotent
        across the watcher and commit threads)."""
        with self._lock:
            if self._notice_key_posted:
                return
            self._notice_key_posted = True
        if self._kv is not None:
            self._kv.key_value_set(
                f"{_NS}/{self.gen}/notice/{self.rank}",
                json.dumps({"reason": self._reason,
                            "grace_s": self.grace_s}))

    def _observe_peers(self) -> None:
        entries = self._dir_entries()
        now = clock.monotonic()
        newly_seen = []
        any_peer = False
        with self._lock:
            for kind, r, v in entries:
                if r == self.rank:
                    continue
                if kind == "notice":
                    any_peer = True
                    if r not in self._peer_notices:
                        self._peer_notices[r] = now
                        newly_seen.append(r)
                elif kind == "plan":
                    any_peer = True
                    try:
                        self._plans[r] = int(v)
                    except (TypeError, ValueError):
                        pass
        for r in newly_seen:
            logger.warning(
                "rank %d draining (preemption notice); emergency "
                "commit at the next agreed step boundary", r)
        if any_peer:
            self._mark_pending()

    def _dir_entries(self):
        """[(kind, rank, value)] under this generation's namespace: one
        directory read a kind (``notice/``, ``plan/``; ``StoreKV`` reads
        a flat prefix with one probe a rank), or one read of the whole
        namespace where the client reads nested keys
        (``nested_dir_get``, the fabric simulator's client, as the JAX
        coordination service does), per-rank try_get when the client has
        no directory read."""
        prefix = f"{_NS}/{self.gen}/"
        out = []
        dir_get = getattr(self._kv, "key_value_dir_get", None)
        if dir_get is not None:
            nested = getattr(self._kv, "nested_dir_get", False) is True
            kinds = ("",) if nested else ("notice/", "plan/")
            try:
                for kind in kinds:
                    for k, v in dir_get(f"{prefix}{kind}"):
                        parts = k.rsplit("/", 2)
                        if len(parts) < 2:
                            continue
                        try:
                            out.append((parts[-2], int(parts[-1]), v))
                        except ValueError:
                            continue
                return out
            except Exception:
                out = []
        for kind in ("notice", "plan"):
            for r in range(self.size):
                if r == self.rank:
                    continue
                try:
                    v = self._kv.key_value_try_get(f"{prefix}{kind}/{r}")
                except Exception:
                    v = None
                if v is not None:
                    out.append((kind, r, v))
        return out

    # -- grace bound ---------------------------------------------------
    def _arm_grace_timer(self) -> None:
        self._grace_timer = clock.call_later(
            self.grace_s, self._grace_expired)

    def _grace_expired(self) -> None:
        with self._lock:
            if self._drained:
                return
        # No commit boundary arrived inside the grace window (the loop
        # may be wedged, or the window was simply too short).  Exit
        # with the DRAIN code anyway: the departure stays planned (no
        # budget/blacklist strike), but progress since the last durable
        # commit is lost — the bounded-grace half of the contract.
        print(
            f"hvtpu.preempt: drain grace ({self.grace_s:.0f}s) expired "
            f"before a commit boundary; rank {self.rank} exiting "
            f"{DRAIN_EXIT_CODE} without a drain commit (planned "
            "departure; progress since the last durable commit is "
            "lost)", file=sys.stderr, flush=True)
        if tracing.ACTIVE:
            tracing.instant("drain_exit", rank=self.rank,
                            committed=False)
        if flight.ACTIVE:
            flight.note("drain_exit", rank=self.rank, committed=False,
                        grace_s=self.grace_s)
        # force-exit without a commit boundary is a fatal-path story
        # worth a black box: what was the loop doing all grace long?
        flight.dump_postmortem("drain_grace_expired",
                               grace_s=self.grace_s)
        self._planned_exit()

    def _planned_exit(self) -> None:
        """Leave the process with the planned-departure code.  Tests
        substitute ``exit_fn`` and skip the real-process teardown."""
        if self._exit_fn is not None:
            self._exit_fn(DRAIN_EXIT_CODE)
            return
        # Drain any queued background checkpoint writes first: the
        # drain commit may still be sitting in the durable writer's
        # queue, and os._exit skips atexit hooks.
        try:
            from . import durable as core_durable

            core_durable.quiesce_writers()
        except Exception:
            pass
        self._quiesce_data_loaders()
        try:
            from . import state as core_state

            core_state.shutdown()
        except Exception:
            pass
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(DRAIN_EXIT_CODE)

    # -- commit-boundary protocol --------------------------------------
    def drain_boundary(self, commit_count: int) -> bool:
        """Called by ``State.commit()`` (via :func:`drain_boundary`)
        once a drain is pending.  Returns True when THIS commit is the
        agreed drain commit: every published plan (commit-count target)
        has been reached.  The departing rank publishes
        ``commit_count + 1`` on its first boundary after the notice, so
        peers get one full step — including its collectives — to learn
        the plan before anyone drains."""
        post = None
        with self._lock:
            if self._drained:
                return False
            if self._departing and self._plan is None:
                self._plan = commit_count + 1
                post = self._plan
            plans = dict(self._plans)
            if self._plan is not None:
                plans[self.rank] = self._plan
        if post is not None:
            logger.warning(
                "rank %d drain plan: emergency commit at step boundary "
                "%d", self.rank, post)
            if self._kv is not None:
                try:
                    # Key-order invariant: a notice arriving within one watcher
                    # poll of a commit boundary would otherwise publish
                    # the PLAN before the NOTICE, and a peer scanning
                    # between the two reaches its drain commit with no
                    # notice recorded — DrainInterrupt then misattributes
                    # the departure (rank=-1).  Posting the notice here
                    # first guarantees every observer of a plan has also
                    # seen its notice.
                    self._post_notice_key()
                    self._kv.key_value_set(
                        f"{_NS}/{self.gen}/plan/{self.rank}", str(post))
                except Exception:
                    logger.warning(
                        "could not publish the drain plan; peers will "
                        "recover through the collective-failure path",
                        exc_info=True)
        if not plans or commit_count < min(plans.values()):
            return False
        # This is the drain commit: let in-flight eager collectives
        # finish before the durable save so no negotiation is abandoned
        # mid-burst (controller.quiesce is a no-op when idle).
        self._quiesce_controller()
        return True

    def _quiesce_data_loaders(self) -> None:
        """Stop input prefetch threads before the drain exit so none is
        mid-copy when the process leaves.  The drain commit
        already captured the delivered cursor, so parked batches are
        simply re-fetched by the next incarnation."""
        try:
            from ..data.loader import quiesce_all

            quiesce_all()
        except Exception:
            logger.debug("pre-drain data loader quiesce failed",
                         exc_info=True)

    def _quiesce_controller(self) -> None:
        try:
            from . import state as core_state

            c = core_state.global_state().controller
            if c is not None and hasattr(c, "quiesce"):
                c.quiesce(timeout=min(5.0, self.grace_s / 2))
        except Exception:
            logger.debug("pre-drain controller quiesce failed",
                         exc_info=True)

    def finish_drain(self, commit_count: int) -> None:
        """After the drain commit persisted: record telemetry, then
        either exit (departing rank) or raise DrainInterrupt (peers) so
        the committed state stands without a rollback."""
        with self._lock:
            if self._drained:
                return
            self._drained = True
            peer_ranks = sorted(self._peer_notices)
        departing = self._departing
        t0 = self._notice_t
        if not departing:
            # peers measure from their first observation of any notice
            with self._lock:
                t0 = min(self._peer_notices.values(), default=0.0)
        elapsed = (clock.monotonic() - t0) if t0 else 0.0
        _M_DRAIN_COMMIT_S.observe(elapsed)
        if tracing.ACTIVE:
            tracing.instant(
                "drain_commit", rank=self.rank, commit=commit_count,
                departing=departing, waited_s=round(elapsed, 3))
        if flight.ACTIVE:
            flight.note("drain_commit", rank=self.rank,
                        commit=commit_count, departing=departing,
                        waited_s=round(elapsed, 3))
        if self._grace_timer is not None:
            self._grace_timer.cancel()
        if departing:
            print(
                f"hvtpu.preempt: drain commit done at step boundary "
                f"{commit_count} ({elapsed:.1f}s after the notice); "
                f"rank {self.rank} exiting {DRAIN_EXIT_CODE} for a "
                "planned departure", file=sys.stderr, flush=True)
            if tracing.ACTIVE:
                tracing.instant("drain_exit", rank=self.rank,
                                committed=True)
            # production path posts the stall goodbye tombstone and
            # flushes traces before the coordination client goes away
            self._planned_exit()
            return
        from .exceptions import DrainInterrupt

        raise DrainInterrupt(
            rank=peer_ranks[0] if peer_ranks else -1)

    # -- read-side surface ---------------------------------------------
    def draining_ranks(self) -> Dict[int, float]:
        """rank -> grace seconds remaining, for every rank currently
        inside its drain window.  Peer windows are measured from OUR
        first observation of the notice (clock-skew-free, and slightly
        generous — the safe direction for holding a stall abort).
        Entries disappear when the window expires, so normal stall
        semantics resume if a drain wedges."""
        now = clock.monotonic()
        out: Dict[int, float] = {}
        if self._departing:
            rem = self.grace_s - (now - self._notice_t)
            if rem > 0:
                out[self.rank] = rem
        with self._lock:
            peers = dict(self._peer_notices)
        for r, t0 in peers.items():
            rem = self.grace_s - (now - t0)
            if rem > 0:
                out[r] = rem
        return out

    def debug_state(self) -> dict:
        draining = self.draining_ranks()
        with self._lock:
            plans = dict(self._plans)
            if self._plan is not None:
                plans[self.rank] = self._plan
            drained = self._drained
        return {
            "pending": self._pending_local,
            "departing": self._departing,
            "reason": self._reason or None,
            "drained": drained,
            "grace_s": self.grace_s,
            "notice_file": self.notice_file,
            "plans": {str(r): p for r, p in sorted(plans.items())},
            "draining_ranks": {str(r): round(rem, 1)
                               for r, rem in sorted(draining.items())},
        }

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._grace_timer is not None:
            self._grace_timer.cancel()


# -- module surface (what the rest of the framework calls) -------------

def use(coord: Optional["_DrainCoordinator"]) -> None:
    """Install ``coord`` as the CALLING THREAD's drain coordinator (None
    to uninstall).  The fabric simulator gives each virtual-rank thread
    its own coordinator this way; every module-level entry point below
    then routes to it instead of the process-wide one."""
    _tls.coord = coord


def _current() -> Optional["_DrainCoordinator"]:
    c = getattr(_tls, "coord", None)
    return c if c is not None else _coord


def pending() -> bool:
    """Is any drain pending, as seen by the calling thread?  The hot
    path: one thread-local read plus one attribute read."""
    c = getattr(_tls, "coord", None)
    if c is not None:
        return c.pending
    return PENDING


def install(cfg, rank: int, size: int, client=None) -> None:
    """Arm the drain coordinator (called by ``core.state.init`` for
    elastic jobs): start the watcher, install the preemption-signal
    handler, and remember the prior disposition for uninstall."""
    global _coord
    with _module_lock:
        if _coord is not None:
            _uninstall_locked()
        gen = int(os.environ.get("HVTPU_ELASTIC_GENERATION", "0") or 0)
        if hasattr(client, "add_journal_prefix"):
            # Drain accounting is durable history a coordinator-loss
            # relaunch must see: journal this rank's writes under the
            # drain namespace for replay (core/journal.py).
            client.add_journal_prefix(f"{_NS}/")
        _coord = _DrainCoordinator(
            rank=rank, size=size,
            grace_s=getattr(cfg, "drain_grace_seconds", 30.0),
            notice_file=getattr(cfg, "preempt_notice_file", None),
            generation=gen, client=client)
        obs_metrics.register_debug_provider("drain", debug_state)
        signame = getattr(cfg, "preempt_signal", "SIGTERM")
        sig = resolve_signal(signame) or signal.SIGTERM
        coord = _coord

        def handler(signum, frame):
            coord.notice("signal")

        try:
            _prev_handler[:] = [sig, signal.signal(sig, handler)]
        except ValueError:
            # non-main thread (tests importing under a runner thread):
            # signal delivery degrades to the notice file / fault
            # action — worth saying, since a real preemption would
            # then kill the process with the default disposition.
            _prev_handler[:] = []
            logger.warning(
                "could not install the %s preemption handler "
                "(signal.signal outside the main thread); preemption "
                "notices degrade to the notice file / fault action",
                sig.name)


_prev_handler: list = []


def _uninstall_locked() -> None:
    global _coord, PENDING
    if _coord is not None:
        _coord.stop()
        _coord = None
        try:
            obs_metrics.unregister_debug_provider("drain")
        except Exception:
            pass
    if _prev_handler:
        sig, prev = _prev_handler
        _prev_handler[:] = []
        try:
            signal.signal(sig, prev)
        except (ValueError, TypeError):
            pass
    PENDING = False


def uninstall() -> None:
    with _module_lock:
        _uninstall_locked()


def notice(source: str = "api") -> None:
    """Deliver a preemption notice to this rank programmatically (the
    ``preempt`` fault action and tests use this)."""
    coord = _current()
    if coord is None:
        logger.warning(
            "preemption notice (%s) ignored: the drain coordinator is "
            "not installed (non-elastic job, or before init)", source)
        return
    coord.notice(source)


def drain_boundary(commit_count: int) -> bool:
    """True when this commit boundary is the agreed drain commit.
    Callers guard on :func:`pending` first (hot path)."""
    coord = _current()
    if coord is None:
        return False
    return coord.drain_boundary(commit_count)


def finish_drain(commit_count: int) -> None:
    """Complete the drain after the commit persisted: the departing
    rank exits :data:`DRAIN_EXIT_CODE`; peers raise DrainInterrupt."""
    coord = _current()
    if coord is not None:
        coord.finish_drain(commit_count)


def draining_ranks() -> Dict[int, float]:
    """rank -> remaining grace seconds for ranks currently draining
    (stall inspectors report these instead of blaming them)."""
    coord = _current()
    if coord is None:
        return {}
    return coord.draining_ranks()


def debug_state() -> dict:
    coord = _current()
    if coord is None:
        return {"pending": pending(), "installed": False}
    return coord.debug_state()
