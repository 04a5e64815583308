"""Worker-side elastic machinery: the ``hvd.elastic.run`` decorator and
the host-update notification channel.

Counterpart of ``horovod_tpu/elastic/worker.py`` (parity:
``horovod/common/elastic.py`` ``run_fn`` and the reference's worker
notification).  Reconfiguration is restart-based: the decorator ends
the process with a dedicated exit code when the world must change, the
launcher relaunches everyone, and committed state is reloaded through
``state.sync()`` in the fresh incarnation.  Host-update notification
rides SIGUSR1 (SIGUSR2 is the flight recorder's on-demand postmortem).

Exit codes, the reference's: :data:`RESET_EXIT_CODE` (73, re-rendezvous
requested), ``core.preempt.DRAIN_EXIT_CODE`` (79, planned departure) and
``core.retry.FENCE_EXIT_CODE`` (89, this rank self-fenced).

Before its ``os._exit`` the reset path quiesces the durable writer
(a queued commit reaches disk) and tears down through the bounded
``shutdown()``, which aborts the NCCL communicators when the stall
watchdog left a collective behind.
"""

from __future__ import annotations

import functools
import os
import signal
import sys

import logging

from ..core import faults
from ..core import state as core_state
from ..core.retry import FENCE_EXIT_CODE  # noqa: F401  (re-export)
from ..core.exceptions import (DrainInterrupt, HorovodInternalError,
                               HostsUpdatedInterrupt)
from ..obs import flight
from ..obs import metrics as obs_metrics
from .state import State, _HostUpdateFlag

logger = logging.getLogger("horovod_tpu_torch")

# Worker-side elastic telemetry (obs/metrics.py): reset requests by
# cause — the driver's restart counter says HOW OFTEN the world was
# rebuilt; this says WHY (peer crash vs planned membership change).
_M_RESETS = obs_metrics.counter(
    "hvtpu_elastic_worker_resets_total",
    "World-reset requests issued by this worker, by reason "
    "(collective_failure | hosts_updated | peer_drain).")
_M_SIGUSR1_FAILED = obs_metrics.counter(
    "hvtpu_elastic_sigusr1_install_failed_total",
    "Failed attempts to install the driver-notification (SIGUSR1) "
    "handler; membership changes then surface as driver-initiated "
    "restarts only.")

# Exit code the launcher interprets as "re-rendezvous requested" (worker
# hit a recoverable elastic event); anything else non-zero is a crash.
# FENCE_EXIT_CODE (re-exported above from core/retry.py) is the third
# planned status: "this rank self-fenced" — superseded generation or
# expired store lease — which must NOT count as a crash either.
RESET_EXIT_CODE = 73


def _install_sigusr1_handler():
    """SIGUSR1 == 'hosts updated' (parity: the reference's
    WorkerNotificationService HTTP callback setting the host flag)."""

    def handler(signum, frame):
        _HostUpdateFlag.instance().set()

    try:
        signal.signal(signal.SIGUSR1, handler)
    except ValueError:
        # non-main thread: notifications degrade to relaunches only —
        # a real elastic job losing this channel is worth knowing
        # about, so say so instead of degrading silently.
        _M_SIGUSR1_FAILED.inc()
        logger.warning(
            "could not install the SIGUSR1 host-update handler "
            "(signal.signal outside the main thread); membership "
            "notifications degrade to SIGUSR1-kill -> restart instead "
            "of commit-boundary resets")


def note_step() -> None:
    """The ``worker.step`` fault-injection site (core/faults.py),
    invoked by ``State.commit()`` at every commit boundary — the
    canonical 'step' of an elastic loop.  A ``kill`` clause here
    reproduces the worker-dies-mid-training scenario the relaunch
    exists for; the empty-spec cost is one attribute read."""
    if faults.ACTIVE:
        faults.inject("worker.step")


def run(func):
    """Decorator for elastic training functions (parity:
    ``hvd.elastic.run`` / run_fn).

    Usage::

        @hvd.elastic.run
        def train(state, ...):
            while state.epoch < epochs:
                ...
                state.commit()

    On ``HorovodInternalError`` (a peer died mid-collective) the state
    rolls back to the last commit and the process exits with
    RESET_EXIT_CODE so the world is rebuilt; on
    ``HostsUpdatedInterrupt`` (a membership change was signalled) the
    current (committed) state stands and the process exits likewise.
    In the relaunched incarnation ``state.sync()`` restores progress
    from the durable commit.
    """

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        _install_sigusr1_handler()
        if not core_state.is_initialized():
            raise RuntimeError(
                "hvd.init() must be called before an elastic run"
            )
        try:
            state.sync()
            if os.environ.get("HVTPU_ELASTIC_GENERATION", "0") != "0":
                # Relaunched incarnation after a world change: run the
                # user's reset callbacks AFTER sync restored the
                # committed state, so world-size-derived values they
                # rebuild (lr schedules etc.) are not clobbered by the
                # old world's committed copy.  Parity:
                # horovod/common/elastic.py run_fn's state.on_reset()
                # between reset() and the next sync — same net order
                # (callbacks see the new world, then training resumes).
                state.on_reset()
                # Callbacks may be rank-dependent (anything derived
                # from hvd.rank()); a broadcast-only re-sync makes the
                # tracked attributes identical again before training
                # resumes — the reference achieves the same by running
                # callbacks before its sync.
                state.rebroadcast()
            # Verified-identical incarnation start: with the parameter
            # divergence audit enabled (HVTPU_AUDIT_EVERY > 0), prove
            # every rank resumed from the same bytes BEFORE training
            # touches them — a divergence here aborts into the
            # restore/relaunch path below instead of training on
            # silently split replicas (core/audit.py).
            state.audit("elastic.sync")
            return func(state, *args, **kwargs)
        except HorovodInternalError:
            # Peer loss mid-collective: roll back so the durable commit
            # reflects the last good step, then ask for a new world.
            _M_RESETS.inc(reason="collective_failure")
            if flight.ACTIVE:
                flight.note("worker_reset", reason="collective_failure")
            state.restore()
            _exit_for_reset("collective failure")
        except DrainInterrupt as e:
            # A peer drained after a preemption notice
            # (core/preempt.py): the drain commit already persisted
            # this step, so NO restore — the next incarnation resumes
            # from it with zero lost steps.  Must precede the parent
            # HostsUpdatedInterrupt handler.
            _M_RESETS.inc(reason="peer_drain")
            if flight.ACTIVE:
                flight.note("worker_reset", reason="peer_drain",
                            peer=e.rank)
            _exit_for_reset(
                f"peer drain (rank {e.rank} departing, planned)")
        except HostsUpdatedInterrupt:
            _M_RESETS.inc(reason="hosts_updated")
            if flight.ACTIVE:
                flight.note("worker_reset", reason="hosts_updated")
            _exit_for_reset("hosts updated")
        except BaseException as e:
            # Unhandled user/runtime exception: this process is about
            # to die on a path nobody anticipated — exactly what the
            # black box exists for.  Dump, then re-raise untouched.
            if not isinstance(e, SystemExit) or (e.code or 0) != 0:
                if flight.ACTIVE:
                    flight.note("worker_exception",
                                error=type(e).__name__,
                                detail=str(e)[:300])
                flight.dump_postmortem(
                    "unhandled_exception", error=type(e).__name__)
            raise

    return wrapper


def _exit_for_reset(reason: str):
    print(
        f"hvtpu.elastic: requesting world reset ({reason}); "
        f"exiting {RESET_EXIT_CODE} for a relaunch",
        file=sys.stderr,
        flush=True,
    )
    # os._exit skips atexit hooks: flush queued background checkpoint
    # writes now or the last durable commit may never reach disk.
    try:
        from ..core import durable as core_durable

        core_durable.quiesce_writers()
    except Exception:
        pass
    # the bounded teardown: a collective the stall watchdog abandoned
    # gets its NCCL communicators aborted (core/state.py)
    try:
        core_state.shutdown()
    except Exception:
        pass
    # os._exit: a peer's death may have wedged the groups; a normal exit
    # could hang in the interpreter's teardown.
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(RESET_EXIT_CODE)
