"""Stall watchdog for the sync data plane.

Counterpart of ``horovod_tpu/comm/stall.py`` (parity surface:
``horovod/common/stall_inspector.cc``): names every collective some rank
entered that others did not, warns after ``stall_check_time_seconds``
(``HVTPU_STALL_CHECK_TIME_SECONDS``) and aborts after
``stall_shutdown_time_seconds``.  It covers the sync ops of
``comm/eager.py`` and the optimizer's bucket reduction
(``torch/optimizer.py`` ``GroupReduction``), which otherwise enter a
NCCL or gloo collective that blocks for good when a rank diverges or
dies.  The async controller has its own inspection
(``eager/controller.py``); its threads call :func:`bypass_thread`.

Two modes (``HVTPU_STALL_CHECK_MODE``), as in the reference:

**amortized** (default) — every guarded collective does LOCAL
bookkeeping only (a per-process-set sequence counter, a bounded ring of
recent op descriptors, an in-flight marker); a background heartbeat
thread publishes the snapshot to the coordination store every
``stall_heartbeat_seconds`` (default 0.5) and reads the peers':

- a peer's ring holding a DIFFERENT descriptor at a shared sequence
  number → the ranks diverged onto different collectives → fail,
  naming both ops and the op index;
- this rank in-flight past ``stall_check_time_seconds`` while member
  ranks' counters never reached the op → warn, naming the absent ranks;
- past ``stall_shutdown_time_seconds`` (when > 0) → fail.

"Fail" latches a diagnosis that the data plane raises as
``HorovodInternalError`` at the next op's pre-dispatch check or from the
interruptible completion wait, :meth:`AmortizedStallInspector.
wait_ready`.  That wait never parks the host in a CUDA or gloo wait: it
polls a ``torch.cuda.Event`` recorded on the stream that ran the
collective (``query()``), or the ``Work`` of an async op
(``is_completed()``), with the reference's backoff, and counts a CPU
result as ready.  A NCCL launch returns at once, so this poll is what
keeps the host interruptible on the card; a launch that can block the
calling thread (a cold communicator, a synchronous gloo op) runs on
the inspector's executor thread until the owner has proven its dispatch
asynchronous (:func:`dispatch`).

**strict** — a pre-dispatch rendezvous a collective over the store.

The store client is ``core/kv.py``'s adapter under ``core/retry.py``'s
``FencedKV``; its directory get needs no store feature, so the mode is
never switched for want of one.  A backend error that looks like a
broken transport (:func:`_map_backend_error`: ``torch.distributed``'s
``DistBackendError`` / ``DistNetworkError`` / ``DistStoreError``, the
reference's transport markers, and the text NCCL and
``ProcessGroupNCCL`` put in their errors and timeouts) becomes
``HorovodInternalError``, carrying the watchdog's diagnosis when one
latches within two heartbeats; with ``HVTPU_WIRE_RETRIES`` > 0 it first
goes through ``comm/wirefault.py``'s abort-and-retry consensus.

Observability at the reference's sites: ``hvtpu_stall_warnings_total``,
``hvtpu_stall_aborts_total``, ``hvtpu_stall_heartbeat_age_seconds`` and
``hvtpu_partition_suspect_seconds``; flight-recorder notes of warnings,
aborts, mismatches and partition suspects, and a postmortem on every
abort and mismatch; a ``stall_warning`` trace instant; the ``stall``
/debug provider.

A rank inside its drain grace window (``core/preempt.py``) is late by
design: both inspectors hold the abort for it and report it as
draining, as the reference's do.  In an elastic job the hard-exit path
(:func:`poison_exit_status`) exits with ``RESET_EXIT_CODE`` (73) so the
relaunch feeds the death into recovery.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import threading
from collections import deque
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..core import clock
from ..core import faults
from ..core import preempt
from ..core.exceptions import HorovodInternalError
from ..obs import flight
from ..obs import metrics as obs_metrics
from ..obs import tracing
from . import wirefault

logger = logging.getLogger("horovod_tpu_torch")

# Watchdog telemetry (obs/metrics.py), the reference's families.
_M_HB_AGE = obs_metrics.gauge(
    "hvtpu_stall_heartbeat_age_seconds",
    "Age of the most-stale live peer heartbeat (amortized mode); a "
    "climbing value means a peer stopped beating.")
_M_WARNINGS = obs_metrics.counter(
    "hvtpu_stall_warnings_total", "Stall warnings emitted.")
_M_ABORTS = obs_metrics.counter(
    "hvtpu_stall_aborts_total",
    "Stall/mismatch failures latched or raised (job-fatal).")
_M_SUSPECT_S = obs_metrics.histogram(
    "hvtpu_partition_suspect_seconds",
    "How long silent peers spent in the partitioned-suspect state "
    "(stall blame held) before recovering or being declared dead; "
    "observed at resolution.")


def counters() -> Dict[str, float]:
    """The warning and abort families' process-wide values."""
    return {"stall_warnings": _M_WARNINGS.value(),
            "stall_aborts": _M_ABORTS.value()}

_NS = "hvtstall"      # strict-mode per-op rendezvous marks
_HB = "hvtstallhb"    # amortized-mode heartbeat snapshots
_tls = threading.local()

_RING = 256           # per-set descriptor history kept locally
_POST = 48            # ring tail published in each heartbeat

# Latched when the watchdog abandons a PENDING collective (wait_ready
# raised while the op never completed): a NCCL communicator or a gloo
# thread is then parked inside the dead collective, so a normal
# interpreter teardown (the group's destruction) would hang.  Exit
# paths consult this to hard-exit instead — the reference's stall
# shutdown likewise aborts the process.
_poisoned = False
_poison_gen = -1


def _latch_poison(insp) -> None:
    """Latch only for the INSTALLED inspector: a standalone instance
    (unit tests, tooling) abandoning a fake wait must not hijack the
    whole interpreter's exit path."""
    global _poisoned, _poison_gen
    try:
        from ..core import state as _core_state

        if _core_state.global_state().sync_stall is not insp:
            return
    except Exception:
        return
    _poisoned = True
    _poison_gen = max(_poison_gen, insp.gen)


def poisoned() -> bool:
    """True when a stall/mismatch abort left a stuck collective behind
    and process teardown must not wait on the backend."""
    return _poisoned


def poison_exit_status() -> int:
    """Exit status for the hard-exit path: 0 when the process
    re-initialized into a NEWER generation after the poisoning (the
    wedged collective belongs to an earlier init).  Otherwise the stall
    abort is the terminal event: an ELASTIC job exits with
    ``RESET_EXIT_CODE`` (73) so the relaunch feeds the death into its
    recovery loop instead of scoring a crash; a non-elastic job keeps
    the hard abort (1)."""
    try:
        from ..core import state as _core_state

        if _core_state.global_state().init_generation > _poison_gen:
            return 0
    except Exception:
        pass
    if _elastic_job():
        from ..elastic.worker import RESET_EXIT_CODE

        return RESET_EXIT_CODE
    return 1


def _elastic_job() -> bool:
    """True when this process belongs to an elastic job: from the live
    config when initialized, else from the env (the atexit path runs
    after shutdown() cleared the config)."""
    try:
        from ..core import state as _core_state

        cfg = _core_state.global_state().config
        if cfg is not None:
            return bool(cfg.elastic)
    except Exception:
        pass
    return str(os.environ.get("HVTPU_ELASTIC", "")).strip().lower() in (
        "1", "true", "yes", "on")


def _reset_poison() -> None:
    """Clear the latch (test hook: the poison state is process-global
    and would otherwise leak a hard-exit into unrelated tests)."""
    global _poisoned, _poison_gen
    _poisoned = False
    _poison_gen = -1


def _mismatch_msg(set_id, seq, rank, mine, peer, theirs) -> str:
    return (
        f"collective mismatch at process set {set_id} op #{seq}: this "
        f"rank ({rank}) entered [{mine}] but rank {peer} entered "
        f"[{theirs}]. Ranks have diverged onto different collectives; "
        "this would deadlock or corrupt the wire."
    )


def _stall_abort_msg(desc, set_id, seq, elapsed, abort_s, pending) -> str:
    return (
        f"stalled collective [{desc}] (process set {set_id}, op "
        f"#{seq}): waited {elapsed:.1f}s > stall shutdown time "
        f"{abort_s:.1f}s; ranks not at the rendezvous: {pending}. One "
        "or more ranks skipped this collective or died before "
        "reaching it."
    )


def bypass_thread():
    """Mark the CURRENT thread's eager collectives as exempt from the
    sync watchdog (used by the async controller's cycle thread, whose
    op order is already negotiated and stall-inspected)."""
    _tls.bypass = True


def bypass_active() -> bool:
    """True on threads marked by :func:`bypass_thread`.  The sync data
    plane consults this before opening its own trace span — controller-
    driven dispatches are already spanned by the controller's
    NEGOTIATE/QUEUE/EXEC phases and must not double-trace."""
    return bool(getattr(_tls, "bypass", False))


class SyncStallInspector:
    """Strict mode: per-op rendezvous over the coordination KV."""

    def __init__(self, client, rank: int, warn_s: float, abort_s: float,
                 generation: int = 0):
        self._kv = client
        self.rank = rank
        self.warn_s = warn_s
        self.abort_s = abort_s
        self.gen = generation
        self._seq: Dict[int, int] = {}

    def debug_state(self) -> dict:
        """/debug provider payload (strict mode has no heartbeats; the
        per-set sequence counters are the useful live signal)."""
        return {
            "mode": "strict",
            "rank": self.rank,
            "generation": self.gen,
            "op_seq_per_set": {str(k): v for k, v in self._seq.items()},
        }

    # -- key helpers --------------------------------------------------
    def _key(self, set_id: int, seq: int, rank: int) -> str:
        return f"{_NS}/{self.gen}/{set_id}/{seq}/{rank}"

    def _try_get(self, key: str) -> Optional[str]:
        try:
            return self._kv.key_value_try_get(key)
        except Exception:
            return None

    def _marks(self, set_id: int, seq: int) -> Optional[Dict[int, str]]:
        """All posted marks for (set, seq) in ONE RPC via the KV's
        directory get — the happy path costs one roundtrip regardless
        of P.  Returns None when the client has no usable dir-get
        (test fakes, older clients), so the caller can fall back to
        per-rank try_get; {} means 'working, nothing posted yet'."""
        prefix = f"{_NS}/{self.gen}/{set_id}/{seq}/"
        dir_get = getattr(self._kv, "key_value_dir_get", None)
        if dir_get is None:
            return None
        try:
            return {int(k.rsplit("/", 1)[-1]): v
                    for k, v in dir_get(prefix)}
        except Exception:
            return None

    # -- the rendezvous -----------------------------------------------
    def rendezvous(self, set_id: int, member_ranks, desc: str):
        """Block until every member rank posts a mark for this set's
        next sequence number; warn/abort on deadline."""
        seq = self._seq.get(set_id, 0)
        self._seq[set_id] = seq + 1
        self._kv.key_value_set(self._key(set_id, seq, self.rank), desc)

        pending = [r for r in member_ranks if r != self.rank]
        start = clock.monotonic()
        next_warn = self.warn_s
        sleep = 0.0
        use_dir = True
        while pending:
            found = self._marks(set_id, seq) if use_dir else None
            if found is None:
                use_dir = False
                found = {}
                for r in pending:
                    val = self._try_get(self._key(set_id, seq, r))
                    if val is not None:
                        found[r] = val
            still = []
            for r in pending:
                val = found.get(r)
                if val is None:
                    still.append(r)
                elif val != desc:
                    _M_ABORTS.inc()
                    if flight.ACTIVE:
                        flight.note("collective_mismatch", collective=desc,
                                    process_set=set_id, op_seq=seq,
                                    peer_rank=r, peer_desc=val)
                    flight.dump_postmortem(
                        "collective_mismatch", collective=desc,
                        peer_rank=r)
                    raise HorovodInternalError(
                        _mismatch_msg(set_id, seq, self.rank, desc,
                                      r, val))
            pending = still
            if not pending:
                break
            elapsed = clock.monotonic() - start
            # A rank inside its drain grace window (core/preempt.py) is
            # late BY DESIGN — it is heading for the drain commit, not
            # stuck.  Hold the abort and report it as draining; once
            # the window expires, draining_ranks() empties and normal
            # abort semantics resume.
            draining = preempt.draining_ranks() if preempt.pending() \
                else {}
            blamable = [r for r in pending if r not in draining]
            if self.abort_s > 0 and elapsed > self.abort_s and blamable:
                _M_ABORTS.inc()
                if flight.ACTIVE:
                    flight.note("stall_abort", collective=desc,
                                process_set=set_id, op_seq=seq,
                                waited_s=round(elapsed, 3),
                                ranks_missing=sorted(blamable))
                flight.dump_postmortem(
                    "stall_abort", collective=desc,
                    ranks_missing=sorted(blamable))
                raise HorovodInternalError(
                    _stall_abort_msg(desc, set_id, seq, elapsed,
                                     self.abort_s, blamable))
            if self.warn_s > 0 and elapsed > next_warn and not blamable:
                next_warn += self.warn_s
                for r in sorted(r for r in pending if r in draining):
                    logger.info(
                        "rank %d draining (%.0fs grace remaining); "
                        "holding the stall abort for [%s] "
                        "(process set %s, op #%d)",
                        r, draining.get(r, 0.0), desc, set_id, seq)
            elif self.warn_s > 0 and elapsed > next_warn:
                next_warn += self.warn_s
                _M_WARNINGS.inc()
                logger.warning(
                    "stalled collective [%s] (process set %s, op #%d): "
                    "waited %.1fs; ranks not at the rendezvous: %s",
                    desc, set_id, seq, elapsed, blamable,
                )
                if tracing.ACTIVE:
                    tracing.instant(
                        "stall_warning", collective=desc,
                        process_set=set_id, op_seq=seq,
                        waited_s=elapsed, ranks_missing=sorted(blamable))
                if flight.ACTIVE:
                    flight.note("stall_warning", collective=desc,
                                process_set=set_id, op_seq=seq,
                                waited_s=round(elapsed, 3),
                                ranks_missing=sorted(blamable))
            # back off from a near-spin (normal skew is sub-ms) to a
            # 20ms poll for genuinely late peers
            sleep = min(0.02, sleep * 2 if sleep else 0.0002)
            clock.sleep(sleep)

        # rolling cleanup: every member has posted seq, so nobody can
        # still be waiting on marks older than seq — drop our own
        # previous mark to keep the KV bounded (each rank deletes only
        # its own keys; no cross-rank races)
        if seq > 0:
            try:
                self._kv.key_value_delete(
                    self._key(set_id, seq - 1, self.rank))
            except Exception:
                pass


class _SetTrack:
    """Per-process-set local bookkeeping (amortized mode)."""

    __slots__ = ("seq", "ring", "inflight", "t0", "members", "next_warn")

    def __init__(self):
        self.seq = 0                      # ops STARTED on this set
        # (seq, descriptor, start time) history
        self.ring = deque(maxlen=_RING)
        self.inflight: Optional[str] = None
        self.t0 = 0.0
        self.members: tuple = ()
        self.next_warn = 0.0


class AmortizedStallInspector:
    """Amortized mode: local bookkeeping + background heartbeat.

    See the module docstring for the protocol.  All state shared with
    the heartbeat thread lives behind ``_lock``; the data-plane hooks
    (``pre_op``/``wait_ready``) never perform KV RPCs.
    """

    def __init__(self, client, rank: int, warn_s: float, abort_s: float,
                 heartbeat_s: float = 0.5, generation: int = 0,
                 stale_s: Optional[float] = None,
                 suspect_s: Optional[float] = None,
                 start_heartbeat: bool = True):
        self._kv = client
        self.rank = rank
        self.warn_s = warn_s
        self.abort_s = abort_s
        self.heartbeat_s = max(heartbeat_s, 0.02)
        # a peer whose beat number stops advancing for this long is
        # treated as dead/stalled even if its last snapshot showed it
        # caught up — it may have died MID-collective, after posting
        self.stale_s = (max(5 * self.heartbeat_s, 2.0)
                        if stale_s is None else stale_s)
        # partitioned-vs-dead classification (HVTPU_PARTITION_SUSPECT_S,
        # default 0 = off): a peer stale for (stale_s, stale_s +
        # suspect_s] is a partition SUSPECT — silent because it may be
        # cut off from the KV, not dead — and stall blame is held while
        # it either recovers or self-fences on its own lease
        # (core/retry.py FencedKV).  Past the suspect window it is
        # classified dead and blamed normally.
        self.suspect_s = (
            float(os.environ.get("HVTPU_PARTITION_SUSPECT_S", "0") or 0)
            if suspect_s is None else suspect_s)
        # rank -> when it entered the suspect state; touched only from
        # the heartbeat thread
        self._suspected: Dict[int, float] = {}
        # rank -> (last beat number, when it last changed); touched
        # only from the heartbeat thread
        self._peer_seen: Dict[int, tuple] = {}
        # per-peer wire-link health folded out of this same heartbeat
        # stream (comm/wirefault.py): the beat thread writes arrival
        # gaps / losses, the data plane and /debug read scores
        self.link_health = wirefault.LinkHealth(
            expect_s=max(heartbeat_s, 0.02))
        # lazily-created abort-retry consensus (comm/wirefault.py)
        self._wire_consensus = None
        self.gen = generation
        self._lock = threading.Lock()
        self._tracks: Dict[str, _SetTrack] = {}
        self.failure: Optional[str] = None
        self._beat = 0
        self._stopped = threading.Event()
        # Collective dispatch executor: some backends execute the
        # compiled program synchronously ON the dispatching thread
        # (CPU/Gloo runs the wire exchange inline), which would park
        # the main thread uninterruptibly inside a dead collective.
        # Dispatching from this helper thread keeps the main thread
        # free to observe the failure latch and raise.
        self._exec_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._exec_thread: Optional[threading.Thread] = None
        # owners (module-level ``dispatch``) whose launch returned with
        # its result still pending: their later launches run inline
        self.async_proven: set = set()
        # start_heartbeat=False (fabric simulator): no background
        # thread — the sim pumps _beat_once() itself on virtual time.
        self._thread: Optional[threading.Thread] = None
        if start_heartbeat:
            self._thread = threading.Thread(
                target=self._beat_loop, name="hvt-stall-heartbeat",
                daemon=True)
            self._thread.start()

    # -- data-plane hooks (hot path: no RPCs) --------------------------
    def pre_op(self, set_id, members, desc: str) -> str:
        """Record the op start and return the descriptor (callers
        thread it to ``finish``/``wait_ready`` for re-arm naming);
        raise a latched failure cleanly before dispatching another
        doomed collective."""
        with self._lock:
            if self.failure:
                raise HorovodInternalError(self.failure)
            tr = self._tracks.get(str(set_id))
            if tr is None:
                tr = self._tracks[str(set_id)] = _SetTrack()
            tr.members = tuple(members)
            now = clock.monotonic()
            tr.ring.append((tr.seq, desc, now))
            tr.inflight = desc
            tr.t0 = now
            tr.next_warn = self.warn_s
            tr.seq += 1
        return desc

    def _rearm(self, set_id, desc: Optional[str]) -> None:
        """Re-arm the in-flight marker after a nested negotiation
        collective cleared it — under the OUTER op's descriptor and
        ORIGINAL start time (found in the ring), so a stall during
        the main wire exchange is diagnosed as the op the user
        called, with its true age."""
        with self._lock:
            tr = self._tracks.get(str(set_id))
            if tr is None or tr.inflight is not None or not tr.ring:
                return
            entry = None
            if desc is not None:
                for e in reversed(tr.ring):
                    if e[1] == desc:
                        entry = e
                        break
            if entry is None:
                entry = tr.ring[-1]
            tr.inflight = entry[1]
            tr.t0 = entry[2]
            tr.next_warn = self.warn_s

    def dispatch(self, set_id, fn, args, desc: Optional[str] = None):
        """Run ``fn(*args)`` (the launch of a collective) on the
        executor thread, on the caller's CUDA stream and in its grad
        mode; wait interruptibly so a latched failure aborts this
        rank even when the backend executes synchronously on the
        dispatching thread (a gloo op, a NCCL communicator's lazy
        set-up).  On abort the executor stays parked inside
        the dead collective — the process is poisoned (see
        ``poisoned()``) and exit paths hard-exit.  Returns
        ``(result, pending)`` where ``pending`` is True when the
        result was still in flight the moment ``fn`` returned
        (sampled on the executor thread, before handoff latency can
        hide it) — the caller's async-dispatch proof.  Every error
        path clears the in-flight marker: a failed attempt must never
        trip a later healthy op into a false stall abort (a retry
        re-arms the marker from the ring via ``_rearm``)."""
        with self._lock:
            if self.failure:
                tr = self._tracks.get(str(set_id))
                if tr is not None:
                    tr.inflight = None
                raise HorovodInternalError(self.failure)
        # Fault site ``collective.exec``: the attempt dies on this
        # rank's dispatching thread after bytes may already be in
        # flight — transport-shaped, so the wire retry loop in the
        # module-level ``dispatch`` classifies it as a mid-flight
        # failure (never eligible for a late join).
        if faults.ACTIVE and faults.inject("collective.exec"):
            self._clear_inflight(set_id)
            raise ConnectionError(
                "Connection reset: injected collective.exec fault")
        if threading.current_thread() is self._exec_thread:
            # a launch nested in one the executor runs (a guarded step's
            # own collectives, ``stall_guard``): the caller the executor
            # keeps interruptible is already waiting on this thread
            try:
                out = fn(*args)
            except BaseException:
                self._clear_inflight(set_id)
                raise
            return out, _pending_leaf(out)
        if self._exec_thread is None or not self._exec_thread.is_alive():
            self._exec_thread = threading.Thread(
                target=self._exec_loop, name="hvt-stall-dispatch",
                daemon=True)
            self._exec_thread.start()
        self._rearm(set_id, desc)
        # done, value, error, pending-at-return
        box = [threading.Event(), None, None, False]
        self._exec_q.put((box, fn, args, _caller_context()))
        while not box[0].wait(0.05):
            if self.failure:
                _latch_poison(self)
                self._clear_inflight(set_id)
                # the executor is wedged inside the dead collective;
                # leave it (daemon) and surface the diagnosis
                self._exec_thread = None
                raise HorovodInternalError(self.failure)
        if box[2] is not None:
            # the attempt failed on the executor thread: drop the
            # in-flight marker before surfacing (leak here meant the
            # NEXT healthy op inherited a stale marker and aged into
            # a false stall abort)
            self._clear_inflight(set_id)
            raise box[2]
        return box[1], box[3]

    def _exec_loop(self) -> None:
        while True:
            item = self._exec_q.get()
            if item is None:
                return
            box, fn, args, context = item
            try:
                with context():
                    box[1] = fn(*args)
                # sample async-ness HERE, before handoff latency lets
                # a fast collective finish and hide the evidence
                box[3] = _pending_leaf(box[1])
            except BaseException as e:  # surfaced on the caller thread
                box[2] = e
            finally:
                box[0].set()

    def wait_ready(self, set_id, out, desc: Optional[str] = None) -> None:
        """Interruptible completion wait: poll ``out`` (``_ready_probe``:
        a CUDA event's ``query``, a ``Work``'s ``is_completed``; a CUDA
        tensor gets an event recorded now on its stream) so the
        heartbeat's failure latch can abort a rank that would otherwise
        park forever inside a CUDA or gloo wait.  Completes in one
        check on the healthy path once the result lands; a completed
        ``Work`` is then waited on, which returns at once and raises
        its error if it failed.  ``desc`` names the op being waited on
        (for re-arming after a nested negotiation collective cleared
        the in-flight marker)."""
        is_ready = _ready_probe(out)
        self._rearm(set_id, desc)
        sleep = 0.0
        waited = 0.0
        try:
            while is_ready is not None and not is_ready():
                if self.failure:
                    _latch_poison(self)
                    raise HorovodInternalError(self.failure)
                # back off from a near-spin (small ops land in <1 ms)
                # to a 0.5 ms poll, then to 5 ms once the op has
                # clearly left the small-op regime — bounds both the
                # overshoot (sub-1% of the op at every scale) and the
                # poll rate
                waited += sleep
                cap = 5e-4 if waited < 0.02 else 5e-3
                sleep = min(cap, sleep * 2 if sleep else 5e-5)
                clock.sleep(sleep)
            _settle(out)
        finally:
            # also on error paths (the probe raising, the latch
            # above): a stale marker would trip a later healthy op
            # into a false stall abort
            self._clear_inflight(set_id)
        if self.failure:
            # the collective completed but the job is already failed
            # (e.g. a peer diverged on another set) — surface it now
            raise HorovodInternalError(self.failure)

    def _clear_inflight(self, set_id) -> None:
        with self._lock:
            tr = self._tracks.get(str(set_id))
            if tr is not None:
                tr.inflight = None

    def op_info(self, set_id, desc: Optional[str] = None):
        """``(seq, members, desc)`` of the newest op on this set — the
        wire-consensus identity of a failed attempt (``desc`` falls
        back to the in-flight marker, then the ring tail, because a
        failed attempt already cleared the marker)."""
        with self._lock:
            tr = self._tracks.get(str(set_id))
            if tr is None:
                return 0, (), desc or ""
            d = desc or tr.inflight
            if d is None and tr.ring:
                d = tr.ring[-1][1]
            return tr.seq - 1, tr.members, d or ""

    def wire_consensus(self):
        """This rank's abort-retry consensus over the same fenced KV
        and heartbeat namespace the watchdog already uses (lazy: jobs
        with retries disabled never touch it)."""
        c = self._wire_consensus
        if c is None:
            c = self._wire_consensus = wirefault.WireConsensus(
                self._kv, self.rank, generation=self.gen,
                hb_prefix=f"{_HB}/{self.gen}/")
        return c

    def debug_state(self) -> dict:
        """/debug provider payload: per-peer heartbeat ages (seconds
        since each peer's beat number last advanced).  _peer_seen is
        written only by the heartbeat thread; the snapshot below is an
        intentional racy read of a dict whose values are immutable
        tuples."""
        now = clock.monotonic()
        ages = {str(r): round(now - t, 3)
                for r, (_b, t) in list(self._peer_seen.items())}
        return {
            "mode": "amortized",
            "rank": self.rank,
            "generation": self.gen,
            "heartbeat_s": self.heartbeat_s,
            "stale_s": self.stale_s,
            "suspect_s": self.suspect_s,
            "partition_suspects": sorted(self._suspected),
            "peer_heartbeat_age_s": ages,
            "link_health": self.link_health.snapshot(),
            "failure": self.failure,
            "counters": counters(),
        }

    def stop(self) -> None:
        self._stopped.set()
        if self._exec_thread is not None and self._exec_thread.is_alive():
            self._exec_q.put(None)
            self._exec_thread.join(timeout=2.0)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # a goodbye tombstone, NOT a plain delete: peers must be able
        # to tell a clean exit (don't blame this rank for a stall —
        # e.g. a stall_guard(block=False) marker legitimately left
        # armed after the final step) from a death (do).  It CARRIES
        # any latched failure: an aborting rank usually stops before
        # its next scheduled beat, and without this the peers would
        # never learn the diagnosis — they'd hang in the next
        # collective and die on the torn-down transport instead.
        try:
            # beat+1: strictly greater than any beat a wedged
            # heartbeat thread might still post, so the tombstone
            # always wins the latest-beat selection
            self._kv.key_value_set(
                f"{_HB}/{self.gen}/{self.rank}/{self._beat + 1}",
                json.dumps({"bye": True, "fail": self.failure,
                            "sets": {}}))
        except Exception:
            pass
        for b in (self._beat - 1, self._beat - 2):
            if b >= 0:
                try:
                    self._kv.key_value_delete(
                        f"{_HB}/{self.gen}/{self.rank}/{b}")
                except Exception:
                    pass

    # -- heartbeat -----------------------------------------------------
    def _beat_loop(self) -> None:
        while not self._stopped.wait(self.heartbeat_s):
            try:
                self._beat_once()
            except Exception:
                # the watchdog must never take the job down on its own
                logger.debug("stall heartbeat error", exc_info=True)

    def _beat_once(self) -> None:
        # Fault site ``heartbeat``: drop suppresses this beat entirely
        # (peers see this rank going stale — a wedged heartbeat
        # thread), delay lags it, error rides the _beat_loop catch,
        # kill simulates dying between collectives.
        if faults.ACTIVE and faults.inject("heartbeat"):
            return
        with self._lock:
            now = clock.monotonic()
            sets = {
                sid: {
                    "seq": tr.seq,
                    "ring": [[s, d] for s, d, _t in list(tr.ring)[-_POST:]],
                    "inflight": tr.inflight,
                    "age": (now - tr.t0) if tr.inflight else 0.0,
                }
                for sid, tr in self._tracks.items()
            }
            payload = json.dumps({"fail": self.failure, "sets": sets})
        key = f"{_HB}/{self.gen}/{self.rank}/{self._beat}"
        self._kv.key_value_set(key, payload)
        if self._beat >= 2:
            # rolling cleanup: each rank deletes only its own old beats
            try:
                self._kv.key_value_delete(
                    f"{_HB}/{self.gen}/{self.rank}/{self._beat - 2}")
            except Exception:
                pass
        self._beat += 1
        try:
            entries = self._kv.key_value_dir_get(f"{_HB}/{self.gen}/")
        except Exception:
            return
        latest: Dict[int, tuple] = {}
        for k, v in entries:
            parts = k.rsplit("/", 2)
            if len(parts) < 3:
                continue
            try:
                r, b = int(parts[-2]), int(parts[-1])
            except ValueError:
                continue
            if r == self.rank:
                continue
            if r not in latest or b > latest[r][0]:
                latest[r] = (b, v)
        now = clock.monotonic()
        lh = self.link_health
        for r, (b, _v) in latest.items():
            prev = self._peer_seen.get(r)
            if prev is None:
                self._peer_seen[r] = (b, now)
            elif b != prev[0]:
                # beat advanced: the per-beat arrival gap feeds the
                # link latency EWMA; beats skipped in between count
                # as losses (posted but never seen live)
                lh.observe(r, gap_s=(now - prev[1]) / max(1, b - prev[0]))
                for _ in range(min(3, b - prev[0] - 1)):
                    lh.observe(r, lost=True)
                self._peer_seen[r] = (b, now)
            elif now - prev[1] > 2 * self.heartbeat_s:
                # overdue with no new beat (a flapping link drops
                # them outright): one loss observation per own beat
                # until the peer recovers or goes stale
                lh.observe(r, lost=True)
        lh.publish()
        _M_HB_AGE.set(max(
            (now - t for _b, t in self._peer_seen.values()),
            default=0.0))
        peers: Dict[int, dict] = {}
        bye = set()
        bye_fails = []
        for r, (_b, v) in latest.items():
            try:
                snap = json.loads(v)
            except Exception:
                continue
            if snap.get("bye"):
                bye.add(r)
                if snap.get("fail"):
                    bye_fails.append((r, snap["fail"]))
            else:
                peers[r] = snap
        stale = {r for r, (_b, t) in self._peer_seen.items()
                 if r not in bye and now - t > self.stale_s}
        suspect = set()
        if self.suspect_s > 0:
            # partitioned-vs-dead split by lease age: freshly-stale
            # peers are SUSPECTS (blame held), peers silent past the
            # suspect window are dead (blamed normally)
            for r in list(stale):
                if now - self._peer_seen[r][1] <= (self.stale_s
                                                   + self.suspect_s):
                    suspect.add(r)
            stale -= suspect
            for r in suspect:
                if r not in self._suspected:
                    self._suspected[r] = now
                    if flight.ACTIVE:
                        flight.note("partition_suspect", rank=self.rank,
                                    peer=r)
                    logger.warning(
                        "rank %d heartbeat silent %.1fs: partition "
                        "suspect — holding stall blame for %.1fs",
                        r, now - self._peer_seen[r][1], self.suspect_s)
            for r in list(self._suspected):
                if r not in suspect:
                    _M_SUSPECT_S.observe(now - self._suspected.pop(r))
                    outcome = "dead" if r in stale else "recovered"
                    if flight.ACTIVE:
                        flight.note("partition_resolved",
                                    rank=self.rank, peer=r,
                                    outcome=outcome)
                    logger.info("rank %d left the partition-suspect "
                                "state: %s", r, outcome)
        self._evaluate(peers, stale, bye, bye_fails, suspect=suspect)

    def _evaluate(self, peers: Dict[int, dict],
                  stale: Optional[set] = None,
                  bye: Optional[set] = None,
                  bye_fails: Optional[list] = None,
                  suspect: Optional[set] = None) -> None:
        stale = stale or set()
        bye = bye or set()
        suspect = suspect or set()
        now = clock.monotonic()
        fail: Optional[str] = None
        warns: List[tuple] = []
        drain_notes: List[tuple] = []
        with self._lock:
            if self.failure:
                return
            # a peer that already latched a failure takes the whole job
            # down (reference shutdown-on-stall semantics): surface its
            # diagnosis instead of hanging on our side — including a
            # peer that already STOPPED, whose tombstone carries it
            for r, pf in (bye_fails or []):
                fail = f"rank {r} aborted the job: {pf}"
                break
            if not fail:
                for r, snap in peers.items():
                    pf = snap.get("fail")
                    if pf:
                        fail = f"rank {r} aborted the job: {pf}"
                        break
            for sid, tr in self._tracks.items():
                if fail:
                    break
                mine = {s: d for s, d, _t in tr.ring}
                for r, snap in peers.items():
                    pset = snap.get("sets", {}).get(sid)
                    if not pset:
                        continue
                    # divergence: a shared sequence number whose
                    # descriptor differs — the rings are seq-ordered,
                    # so the first hit is the earliest visible one
                    for s_d in pset.get("ring", []):
                        s, d = s_d[0], s_d[1]
                        md = mine.get(s)
                        if md is not None and md != d:
                            fail = _mismatch_msg(
                                sid, s, self.rank, md, r, d)
                            break
                    if fail:
                        break
                if fail:
                    break
                # stall: we are in-flight past the deadline and some
                # member's counter never reached this op
                if tr.inflight and tr.members:
                    age = now - tr.t0
                    want_abort = self.abort_s > 0 and age > self.abort_s
                    want_warn = self.warn_s > 0 and age > tr.next_warn
                    if not (want_abort or want_warn):
                        continue
                    draining = (preempt.draining_ranks()
                                if preempt.pending() else {})
                    behind = []
                    drain_behind = []
                    for r in tr.members:
                        if r == self.rank or r in bye:
                            # a cleanly-exited rank is never blamed
                            # for a stall (false-positive guard for
                            # markers legitimately armed at exit)
                            continue
                        snap = peers.get(r)
                        pseq = 0
                        if snap is not None:
                            pseq = snap.get("sets", {}).get(
                                sid, {}).get("seq", 0)
                        # a stale peer counts as absent even when its
                        # last snapshot showed it caught up: it may
                        # have died mid-collective, after posting
                        if pseq < tr.seq or r in stale or r in suspect:
                            if r in draining:
                                # inside its drain grace window
                                # (core/preempt.py): heading for the
                                # drain commit, not stuck — report,
                                # don't blame.  The exclusion expires
                                # with the window, unlike bye.
                                drain_behind.append(r)
                            elif r in suspect:
                                # partition suspect: silent because it
                                # may be cut off from the KV, not dead
                                # — hold the blame until it recovers
                                # or ages into the dead set (the
                                # transition was logged in _beat_once)
                                pass
                            else:
                                behind.append(r)
                    if not behind:
                        if drain_behind and want_warn:
                            tr.next_warn = age + self.warn_s
                            for r in sorted(drain_behind):
                                drain_notes.append(
                                    (r, draining.get(r, 0.0),
                                     tr.inflight, sid))
                        # everyone (still blamable) dispatched it: a
                        # slow collective, not a stall
                        continue
                    if want_abort:
                        fail = _stall_abort_msg(
                            tr.inflight, sid, tr.seq - 1, age,
                            self.abort_s, behind)
                    elif want_warn:
                        tr.next_warn = age + self.warn_s
                        warns.append(
                            (tr.inflight, sid, tr.seq - 1, age, behind))
            if fail:
                self.failure = fail
                _M_ABORTS.inc()
                if flight.ACTIVE:
                    flight.note("stall_abort", detail=fail[:300])
                flight.dump_postmortem("stall_abort")
        for r, rem, desc, sid in drain_notes:
            logger.info(
                "rank %d draining (%.0fs grace remaining); holding "
                "the heartbeat abort for [%s] (process set %s)",
                r, rem, desc, sid)
        for desc, sid, op, age, behind in warns:
            _M_WARNINGS.inc()
            logger.warning(
                "stalled collective [%s] (process set %s, op #%d): "
                "waited %.1fs; ranks not at the rendezvous: %s",
                desc, sid, op, age, behind,
            )
            if tracing.ACTIVE:
                tracing.instant(
                    "stall_warning", collective=desc, process_set=sid,
                    op_seq=op, waited_s=age,
                    ranks_missing=sorted(behind))
            if flight.ACTIVE:
                flight.note("stall_warning", collective=desc,
                            process_set=sid, op_seq=op,
                            waited_s=round(age, 3),
                            ranks_missing=sorted(behind))


def _caller_context():
    """The calling thread's grad mode and CUDA stream, as a context
    manager to enter on the executor thread: a launch there must order
    with the caller's work exactly as it would on the caller's
    thread."""
    grad = torch.is_grad_enabled()
    stream = (torch.cuda.current_stream()
              if torch.cuda.is_available() and torch.cuda.is_initialized()
              else None)

    @contextlib.contextmanager
    def context():
        with torch.set_grad_enabled(grad):
            if stream is None:
                yield
            else:
                with torch.cuda.stream(stream):
                    yield
    return context


def _ready_probe(out):
    """A callable that tells whether ``out`` is complete, or None when
    it is complete by construction (a CPU tensor, None).  A CUDA tensor
    gets an event recorded now on its device's current stream, behind
    the work that produced it; a list or tuple is complete when every
    item is."""
    if isinstance(out, torch.Tensor):
        if not out.is_cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        return event.query
    if isinstance(out, (list, tuple)):
        probes = [p for p in map(_ready_probe, out) if p is not None]
        if not probes:
            return None
        return lambda: all(p() for p in probes)
    for name in ("query", "is_completed"):    # an Event; a Work
        probe = getattr(out, name, None)
        if probe is not None:
            return probe
    return None


def _settle(out) -> None:
    """After the poll: wait on each completed ``Work`` of ``out``, which
    returns at once and raises the collective's error if it failed (on
    NCCL it also makes the current stream wait on the work)."""
    if isinstance(out, (list, tuple)):
        for o in out:
            _settle(o)
    elif (not isinstance(out, torch.Tensor)
          and hasattr(out, "is_completed") and hasattr(out, "wait")):
        out.wait()


def _make_inspector(st, cfg):
    """Create the configured inspector over the port's store client
    (``st.kv``, ``core/kv.py``), or latch ``False`` (disabled) when the
    process has none."""
    client = getattr(st, "kv", None)
    if client is not None:
        # Transient store blips (or injected kv.* faults) retry with
        # backoff instead of surfacing through the watchdog as an
        # instant failure, and heartbeats carry this incarnation's
        # fencing token (core/retry.py FencedKV).
        from ..core.retry import fenced_kv

        client = fenced_kv(client, rank=st.rank)
    if client is None:
        st.sync_stall = False
        logger.warning(
            "stall watchdog disabled: no coordination store in this "
            "process, so sync collectives cannot be stall-checked and a "
            "diverged rank will hang instead of aborting with a "
            "diagnosis. (Set HVTPU_STALL_CHECK_DISABLE=1 to silence "
            "this if intentional.)")
        return None
    mode = str(getattr(cfg, "stall_check_mode", "amortized")).lower()
    if mode not in ("amortized", "strict"):
        raise ValueError(
            f"stall_check_mode (HVTPU_STALL_CHECK_MODE) must be "
            f"'amortized' or 'strict', got {cfg.stall_check_mode!r}")
    if mode == "strict":
        insp = SyncStallInspector(
            client, st.rank,
            warn_s=cfg.stall_check_time_seconds,
            abort_s=cfg.stall_shutdown_time_seconds,
            generation=st.init_generation,
        )
    else:
        # the port's client always has the directory get amortized
        # detection reads the heartbeats with: the mode is never
        # switched for want of a store feature
        insp = AmortizedStallInspector(
            client, st.rank,
            warn_s=cfg.stall_check_time_seconds,
            abort_s=cfg.stall_shutdown_time_seconds,
            heartbeat_s=getattr(cfg, "stall_heartbeat_seconds", 0.5),
            generation=st.init_generation,
        )
    st.sync_stall = insp
    obs_metrics.register_debug_provider("stall", insp.debug_state)
    return insp


def check(st, ps, desc: str) -> Optional[str]:
    """The sync ops' pre-dispatch hook: record the op (amortized) or
    rendezvous with the other member ranks (strict), or no-op when
    stall checking cannot or should not engage (single member,
    controller thread, disabled, no store).  Returns the descriptor
    when an op was recorded (pass it to ``finish``), else None."""
    if ps.size <= 1 or getattr(_tls, "bypass", False):
        return None
    cfg = st.config
    if cfg is None or cfg.stall_check_disable:
        return None
    insp = st.sync_stall
    if insp is None:
        insp = _make_inspector(st, cfg)
        if insp is None:
            return None
    elif insp is False:
        return None
    members = list(ps.ranks) if ps.ranks is not None else list(
        range(st.size))
    if isinstance(insp, AmortizedStallInspector):
        return insp.pre_op(ps.process_set_id, members, desc)
    insp.rendezvous(ps.process_set_id, members, desc)
    return None


def engaged(st, ps) -> bool:
    """True when ``dispatch`` / ``finish`` guard an op of ``ps`` on this
    thread (amortized mode, more than one member, not a bypass
    thread): the callers then launch their collectives asynchronously
    and hand the completion to ``finish``."""
    return (isinstance(st.sync_stall, AmortizedStallInspector)
            and ps.size > 1 and not getattr(_tls, "bypass", False))


# Backend/transport failure markers: a peer that aborted or died
# closes its sockets, and the surviving ranks' collectives then fail
# with these rather than hanging.  The reference maps such collective
# failures to HorovodError so elastic recovery can catch them — mirror
# that (HorovodInternalError), and attach the watchdog's diagnosis when
# it lands within a heartbeat.  The reference's markers, then the text
# NCCL and ProcessGroupNCCL put in their errors and timeouts.
_TRANSPORT_MARKERS = (
    "Connection closed by peer", "Socket closed", "Connection reset",
    "connection reset", "Broken pipe", "Connection refused",
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "coordination service",
    "NCCL error", "ncclRemoteError", "ncclSystemError",
    "ncclInternalError", "NCCL communicator was aborted",
    "Watchdog caught collective operation timeout",
    "ProcessGroupNCCL", "Timed out waiting",
)

#: torch.distributed's typed failures of a collective's transport.
_TRANSPORT_TYPES = (dist.DistBackendError, dist.DistNetworkError,
                    dist.DistStoreError)


def _is_transport_error(err: BaseException) -> bool:
    return (isinstance(err, _TRANSPORT_TYPES)
            or any(m in str(err) for m in _TRANSPORT_MARKERS))


def _map_backend_error(insp, err):
    """Re-raise ``err``; transport-shaped failures become
    ``HorovodInternalError`` (recoverable, reference parity), carrying
    the watchdog's diagnosis if one latches within ~two heartbeats."""
    msg = str(err)
    if not _is_transport_error(err):
        raise err
    deadline = clock.monotonic() + 2 * getattr(insp, "heartbeat_s", 0.5)
    while insp is not None and clock.monotonic() < deadline:
        if insp.failure:
            raise HorovodInternalError(
                f"{insp.failure} (surfaced via backend error: "
                f"{msg})") from err
        clock.sleep(0.02)
    raise HorovodInternalError(
        f"collective transport failure (a peer likely aborted or "
        f"died): {msg}") from err


def _pending_leaf(out) -> bool:
    """True when ``out`` is still pending — i.e. the launch returned
    BEFORE the collective finished, proving asynchronous dispatch for
    its owner."""
    try:
        probe = _ready_probe(out)
        return probe is not None and not probe()
    except Exception:
        return False


def _execute_once(insp, sid, fn, args, owner, desc):
    """One collective attempt (amortized mode): the wire fault sites
    wrap the real execution, and transport-shaped failures re-raise as
    :class:`wirefault.AttemptFailed` so the retry loop in ``dispatch``
    can run the abort consensus.  Everything else surfaces unchanged.
    The in-flight marker is cleared on EVERY error path (a failed
    attempt must never trip a later healthy op into a false stall
    abort; a re-dispatch re-arms the marker from the ring)."""
    try:
        # Fault site ``wire.send``: the attempt dies BEFORE dispatch
        # put any bytes on the wire — the only failure class eligible
        # to late-join a still-pending attempt.
        if faults.ACTIVE and faults.inject("wire.send"):
            raise wirefault.AttemptFailed(True, ConnectionError(
                "Connection reset: injected wire.send fault"))
        try:
            if owner in insp.async_proven:
                if insp.failure:
                    raise HorovodInternalError(insp.failure)
                out = fn(*args)
            else:
                out, pending = insp.dispatch(sid, fn, args, desc)
                if pending:
                    insp.async_proven.add(owner)
        except (HorovodInternalError, wirefault.AttemptFailed):
            raise
        except Exception as e:
            if _is_transport_error(e):
                raise wirefault.AttemptFailed(False, e) from e
            raise
        # Fault site ``wire.recv``: the result was torn off the wire
        # after dispatch — mid-flight, so a retry is only granted when
        # consensus proves no member completed the attempt.
        if faults.ACTIVE and faults.inject("wire.recv"):
            raise wirefault.AttemptFailed(False, ConnectionError(
                "Connection reset: injected wire.recv fault"))
        return out
    except BaseException:
        insp._clear_inflight(sid)
        raise


def dispatch(st, ps, fn, args, owner=None, set_id=None, desc=None):
    """The guarded execution hook (amortized mode): run ``fn(*args)``,
    the launch of one collective, and return what it returned.

    A launch that can block its thread (a synchronous gloo op, a NCCL
    communicator's lazy set-up) would park the caller uninterruptibly
    inside a dead collective — so launches run on the inspector's
    executor thread until one returns while its result is still
    pending, which proves the owner's dispatch asynchronous; its later
    launches run inline (``wait_ready`` keeps the caller
    interruptible).  ``owner`` names the launch for that proof (a
    hashable; defaults to ``fn``: pass it when ``fn`` is a per-call
    closure).  Direct call for strict/disabled modes and the
    controller's bypass threads.

    With ``HVTPU_WIRE_RETRIES`` > 0 a transport-shaped attempt failure
    is not immediately job-fatal: the rank votes the attempt dead over
    the store and reissues it only once the member ranks agree nobody
    holds its result (comm/wirefault.py — RETRY reissues the next
    attempt, LATE_JOIN re-enters the same still-pending attempt,
    ESCALATE falls through to ``HorovodInternalError``)."""
    insp = st.sync_stall
    if not engaged(st, ps):
        return fn(*args)
    owner = owner if owner is not None else fn
    sid = ps.process_set_id if set_id is None else set_id
    budget = wirefault.retry_limit()
    attempt = 0
    fails = 0
    while True:
        try:
            out = _execute_once(insp, sid, fn, args, owner, desc)
            if fails:
                seq, _members, _d = insp.op_info(sid, desc)
                insp.wire_consensus().cleanup(sid, seq, attempt)
            return out
        except wirefault.AttemptFailed as af:
            # late joins consume budget too, or a flapping link could
            # re-enter the same attempt forever
            fails += 1
            if fails > budget or insp.failure:
                _map_backend_error(insp, af.cause)
            seq, members, d = insp.op_info(sid, desc)
            decision = insp.wire_consensus().vote_and_decide(
                sid, seq, attempt, members, d, af.predispatch)
            if decision == wirefault.ESCALATE:
                _map_backend_error(insp, af.cause)
            wirefault.record_retry(insp.rank, sid, seq, attempt,
                                   decision)
            if decision == wirefault.RETRY:
                # every member reissues the NEXT attempt (late joins
                # re-enter the same one) — backoff scales with the
                # attempt so a persistently lossy link drains fast
                attempt += 1
                clock.sleep(wirefault.retry_backoff_s() * attempt)


def finish(st, ps, out, desc: Optional[str] = None):
    """The post-dispatch hook (amortized mode only): wait for the
    collective's completion interruptibly (``out``: a ``Work``, a CUDA
    event, a tensor, or a list of them) so a stall or mismatch detected
    by the heartbeat aborts with ``HorovodInternalError`` instead of
    parking in a CUDA or gloo wait; a failed ``Work`` surfaces through
    ``_map_backend_error``.  ``desc`` (the value ``check`` returned)
    names the op for re-arm diagnosis.  Returns ``out``; a no-op for
    strict/disabled modes and the controller's bypass threads."""
    if not engaged(st, ps):
        return out
    insp = st.sync_stall
    try:
        insp.wait_ready(ps.process_set_id, out, desc)
    except HorovodInternalError:
        raise
    except Exception as e:
        _map_backend_error(insp, e)
    return out


def _tensor_leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensor_leaves(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensor_leaves(o)]
    return []


def stall_guard(fn=None, *, name: Optional[str] = None,
                process_set=None, block: bool = True):
    """Opt-in stall coverage at a training step's boundary.

    A rank that stops stepping (crash loop, diverged step count, data
    exhaustion without ``join``) leaves every other rank inside a
    collective with no diagnostic.  Wrapping the step function closes
    that gap with the machinery of the sync watchdog:

    - each call records a step mark on a guard-private channel
      (amortized mode: local bookkeeping + the existing heartbeat;
      strict mode: one pre-dispatch rendezvous per STEP);
    - a rank that stops stepping is diagnosed by name after
      ``stall_check_time_seconds``, and the survivors raise
      ``HorovodInternalError`` after ``stall_shutdown_time_seconds``
      instead of hanging — from the interruptible completion wait
      (``block=True``, default: the wrapper polls the step's tensor
      outputs, an event a CUDA tensor) or from the next call's
      pre-dispatch check (``block=False``);
    - two ranks calling DIFFERENTLY-NAMED guarded steps at the same
      point are diagnosed as diverged.

    Usable as a decorator or a wrapper::

        step = hvd.stall_guard(train_step)
        # or
        @hvd.stall_guard(name="train")
        def train_step(...): ...

    No-op (plain passthrough) before ``init()``, at world size 1, when
    stall checking is disabled, and on the controller's bypass thread.
    The step's own collectives (the optimizer's buckets) are guarded
    too, on the same inspector.
    """
    if fn is None:
        return lambda f: stall_guard(f, name=name,
                                     process_set=process_set,
                                     block=block)
    import functools

    gname = name or getattr(fn, "__name__", None) or "step"

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        from ..core import state as core_state

        st = core_state.global_state()
        if not st.initialized:
            return fn(*args, **kwargs)
        if process_set is None:
            ps = st.process_set_table.get(0)
        elif isinstance(process_set, int):
            ps = st.process_set_table.get(process_set)
        else:
            ps = process_set
        if ps.size <= 1 or getattr(_tls, "bypass", False):
            return fn(*args, **kwargs)
        cfg = st.config
        if cfg is None or cfg.stall_check_disable:
            return fn(*args, **kwargs)
        insp = st.sync_stall
        if insp is None:
            insp = _make_inspector(st, cfg)
        if insp is None or insp is False:
            return fn(*args, **kwargs)
        # one channel per process set — NOT per guard name: ranks
        # calling differently-named guarded steps at the same point
        # must share a sequence channel so the ring comparison can
        # diagnose them as diverged (the name lives in the descriptor)
        sid = f"jit.{ps.process_set_id}"
        desc = f"jit_step:{gname}"
        members = list(ps.ranks) if ps.ranks is not None else list(
            range(st.size))
        if isinstance(insp, AmortizedStallInspector):
            insp.pre_op(sid, members, desc)
            # the step dispatches via the cold-executor / async-proven
            # machinery: a step whose collectives run inline on the
            # dispatching thread must not wedge the caller
            call = fn if not kwargs else (
                lambda *a: fn(*a, **kwargs))
            out = dispatch(st, ps, call, args, owner=wrapped,
                           set_id=sid)
            if block:
                insp.wait_ready(sid, _tensor_leaves(out), desc)
            # block=False: the marker stays armed (a peer that stops
            # stepping is still diagnosed because its counter falls
            # behind, and clean exits are excluded via the goodbye
            # tombstone)
            return out
        insp.rendezvous(sid, members, desc)
        return fn(*args, **kwargs)

    return wrapped


def stop(st) -> None:
    """Shut down the inspector's background thread (called from
    ``core.state.shutdown``, before the store goes away)."""
    obs_metrics.unregister_debug_provider("stall")
    insp = st.sync_stall
    if isinstance(insp, AmortizedStallInspector):
        try:
            insp.stop()
        except Exception:
            pass
    st.sync_stall = None
