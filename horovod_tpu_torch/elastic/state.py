"""Elastic state objects: commit / restore / sync.

Counterpart of ``horovod_tpu/elastic/state.py`` (``State``,
``ObjectState``; parity: ``horovod/common/elastic.py``): training state
committed at batch boundaries, rolled back after a failure, and
synchronized to the ranks of a relaunched world.

Reconfiguration is **restart-based**, as in the reference: the world is
relaunched on a membership change, so ``commit()`` persists a snapshot
to a durable per-job directory (``HVTPU_ELASTIC_STATE_DIR``) through
``core/durable.py`` besides the in-memory copy.  ``sync()`` in a
relaunched incarnation agrees on the restore commit across ranks (the
restore quorum over the port's store), loads it on rank 0 and
broadcasts rank 0's payload.

What changes in PyTorch: tensors are mutable and may live on the card.

- The in-memory snapshot deep-copies tracked values where they are (a
  tensor on the card is copied on the card).
- The durable payload is made at the commit boundary, on the training
  thread: every tensor copied into host memory, then serialized with
  ``torch.save`` into the snapshot's bytes, before the next step can
  change a tensor in place.  Only the disk write runs on the background
  writer, which gets bytes, never live tensors.
- No CUDA storage goes into a pickle: the broadcast of ``sync`` and
  ``rebroadcast`` carries host tensors, and a load puts them on the
  LOADING process's device (``hvd.device()``), so an incarnation on
  another local rank never lands on the saver's device index.
"""

from __future__ import annotations

import copy
import itertools
import logging
import os
from typing import Any, Callable, Dict, List, Optional

from ..api import checkpoint as api_checkpoint
from ..core import durable as core_durable
from ..core import state as core_state
from ..core.exceptions import HostsUpdatedInterrupt

logger = logging.getLogger("horovod_tpu_torch")

#: Payload file of a durable commit (``torch.save`` bytes).
STATE_FILE = "state.pt"


def _state_dir() -> Optional[str]:
    return os.environ.get("HVTPU_ELASTIC_STATE_DIR") or None


#: Restore-quorum round counter: every rank calls sync() the same
#: number of times (the collective contract), so a per-process counter
#: yields matching namespaces without any extra coordination.
_quorum_round = itertools.count()


def _quorum_kv(st):
    """The coordination client for the restore quorum: the port's
    ``StoreKV`` under the retry and fencing planes, journaled
    (``core/journal.py``) so a relaunch replays the votes this rank
    already cast.  None when no coordination client is up (a world of
    one)."""
    if not core_state._coordination_client_active():
        return None
    from ..core.journal import default_journal
    from ..core.retry import fenced_kv

    return fenced_kv(st.kv, rank=st.rank, journal=default_journal(st.rank))


def _flush_durable_writes() -> None:
    """Drain the background writer before any restore-side read: a
    snapshot still in the queue is not yet on disk, and a write error
    must surface before we decide what the latest durable commit is."""
    try:
        core_durable.shared_writer().flush()
    except RuntimeError:
        logger.warning("elastic state: background durable write failed; "
                       "restoring from the last verified commit",
                       exc_info=True)


def _broadcast(payload: Any) -> Any:
    """Rank 0's ``payload`` on every rank: host tensors on the wire,
    this rank's device after."""
    from ..torch import functions

    st = core_state.global_state()
    if st.size <= 1:
        return payload
    got = functions.broadcast_object(api_checkpoint.to_host(payload),
                                     root_rank=0)
    return api_checkpoint.to_device(got, st.device)


class State:
    """Base elastic state (parity: horovod/common/elastic.py State).

    Subclasses implement ``save``/``restore``/``sync`` over their
    payload; this base owns commit bookkeeping, reset callbacks, and the
    host-update check raised at commit boundaries.
    """

    def __init__(self):
        self._reset_callbacks: List[Callable[[], None]] = []
        self._host_messages = _HostUpdateFlag.instance()
        self._synced = False
        self._commit_count = 0
        self._durable_every = 1

    def register_reset_callbacks(self, callbacks):
        """Parity: State.register_reset_callbacks — called after a world
        reconfiguration so the user can rebuild derived objects
        (e.g. learning-rate schedules that depend on world size)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._synced = False
        for cb in self._reset_callbacks:
            cb()

    def set_commit_policy(self, every_n_commits: int = 1):
        """Throttle the DURABLE half of ``commit()`` to every Nth call.

        The in-memory snapshot (the rollback target) still happens on
        every commit; only the disk write is skipped between multiples.
        A crash-and-relaunch then resumes from the last durable commit,
        up to N-1 commits back.  The decision is a function of the
        commit count, hence identical on every rank.  Call ``save()``
        directly for an unconditional durable snapshot.
        """
        if not isinstance(every_n_commits, int) \
                or isinstance(every_n_commits, bool) \
                or every_n_commits < 1:
            raise ValueError(
                f"every_n_commits must be an int >= 1, got "
                f"{every_n_commits!r}")
        self._durable_every = every_n_commits

    # True when save() is a COLLECTIVE (every rank participates) — such
    # saves may only run at rank-deterministic points, so the
    # pending-resize promotion below must not apply.
    _DURABLE_IS_COLLECTIVE = False

    def commit(self):
        """Snapshot state (memory, and the durable dir per the commit
        policy) then check for host updates (parity: State.commit =
        save + check_host_updates)."""
        # step boundary: the worker.step fault-injection site (a kill
        # here dies BEFORE the snapshot, so recovery resumes from the
        # previous commit — the realistic mid-step death)
        from . import worker as _worker

        _worker.note_step()
        self._commit_count += 1
        # Graceful drain (core/preempt.py): with a preemption notice
        # pending somewhere in the world, ask whether THIS boundary is
        # the agreed drain commit (a commit-count agreement; counts
        # advance in lockstep, so forcing a durable save is safe).
        from ..core import preempt as _preempt

        drain_now = _preempt.pending() \
            and _preempt.drain_boundary(self._commit_count)
        durable = self._commit_count % self._durable_every == 0
        if drain_now:
            durable = True
        if not durable and self._host_messages.flag \
                and not self._DURABLE_IS_COLLECTIVE:
            # a membership change is about to interrupt this commit —
            # promote to a durable save so the PLANNED resize path
            # loses nothing (rank-local writes only: the signal is not
            # rank-synchronous)
            durable = True
        if durable:
            self.save()
        else:
            self.save_to_memory()
        # Periodic cross-rank divergence audit (core/audit.py): the
        # commit boundary is the one point every rank reaches in
        # lockstep, so the audit's collective exchange is safe here.
        # Off unless HVTPU_AUDIT_EVERY > 0.
        from ..core import audit as core_audit

        n = core_audit.audit_every()
        if n > 0 and self._commit_count % n == 0:
            self.audit("elastic.commit")
        if drain_now:
            # the drain commit persisted: the departing rank exits
            # DRAIN_EXIT_CODE here; peers raise DrainInterrupt (the
            # committed state stands — no rollback)
            _preempt.finish_drain(self._commit_count)
        self.check_host_updates()

    def check_host_updates(self):
        """Raise HostsUpdatedInterrupt at a commit boundary if a
        membership change was signalled (SIGUSR1)."""
        if self._host_messages.consume():
            raise HostsUpdatedInterrupt(skip_sync=False)

    # -- overridable payload hooks --
    def save_to_memory(self):
        """In-memory-only snapshot (rollback target).  Subclasses
        without a cheaper memory path inherit the full save."""
        self.save()

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def rebroadcast(self):
        """Re-broadcast tracked state from rank 0 WITHOUT touching the
        durable commit.  Called after reset callbacks run in a
        relaunched incarnation: a rank-dependent callback would
        otherwise leave tracked attributes diverged across ranks.  Base
        State tracks nothing."""

    def audit(self, label: str = "elastic.state") -> Optional[dict]:
        """Verify this state is identical on every rank with the
        parameter divergence audit (core/audit.py), gated on
        ``HVTPU_AUDIT_EVERY`` > 0.  Base State tracks nothing."""
        return None


class _HostUpdateFlag:
    """Process-wide flag set by the elastic worker's SIGUSR1 handler
    (elastic/worker.py installs it); consumed at commit."""

    _inst: Optional["_HostUpdateFlag"] = None

    def __init__(self):
        self.flag = False

    @classmethod
    def instance(cls) -> "_HostUpdateFlag":
        if cls._inst is None:
            cls._inst = cls()
        return cls._inst

    def set(self):
        self.flag = True

    def consume(self) -> bool:
        f, self.flag = self.flag, False
        return f


class ObjectState(State):
    """Elastic state holding arbitrary picklable attributes (parity:
    horovod/common/elastic.py ObjectState): ``state.epoch``,
    ``state.batch`` etc. become tracked attributes."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved: Dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._tracked = list(kwargs)
        self.save_to_memory()

    # -- payload capture --
    # Participant protocol: a tracked value exposing
    # ``hvtpu_state_dict()`` / ``hvtpu_load_state_dict(d)`` (e.g. a
    # data.LoaderState) is captured via its dict and restored IN PLACE,
    # so live objects holding a reference to it (the data loader, its
    # prefetch thread) ride commits/rollbacks without re-registration.
    def _capture(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k in self._tracked:
            v = getattr(self, k)
            if hasattr(v, "hvtpu_state_dict"):
                out[k] = copy.deepcopy(v.hvtpu_state_dict())
            else:
                out[k] = copy.deepcopy(v)
        return out

    def _apply(self, payload: Dict[str, Any]):
        for k, v in payload.items():
            cur = getattr(self, k, None)
            if cur is not None and hasattr(cur, "hvtpu_load_state_dict") \
                    and isinstance(v, dict):
                cur.hvtpu_load_state_dict(v)
            else:
                setattr(self, k, v)

    def save_to_memory(self):
        self._saved = self._capture()

    #: Monotonic durable-commit seq, seeded from disk on first save so
    #: a relaunched incarnation continues the sequence instead of
    #: overwriting the commits it must restore from.
    _ckpt_seq = 0

    def save(self):
        """Durable snapshot through the commit protocol
        (core/durable.py): the payload is copied to the host and
        serialized HERE, at the commit boundary; the disk write (tmp →
        fsync → rename → manifest-last) runs on the background writer
        unless ``HVTPU_CKPT_ASYNC=0``."""
        self.save_to_memory()
        d = _state_dir()
        if d and core_state.global_state().rank == 0:
            os.makedirs(d, exist_ok=True)
            payload = api_checkpoint.dumps(api_checkpoint.to_host(
                self._to_disk_payload(), copy=False))
            if self._ckpt_seq == 0:
                self._ckpt_seq = max(
                    core_durable.list_snapshots(d), default=0)
            self._ckpt_seq += 1
            seq = self._ckpt_seq

            def _write() -> None:
                core_durable.write_snapshot(d, seq, {STATE_FILE: payload})

            if core_durable._async_enabled():
                core_durable.shared_writer().submit(_write)
            else:
                _write()

    def wait_durable(self):
        """Block until every queued background durable write is on
        disk; re-raises a captured write error."""
        core_durable.shared_writer().flush()

    def restore(self):
        """Roll back to the last commit (parity: State.restore after
        HorovodInternalError)."""
        self._apply(copy.deepcopy(self._saved))
        self.on_reset()

    def _quorum_agree(self, local_best: Optional[int]) -> Optional[int]:
        """Min-agree ``local_best`` across ranks over the store.  A
        quorum failure degrades to this rank's local best — safe because
        only rank 0's pick is loaded and its broadcast carries the
        payload to everyone."""
        st = core_state.global_state()
        if st.size <= 1:
            return local_best
        kv = _quorum_kv(st)
        round_no = next(_quorum_round)
        if kv is None:
            return local_best
        gen = os.environ.get("HVTPU_ELASTIC_GENERATION", "0") or "0"
        try:
            return core_durable.restore_quorum(
                kv, rank=st.rank, size=st.size, local_best=local_best,
                namespace=f"hvtpu/ckpt/quorum/{gen}/{round_no}")
        except Exception:  # noqa: BLE001 — degrade, never diverge
            logger.warning(
                "elastic state: restore quorum failed; falling back to "
                "this rank's local best commit", exc_info=True)
            return local_best

    def _agree_restore_seq(self, d: str) -> Optional[int]:
        """The restore point: each rank's highest locally VERIFIED
        commit, min-agreed across ranks."""
        _flush_durable_writes()
        return self._quorum_agree(core_durable.latest_verified(d))

    def sync(self):
        """Make every rank identical: after a restart, agree on the
        restore commit (verify manifests, discard torn/corrupt
        snapshots, quorum on the highest commit durable EVERYWHERE),
        load it on rank 0, then broadcast rank 0's payload."""
        st = core_state.require_init("elastic state sync")
        d = _state_dir()
        if d and not self._synced:
            agreed = self._agree_restore_seq(d)
            if st.rank == 0 and agreed is not None:
                files = core_durable.read_snapshot(d, agreed)
                self._from_disk_payload(api_checkpoint.loads(
                    files[STATE_FILE], st.device))
        if st.size > 1:
            self._apply(_broadcast(self._capture()))
        self.save_to_memory()
        self._synced = True

    def rebroadcast(self):
        """Broadcast-only re-sync of tracked attributes from rank 0
        (no disk load, ``_synced`` untouched) — see State.rebroadcast."""
        st = core_state.require_init("elastic state rebroadcast")
        if st.size > 1:
            self._apply(_broadcast(self._capture()))
        self.save_to_memory()

    def audit(self, label: str = "elastic.state") -> Optional[dict]:
        """Cross-rank digest audit of the tracked attributes (see
        State.audit); collective when it runs, so the gating env var
        must agree on every rank."""
        from ..core import audit as core_audit

        if core_audit.audit_every() <= 0:
            return None
        return core_audit.verify(self._capture(), label)

    # -- disk representation hooks --
    def _to_disk_payload(self):
        """The snapshot ``save`` just took (a private copy)."""
        return self._saved

    def _from_disk_payload(self, payload):
        self._apply(payload)
