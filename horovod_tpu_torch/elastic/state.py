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
                out[k] = self._copy(v)
        return out

    #: How a tracked value is copied into a snapshot.
    _copy = staticmethod(copy.deepcopy)

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


def _holds_dtensor(tree) -> bool:
    from ..api.sharded_checkpoint import _is_dtensor, leaves_with_path

    return any(_is_dtensor(leaf) for _, leaf in leaves_with_path(tree))


def _copy_tree(tree):
    """A private copy of ``tree``: each DTensor's local block cloned where
    it lies (``copy.deepcopy`` of a DTensor over a view of a larger
    storage fails), any other leaf deep-copied."""
    from torch.distributed.tensor import DTensor

    from ..api.sharded_checkpoint import _is_dtensor, map_with_path

    def leaf(_path, x):
        if _is_dtensor(x):
            return DTensor.from_local(
                x.to_local().detach().clone(), x.device_mesh, x.placements,
                run_check=False, shape=x.shape, stride=x.stride())
        return copy.deepcopy(x)

    return map_with_path(leaf, tree)


#: Payload file of a sharded commit's replicated half.
SHARDED_REST_FILE = "sharded_rest.pt"


class ShardedTorchState(ObjectState):
    """Elastic state whose tracked attributes may hold GLOBAL arrays
    sharded across processes: trees (dicts, lists, tuples) of
    ``DTensor``s, e.g. the transformer's shards as
    ``models.transformer.global_params`` wraps them.

    Counterpart of the reference's ``ShardedJaxState``.  ``ObjectState``'s
    durable path pickles rank 0's values, which would overwrite every
    other rank's shards with rank 0's; here the durable commit of an
    attribute holding a DTensor rides
    :class:`~horovod_tpu_torch.api.sharded_checkpoint.ShardedCheckpointer`
    (every process writes its own shards), and ``sync()`` after a
    restart reassembles each leaf onto the NEW world's meshes and
    placements, taken from the freshly made attribute values, which serve
    as the restore template.  Other attributes keep the rank-0 payload
    and broadcast.

    The commit is collective (every rank commits at the same boundary,
    the elastic contract already); the newest ``HVTPU_CKPT_KEEP``
    commits are kept.
    """

    # every process writes its shards: the durable save is collective,
    # so the commit policy may not promote it at a pending resize (the
    # SIGUSR1 flag is not rank-synchronous)
    _DURABLE_IS_COLLECTIVE = True

    _copy = staticmethod(_copy_tree)

    def _sharded_dir(self) -> Optional[str]:
        d = _state_dir()
        return os.path.join(d, "sharded") if d else None

    def _split(self, payload: Dict[str, Any]):
        """(array_attrs, plain_attrs): an attribute whose tree holds a
        DTensor goes through the sharded checkpointer (its host-leaf
        path covers mixed trees); the rest ride rank 0's payload."""
        arrays, rest = {}, {}
        for k, v in payload.items():
            (arrays if _holds_dtensor(v) else rest)[k] = v
        return arrays, rest

    def save(self):
        from ..api.sharded_checkpoint import ShardedCheckpointer
        from ..torch import functions

        self.save_to_memory()
        d = self._sharded_dir()
        if not d:
            return
        st = core_state.require_init("elastic sharded commit")
        # split the snapshot save_to_memory already copied: a second
        # _capture() would duplicate every shard at the boundary (the
        # checkpointer only reads, so sharing the snapshot is safe)
        arrays, rest = self._split(self._saved)
        ckpt = ShardedCheckpointer(d)
        # rank 0 ALONE picks the step and broadcasts it: a per-rank
        # latest_step() is a directory listing of a shared filesystem,
        # which can differ across hosts, and shards would then land in
        # different step directories
        step = (ckpt.latest_step() or 0) + 1 if st.rank == 0 else None
        if st.size > 1:
            step = functions.broadcast_object(step, root_rank=0)
        ckpt.save(step, arrays)
        if st.rank == 0:
            # the replicated half commits through the durable protocol as
            # snapshot seq == step; its manifest-last rename is what makes
            # step N restorable (the shard write above already ended in a
            # barrier, so this commit is never ahead of its pieces)
            payload = api_checkpoint.dumps({
                "step": step, "rest": api_checkpoint.to_host(rest),
                "array_attrs": sorted(arrays)})
            core_durable.write_snapshot(_state_dir(), step,
                                        {SHARDED_REST_FILE: payload})
            # retention: drop shard steps beyond the HVTPU_CKPT_KEEP
            # window (write_snapshot already collected the rest commits)
            import shutil

            for s in ckpt.all_steps()[:-core_durable._keep()]:
                shutil.rmtree(ckpt._step_dir(s), ignore_errors=True)

    def _local_best_sharded(self, d: str) -> Optional[int]:
        """Highest step whose replicated commit AND this rank's view of
        the shards both verify: each rank vouches for what it can read,
        which is what the quorum needs to agree on a step restorable
        everywhere."""
        from ..api.sharded_checkpoint import ShardedCheckpointer

        ckpt = ShardedCheckpointer(d)
        root = _state_dir()
        for seq in reversed(core_durable.list_snapshots(root)):
            if not core_durable.verify_snapshot(
                    core_durable.snapshot_path(root, seq)):
                continue
            if ckpt.verify_step(seq):
                return seq
        return None

    def sync(self):
        from ..api.sharded_checkpoint import ShardedCheckpointer

        st = core_state.require_init("elastic state sync")
        d = self._sharded_dir()
        # every rank verifies its own view and votes; rank 0 ALONE loads
        # the agreed step and broadcasts the decision, so no rank takes
        # a branch its peers do not (the restore is collective-free, but
        # the broadcast below is not)
        agreed = None
        if d and not self._synced:
            _flush_durable_writes()
            agreed = self._quorum_agree(self._local_best_sharded(d))
        disk = None
        if st.rank == 0 and agreed is not None:
            files = core_durable.read_snapshot(_state_dir(), agreed)
            disk = api_checkpoint.loads(files[SHARDED_REST_FILE], "cpu")
        msg = _broadcast({"disk": disk})
        disk = msg["disk"]
        if disk is not None:
            self._apply(api_checkpoint.to_device(disk["rest"], st.device))
            # the current attribute values carry the NEW world's
            # layouts: they are the restore template
            arrays, _ = self._split(self._capture())
            # every array attribute the saver committed must have a
            # template, or it would silently keep its fresh values
            missing = set(disk.get("array_attrs", [])) - set(arrays)
            if missing:
                raise ValueError(
                    "ShardedTorchState.sync: committed array attributes "
                    f"{sorted(missing)} have no DTensor template in the "
                    "restarted state; construct them (DTensor.from_local "
                    "on the new mesh) before sync()")
            self._apply(ShardedCheckpointer(d).restore(
                arrays, step=disk["step"]))
        else:
            # no durable commit: the plain attributes from rank 0; the
            # global arrays are the same by SPMD construction
            _, rest = self._split(self._capture())
            self._apply(_broadcast(rest))
        self.save_to_memory()
        self._synced = True

    def rebroadcast(self):
        """Plain attributes only: a DTensor's shards differ by rank, and
        a reset callback that rebuilt one did so collectively."""
        core_state.require_init("elastic state rebroadcast")
        _, rest = self._split(self._capture())
        self._apply(_broadcast(rest))
        self.save_to_memory()

    def audit(self, label: str = "elastic.state") -> Optional[dict]:
        """Audit the REPLICATED half only: each rank legitimately holds a
        different shard of a global array, so cross-rank digests of
        shards would be a false divergence."""
        from ..core import audit as core_audit

        if core_audit.audit_every() <= 0:
            return None
        _, rest = self._split(self._capture())
        return core_audit.verify(rest, label)
