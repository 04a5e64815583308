"""Crash-consistent durable snapshots: atomic commits, integrity
manifests, retention, a background writer, and the restore quorum.

Counterpart of ``horovod_tpu/core/durable.py``, copied so that the port
imports nothing of the JAX package.  The same files give the same
directory layout and the same manifest bytes as the reference, so each
package's :func:`verify_snapshot` accepts the other's snapshots.

**Commit protocol** (:func:`write_snapshot`): each commit is a
directory ``commits/c_{seq:010d}`` whose payload files are written
tmp -> fsync(file) -> rename -> fsync(dir); a ``MANIFEST.json``
recording each file's intended sha256 and byte size is committed LAST
through the same discipline, so its rename is the commit point.  A
crash at any earlier instant leaves a directory without a valid
manifest: detectable, never silently loadable.  The newest
``HVTPU_CKPT_KEEP`` committed snapshots are retained; older commits and
dead uncommitted attempts are collected.

**Verification** (:func:`verify_snapshot` / :func:`latest_verified`): a
reader re-hashes payload files against the manifest; torn writes and
bit flips (real, or injected through the ``ckpt.*`` fault sites) fail
verification and the snapshot is skipped, so a restore falls back to the
previous retained commit.

**Background writer** (:class:`DurableWriter`): the caller serializes
at the commit boundary and the disk write runs on a bounded-queue daemon
thread, off the step's critical path.  The writer takes bytes, never
live tensors: the next step's in-place ``optimizer.step()`` cannot race
a write.  Write errors surface on the next ``submit``/``flush``; the
drain path (``core/preempt.py``) and the elastic reset path
(``elastic/worker.py``) quiesce the writer before their ``os._exit``,
and an atexit hook covers ordinary interpreter shutdown.

**Restore quorum** (:func:`restore_quorum`): after a restart each rank
publishes its highest locally verified commit over the coordination
client (``core/kv.py``'s ``StoreKV`` under ``core/retry.py``'s fenced
wrapper), and the agreed restore point is the MINIMUM over ranks: the
highest commit durable on every rank.

Knobs: ``HVTPU_CKPT_KEEP`` (retained commits, default 2),
``HVTPU_CKPT_FSYNC`` (default on), ``HVTPU_CKPT_ASYNC`` (background
writes, default on), ``HVTPU_CKPT_QUEUE`` (writer queue bound, default
2), ``HVTPU_CKPT_QUORUM_TIMEOUT_S``.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import logging
import os
import queue
import re
import shutil
import threading
from typing import Callable, Dict, List, Optional

from . import clock, faults
from ..obs import flight
from ..obs import metrics as obs_metrics

logger = logging.getLogger("horovod_tpu_torch")

__all__ = [
    "MANIFEST", "atomic_write", "write_snapshot", "verify_snapshot",
    "list_snapshots", "latest_verified", "read_snapshot", "gc_snapshots",
    "snapshot_path", "restore_quorum", "DurableWriter", "shared_writer",
    "quiesce_writers",
]

#: The commit marker: a snapshot directory is committed iff this file
#: exists and parses.  Written LAST — its atomic rename IS the commit.
MANIFEST = "MANIFEST.json"

_SNAP_RE = re.compile(r"^c_(\d{10})$")

_M_COMMIT_S = obs_metrics.histogram(
    "hvtpu_ckpt_commit_seconds",
    "durable snapshot commit latency (payload writes + fsyncs + "
    "manifest rename), per write_snapshot call")
_M_BYTES = obs_metrics.counter(
    "hvtpu_ckpt_bytes_written_total",
    "bytes physically written by the durable commit protocol "
    "(post-damage: a torn write counts what actually hit disk)")
_M_VERIFY_FAIL = obs_metrics.counter(
    "hvtpu_ckpt_verify_failures_total",
    "snapshots rejected by manifest verification (missing/unparsable "
    "manifest, size mismatch, or sha256 mismatch)")
_M_QUORUM_ROUNDS = obs_metrics.counter(
    "hvtpu_ckpt_restore_quorum_rounds_total",
    "restore-time cross-rank agreement rounds run over the "
    "coordination KV")


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def _keep() -> int:
    """HVTPU_CKPT_KEEP: retained last-good snapshots (min 1)."""
    try:
        return max(1, int(os.environ.get("HVTPU_CKPT_KEEP", "2") or 2))
    except ValueError:
        return 2


def _fsync_enabled() -> bool:
    """HVTPU_CKPT_FSYNC: fsync discipline on payload/manifest/dir
    writes.  On by default; the CPU tests turn it off (a tmpfs fsync is pure
    syscall overhead)."""
    return os.environ.get("HVTPU_CKPT_FSYNC", "1") not in ("0", "false")


def _async_enabled() -> bool:
    """HVTPU_CKPT_ASYNC: run durable writes on the background writer
    (snapshot-to-memory at the boundary, disk off the critical path)."""
    return os.environ.get("HVTPU_CKPT_ASYNC", "1") not in ("0", "false")


def _queue_depth() -> int:
    """HVTPU_CKPT_QUEUE: background-writer queue bound; a full queue
    blocks the submitter (natural backpressure, bounded memory)."""
    try:
        return max(1, int(os.environ.get("HVTPU_CKPT_QUEUE", "2") or 2))
    except ValueError:
        return 2


def _quorum_timeout_s() -> float:
    """HVTPU_CKPT_QUORUM_TIMEOUT_S: per-peer wait for restore-quorum
    votes before the caller falls back to its local best."""
    try:
        return float(os.environ.get("HVTPU_CKPT_QUORUM_TIMEOUT_S",
                                    "600") or 600)
    except ValueError:
        return 600.0


# ---------------------------------------------------------------------------
# the atomic write primitive (all three fault sites live here)
# ---------------------------------------------------------------------------

def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes, *,
                 fsync: Optional[bool] = None,
                 detail: Optional[str] = None) -> int:
    """Write ``data`` to ``path`` crash-atomically: tmp file in the
    same directory → fsync(file) → rename → fsync(directory).  Returns
    the byte count physically written.

    The three storage fault sites fire here when armed:
    ``ckpt.write`` before the payload hits the tmp file (``torn``
    truncates it mid-file, ``bitflip`` flips one bit, ``drop`` elides
    the write), ``ckpt.fsync`` before the file fsync (``drop``/damage
    actions elide it), ``ckpt.rename`` before the promote (eliding it
    leaves an uncommitted tmp — a torn commit).  ``error`` raises
    OSError-shaped :class:`~.faults.InjectedFault`; ``kill`` dies
    mid-commit, which is the whole point.
    """
    detail = detail or os.path.basename(path)
    payload = data
    if faults.ACTIVE:
        damage = faults.inject_storage("ckpt.write", detail=detail)
        if damage == "torn":
            payload = data[: len(data) // 2]
        elif damage == "bitflip":
            buf = bytearray(data)
            if buf:
                buf[len(buf) // 2] ^= 0x01
            payload = bytes(buf)
        elif damage == "drop":
            return 0
    do_fsync = _fsync_enabled() if fsync is None else fsync
    dirname = os.path.dirname(path) or "."
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        if do_fsync:
            skip = (faults.inject_storage("ckpt.fsync", detail=detail)
                    if faults.ACTIVE else None)
            if skip is None:
                os.fsync(f.fileno())
    if faults.ACTIVE:
        if faults.inject_storage("ckpt.rename", detail=detail) is not None:
            # rename elided: the write never commits (torn commit) —
            # leave the tmp behind exactly as a crash would
            _M_BYTES.inc(len(payload))
            return len(payload)
    os.replace(tmp, path)
    if do_fsync:
        # the rename itself must be durable: fsync the directory
        try:
            _fsync_path(dirname)
        except OSError:  # pragma: no cover - exotic filesystems
            logger.warning("durable: directory fsync failed for %s",
                           dirname, exc_info=True)
    _M_BYTES.inc(len(payload))
    return len(payload)


# ---------------------------------------------------------------------------
# snapshot commits
# ---------------------------------------------------------------------------

def snapshot_path(root: str, seq: int) -> str:
    return os.path.join(root, "commits", f"c_{seq:010d}")


def list_snapshots(root: str) -> List[int]:
    """All snapshot seqs under ``root`` (committed or not), sorted."""
    d = os.path.join(root, "commits")
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for n in names:
        m = _SNAP_RE.match(n)
        if m:
            out.append(int(m.group(1)))
    out.sort()
    return out


def _committed(path: str) -> Optional[dict]:
    """The parsed manifest when ``path`` holds a committed snapshot
    (manifest present and parsable), else None.  Cheap — no hashing."""
    try:
        with open(os.path.join(path, MANIFEST), "rb") as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def write_snapshot(root: str, seq: int, files: Dict[str, bytes], *,
                   fsync: Optional[bool] = None,
                   keep: Optional[int] = None,
                   meta: Optional[dict] = None) -> str:
    """Commit ``files`` (name → bytes) as snapshot ``seq`` under
    ``root`` and GC beyond the retention window.  The manifest records
    each file's INTENDED hash/size and is written last, so any damage
    to the payload en route (torn write, bit flip, crash) is caught by
    :func:`verify_snapshot` instead of being silently loaded."""
    t0 = clock.monotonic()
    d = snapshot_path(root, seq)
    if os.path.isdir(d):
        # a leftover attempt at this seq (crash before commit, or a
        # relaunched rank redoing the boundary): start clean
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d, exist_ok=True)
    manifest: Dict[str, object] = {"seq": seq, "files": {}}
    if meta is not None:
        manifest["meta"] = meta
    for name in sorted(files):
        data = files[name]
        manifest["files"][name] = {
            "sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data),
        }
        atomic_write(os.path.join(d, name), data, fsync=fsync,
                     detail=f"{name}@c{seq}")
    atomic_write(
        os.path.join(d, MANIFEST),
        json.dumps(manifest, sort_keys=True).encode(),
        fsync=fsync, detail=f"manifest@c{seq}")
    _M_COMMIT_S.observe(clock.monotonic() - t0)
    if flight.ACTIVE:
        flight.note("durable_commit", seq=seq,
                    files=len(files),
                    commit_s=round(clock.monotonic() - t0, 6))
    gc_snapshots(root, keep=keep)
    return d


def verify_snapshot(path: str) -> bool:
    """Full integrity check: manifest parses AND every payload file
    matches its recorded byte size and sha256.  Counts a
    ``hvtpu_ckpt_verify_failures_total`` on rejection."""
    manifest = _committed(path)
    if manifest is None:
        _M_VERIFY_FAIL.inc()
        return False
    for name, rec in manifest.get("files", {}).items():
        try:
            with open(os.path.join(path, name), "rb") as f:
                data = f.read()
        except OSError:
            _M_VERIFY_FAIL.inc()
            return False
        if (len(data) != rec.get("bytes")
                or hashlib.sha256(data).hexdigest() != rec.get("sha256")):
            logger.warning(
                "durable: snapshot %s rejected — %s fails manifest "
                "verification (torn or corrupt)", path, name)
            _M_VERIFY_FAIL.inc()
            return False
    return True


def note_verify_failure() -> None:
    """Count an integrity rejection found outside this module (the
    sharded checkpointer verifies its own piece manifests) in the same
    ``hvtpu_ckpt_verify_failures_total`` family."""
    _M_VERIFY_FAIL.inc()


def latest_verified(root: str) -> Optional[int]:
    """Highest seq under ``root`` that passes full verification —
    walking DOWN through damaged/torn commits to the last good one."""
    for seq in reversed(list_snapshots(root)):
        if verify_snapshot(snapshot_path(root, seq)):
            return seq
    return None


def read_snapshot(root: str, seq: int) -> Dict[str, bytes]:
    """Payload files of committed snapshot ``seq`` (name → bytes)."""
    d = snapshot_path(root, seq)
    manifest = _committed(d)
    if manifest is None:
        raise FileNotFoundError(
            f"no committed snapshot c_{seq:010d} under {root!r}")
    out = {}
    for name in manifest.get("files", {}):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def gc_snapshots(root: str, keep: Optional[int] = None) -> None:
    """Retention: keep the newest ``keep`` COMMITTED snapshots plus
    any seq newer than the newest commit (an in-flight write); drop
    older commits and dead uncommitted leftovers."""
    keep = _keep() if keep is None else max(1, int(keep))
    seqs = list_snapshots(root)
    committed = [s for s in seqs
                 if _committed(snapshot_path(root, s)) is not None]
    retain = set(committed[-keep:])
    newest = committed[-1] if committed else -1
    for s in seqs:
        if s in retain or s > newest:
            continue
        shutil.rmtree(snapshot_path(root, s), ignore_errors=True)


# ---------------------------------------------------------------------------
# restore-time cross-rank agreement
# ---------------------------------------------------------------------------

def restore_quorum(kv, *, rank: int, size: int, local_best: Optional[int],
                   namespace: str,
                   timeout_s: Optional[float] = None) -> Optional[int]:
    """Agree on the highest commit durable on EVERY rank.

    Each rank publishes its highest locally-verified seq (−1 when it
    has none) under ``namespace`` and blocking-reads all votes; the
    agreed restore point is ``min(votes)``, or None when any rank has
    nothing durable.  Deterministic in the votes, so every rank that
    completes the round picks the same seq — a straggler's stale or
    torn snapshot can lower the pick, never diverge it.

    ``kv`` is any coordination client exposing ``key_value_set`` /
    ``blocking_key_value_get`` (the port's ``StoreKV`` under
    ``core/retry.py``'s fenced wrapper, or an in-memory fake).
    ``namespace`` must be unique per restore attempt (callers scope it
    by generation and a per-process round counter) so stale votes
    cannot bleed across rounds.  Timeouts propagate to the caller,
    which falls back to its local best — safe wherever a rank-0
    broadcast carries the final pick.
    """
    _M_QUORUM_ROUNDS.inc()
    if hasattr(kv, "add_journal_prefix"):
        # Quorum votes are the canonical "history a fresh coordinator
        # cannot recompute" (core/journal.py): journal this rank's
        # vote so a coordinator-loss relaunch can replay it.
        kv.add_journal_prefix(f"{namespace}/")
    vote = -1 if local_best is None else int(local_best)
    kv.key_value_set(f"{namespace}/vote/{rank}", str(vote))
    timeout_ms = int((_quorum_timeout_s() if timeout_s is None
                      else timeout_s) * 1000)
    agreed = vote
    for peer in range(size):
        if peer == rank:
            continue
        v = int(kv.blocking_key_value_get(
            f"{namespace}/vote/{peer}", timeout_ms))
        agreed = min(agreed, v)
    return None if agreed < 0 else agreed


# ---------------------------------------------------------------------------
# the background durable writer
# ---------------------------------------------------------------------------

_STOP = object()


class DurableWriter:
    """Bounded-queue daemon thread running durable writes off the step
    critical path.  ``submit`` blocks when the queue is full (bounded
    memory: at most HVTPU_CKPT_QUEUE snapshots in flight); a write
    error is captured and re-raised on the NEXT submit/flush — the
    same surfacing contract as the async Checkpointer's ``wait()``."""

    def __init__(self, name: str = "hvtpu-ckpt-writer",
                 maxsize: Optional[int] = None):
        self._name = name
        self._q: "queue.Queue" = queue.Queue(
            _queue_depth() if maxsize is None else maxsize)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None  # hvtpulint: guarded-by(_lock)
        self._error: Optional[BaseException] = None  # hvtpulint: guarded-by(_lock)
        self._closed = False  # hvtpulint: guarded-by(_lock)

    def _ensure_thread(self) -> None:  # hvtpulint: requires(_lock)
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._run, name=self._name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                item()
            except BaseException as e:  # noqa: BLE001 — surfaced later
                with self._lock:
                    self._error = e
                logger.error("durable writer: background write failed",
                             exc_info=True)
            finally:
                self._q.task_done()

    def _raise_pending_locked(self) -> None:  # hvtpulint: requires(_lock)
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "durable background write failed") from err

    def submit(self, fn: Callable[[], None]) -> None:
        """Queue one write closure; blocks while the queue is full."""
        with self._lock:
            self._raise_pending_locked()
            if self._closed:
                raise RuntimeError("durable writer is closed")
            self._ensure_thread()
        self._q.put(fn)

    def flush(self) -> None:
        """Block until every queued write completed; re-raise a
        captured write error."""
        self._q.join()
        with self._lock:
            self._raise_pending_locked()

    def close(self) -> None:
        """Flush, then stop the thread.  Idempotent; errors from the
        final writes still surface."""
        with self._lock:
            if self._closed:
                thread = None
            else:
                self._closed = True
                thread = self._thread
        self._q.join()
        if thread is not None and thread.is_alive():
            self._q.put(_STOP)
            thread.join(timeout=30)
        with self._lock:
            self._raise_pending_locked()


_shared_lock = threading.Lock()
_shared: Optional[DurableWriter] = None  # guarded by _shared_lock
# (module-level: the thread-safety pass cannot track it; shared_writer/
# quiesce_writers are the only mutators and both take _shared_lock)


def shared_writer() -> DurableWriter:
    """The process-wide writer elastic state saves ride.  Lazily
    created; re-created after a quiesce (a relaunched incarnation in
    the same process gets a fresh thread)."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = DurableWriter()
        return _shared


def quiesce_writers() -> None:
    """Flush and stop the shared writer.  Exception-safe by contract —
    called from the drain path (core/preempt.py) before ``os._exit(79)``,
    from the elastic reset path (elastic/worker.py) before
    ``os._exit(73)``, and at interpreter exit; none of those may blow
    up on a write error, so it logs instead of raising."""
    global _shared
    with _shared_lock:
        w, _shared = _shared, None
    if w is None:
        return
    try:
        w.close()
    except BaseException:  # noqa: BLE001 — exit paths must not raise
        logger.error("durable writer: error while quiescing",
                     exc_info=True)


atexit.register(quiesce_writers)
