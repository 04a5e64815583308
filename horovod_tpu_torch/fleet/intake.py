"""Indexed submit intake: an append-only journal with a persisted
cursor — the fleet's overload-safe front door.

The port's copy of ``horovod_tpu/fleet/intake.py``: the same submits
give the same journal and cursor bytes, over the port's
``core/durable.py``.

The legacy spool protocol (one file per submission, ``listdir`` every
tick) is O(files-per-tick): a burst of a few thousand queued
submissions makes EVERY subsequent tick pay for the whole backlog.
The journal replaces that with an indexed intake:

- **Append-only journal** (``<fleet_dir>/journal.jsonl``): every
  ``submit`` / ``cancel`` is one JSON line appended under an exclusive
  ``flock``, so concurrent CLI clients serialize and records carry a
  strictly increasing ``seq``.  A crash mid-append leaves at most one
  torn tail line: readers detect it (no trailing newline at EOF) and
  skip it, and the NEXT writer repairs it under the lock — it
  terminates the partial line with a newline before appending, so the
  dead writer's fragment surfaces as one corrupt record instead of
  silently merging with (and destroying) the new submission.
- **Persisted cursor** (``<fleet_dir>/journal.cursor``): the arbiter
  remembers ``(offset, seq)`` of the last applied record, written
  crash-atomically through :func:`core.durable.atomic_write` AFTER the
  batch is applied and the admitted jobs are durable in ``state.json``
  (commit-last ordering: a crash anywhere before the commit replays
  the batch; committing first would instead LOSE acknowledged
  submissions whose records the advanced cursor skips).  Each tick
  seeks straight to the first new record and reads at most ``budget``
  lines: per-tick cost is O(new-entries), never O(queue).  A replayed
  batch is deduped by the arbiter (same live name + same spec →
  consume silently), which makes intake exactly-once at the job
  level.
- **Backpressure**: the cursor also publishes the arbiter's drain rate
  (``budget`` records per ``tick_s``).  When the un-applied backlog
  reaches ``HVTPU_FLEET_QUEUE_LIMIT``, :meth:`SubmitJournal.append_submit`
  refuses with :class:`QueueFullError` carrying a truthful
  ``retry_after_s`` — the seconds until the arbiter will have drained
  back below the limit at its published rate — instead of silently
  piling the queue higher.

Cancel ordering: because clients append through the same lock, a
cancel for a spooled-but-not-yet-intaken job always lands AFTER its
submit record, so the arbiter (which applies records in ``seq`` order
within one tick batch) tombstones the job before it can ever reach
PENDING-then-scheduled.

Thread safety: a :class:`SubmitJournal` instance is confined to its
owner (one CLI process, or the arbiter under its ``_lock``); cross-
process safety comes from ``flock`` + atomic cursor replace, not
instance locks.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from ..core import durable
from ..obs import metrics as obs_metrics

__all__ = ["SubmitJournal", "QueueFullError", "intake_budget",
           "queue_limit"]

_M_INTAKE_LAG = obs_metrics.gauge(
    "hvtpu_fleet_intake_lag",
    "Submit-journal records appended but not yet applied by the "
    "arbiter (backlog behind the persisted cursor).")

_JOURNAL = "journal.jsonl"
_CURSOR = "journal.cursor"


def intake_budget() -> int:
    """Max journal records the arbiter applies per tick."""
    try:
        n = int(os.environ.get("HVTPU_FLEET_INTAKE_BUDGET", "256")
                or 256)
    except ValueError:
        n = 256
    return max(1, n)


def queue_limit() -> int:
    """Un-applied journal backlog at which new submits are refused."""
    try:
        n = int(os.environ.get("HVTPU_FLEET_QUEUE_LIMIT", "4096")
                or 4096)
    except ValueError:
        n = 4096
    return max(1, n)


class QueueFullError(RuntimeError):
    """The journal backlog is at the queue limit; retry later.

    ``retry_after_s`` is truthful: backlog-over-limit divided by the
    arbiter's published drain rate (budget records per tick)."""

    def __init__(self, depth: int, limit: int, retry_after_s: float):
        self.depth = depth
        self.limit = limit
        self.retry_after_s = retry_after_s
        super().__init__(
            f"queue full: {depth} submissions queued (limit {limit}); "
            f"retry after {retry_after_s:.1f}s")


def _flock(f):
    try:
        import fcntl

        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
    except (ImportError, OSError):
        pass  # single-writer platforms still get O_APPEND atomicity


class SubmitJournal:
    """One fleet dir's journal + cursor.  Writers append; the arbiter
    reads from the cursor and commits it after applying."""

    def __init__(self, fleet_dir: str):
        self.fleet_dir = fleet_dir
        self.path = os.path.join(fleet_dir, _JOURNAL)
        self.cursor_path = os.path.join(fleet_dir, _CURSOR)
        # reader-side tentative position (set by read_batch, persisted
        # by commit); owner-confined, see module docstring
        self._pending_offset: Optional[int] = None
        self._pending_seq: Optional[int] = None

    # -- cursor ----------------------------------------------------------
    def read_cursor(self) -> dict:
        try:
            with open(self.cursor_path) as f:
                cur = json.load(f)
            if not isinstance(cur, dict):
                raise ValueError("cursor is not an object")
            return cur
        except (OSError, ValueError):
            return {"offset": 0, "seq": 0}

    def commit(self, *, budget: Optional[int] = None,
               tick_s: Optional[float] = None) -> None:
        """Persist the post-batch cursor crash-atomically.  Also
        publishes the arbiter's drain rate so clients can compute a
        truthful retry-after."""
        if self._pending_offset is None:
            return
        cur = {"offset": self._pending_offset,
               "seq": self._pending_seq or 0}
        if budget is not None:
            cur["budget"] = int(budget)
        if tick_s is not None:
            cur["tick_s"] = float(tick_s)
        durable.atomic_write(
            self.cursor_path,
            json.dumps(cur, sort_keys=True).encode() + b"\n",
            detail="journal.cursor")
        self._pending_offset = None
        self._pending_seq = None

    # -- write side (CLI clients) ----------------------------------------
    def _tail_seq(self) -> int:
        """Seq of the last COMPLETE record (newline-terminated and
        parseable).  Scans backwards from EOF in 64KB windows,
        widening until a parseable line is found, so one oversized
        record longer than a window cannot hide the tail and restart
        seq numbering (duplicate seqs would break depth() and
        cursor-based dedup).  O(tail) in the common case."""
        try:
            with open(self.path, "rb") as f:
                f.seek(0, os.SEEK_END)
                pos = f.tell()
                buf = b""
                while pos > 0:
                    back = min(pos, 65536)
                    pos -= back
                    f.seek(pos)
                    buf = f.read(back) + buf
                    lines = buf.split(b"\n")
                    # unless the window reached BOF, the first element
                    # is a mid-line fragment — keep it for the next
                    # widening pass instead of parsing it
                    for line in reversed(lines[0 if pos == 0 else 1:]):
                        if not line.strip():
                            continue
                        try:
                            rec = json.loads(line)
                            if isinstance(rec, dict):
                                return int(rec.get("seq", 0) or 0)
                        except (ValueError, TypeError):
                            pass  # torn tail or corrupt line
        except OSError:
            return 0
        return 0

    def depth(self) -> int:
        """Appended-but-unapplied records (journal tail vs cursor)."""
        return max(0, self._tail_seq() - int(
            self.read_cursor().get("seq", 0) or 0))

    def _append(self, rec: dict) -> int:
        os.makedirs(self.fleet_dir, exist_ok=True)
        with open(self.path, "a+b") as f:
            _flock(f)  # released on close
            # repair a torn tail left by a CRASHED writer: terminate
            # the partial line so this record cannot merge into it
            # (the fragment then surfaces as one corrupt record)
            f.seek(0, os.SEEK_END)
            end = f.tell()
            if end:
                f.seek(end - 1)
                if f.read(1) != b"\n":
                    f.seek(0, os.SEEK_END)
                    f.write(b"\n")
            f.seek(0, os.SEEK_END)
            seq = self._tail_seq() + 1
            rec = dict(rec, seq=seq)
            f.write(json.dumps(rec, sort_keys=True).encode() + b"\n")
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
        return seq

    def _check_backpressure(self) -> None:
        limit = queue_limit()
        cur = self.read_cursor()
        depth = max(0, self._tail_seq() - int(cur.get("seq", 0) or 0))
        if depth < limit:
            return
        budget = max(1, int(cur.get("budget", intake_budget()) or 1))
        tick_s = float(cur.get("tick_s", 1.0) or 1.0)
        over = depth - limit + 1
        ticks = (over + budget - 1) // budget
        raise QueueFullError(depth, limit, ticks * tick_s)

    def append_submit(self, spec_dict: dict) -> int:
        """Append a submit record; raises :class:`QueueFullError` when
        the backlog is at the queue limit."""
        self._check_backpressure()
        return self._append({"op": "submit", "spec": spec_dict})

    def append_cancel(self, name: str) -> int:
        """Append a cancel record (never backpressured: cancels only
        shrink the fleet's work)."""
        return self._append({"op": "cancel", "name": name})

    # -- read side (the arbiter) -----------------------------------------
    def read_batch(self, budget: int) -> List[dict]:
        """Read up to ``budget`` complete records past the cursor.
        Remembers the post-batch position for :meth:`commit`; malformed
        newline-terminated lines are skipped as ``{"op": "corrupt"}``
        records so the caller can surface them, while a torn tail
        (no trailing newline) is left for the next tick."""
        cur = self.read_cursor()
        start = int(cur.get("offset", 0) or 0)
        offset = start
        seq = int(cur.get("seq", 0) or 0)
        out: List[dict] = []
        try:
            f = open(self.path, "rb")
        except OSError:
            self._pending_offset = None
            self._pending_seq = None
            return out
        with f:
            f.seek(offset)
            while len(out) < budget:
                line = f.readline()
                if not line or not line.endswith(b"\n"):
                    break  # EOF or torn tail: retry next tick
                offset += len(line)
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict):
                        raise ValueError("record is not an object")
                except ValueError:
                    out.append({"op": "corrupt", "seq": seq + 1})
                    seq += 1
                    continue
                seq = int(rec.get("seq", seq + 1) or seq + 1)
                out.append(rec)
        if offset != start:
            self._pending_offset = offset
            self._pending_seq = seq
        else:
            # nothing consumed: leave no pending state so an idle
            # tick's commit() is a no-op instead of an fsync'd
            # rewrite of an unchanged cursor
            self._pending_offset = None
            self._pending_seq = None
        _M_INTAKE_LAG.set(max(0, self._tail_seq() - seq))
        return out
