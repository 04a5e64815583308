"""Per-rank journal of self-authored durable coordination keys.

Counterpart of ``horovod_tpu/core/journal.py``, copied so that the port
imports nothing of the JAX package.

A relaunched job starts against a fresh, empty coordination store.
Everything the protocols derive at init — rendezvous, stall heartbeats —
rebuilds for free, but a small set of keys is *history* the new
incarnation cannot recompute (restore-quorum votes, drain accounting).

:class:`KeyJournal` keeps that history from the writer's side: each rank
appends its OWN authored keys under the registered durable prefixes to
``<state_dir>/kvjournal/rank<R>.jsonl`` (host-local disk that survives a
relaunch).  Journaling rides :class:`~horovod_tpu_torch.core.retry.
FencedKV`'s write path, so a fenced (superseded) rank can never journal.

Append-only, last-value-wins: ``record`` appends one JSON line per
write, ``entries`` folds the file newest-wins, ``forget`` appends a
tombstone.  The file is rewritten compacted whenever it grows past
``_COMPACT_AT`` lines.

Not yet ported: the replay at ``init()`` (``horovod_tpu/core/state.py``
``_replay_journal``) comes with the elastic plane; :meth:`KeyJournal.
replay` is here and takes any client with the coordination method
names (``core/kv.py``).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

logger = logging.getLogger("horovod_tpu_torch")

_COMPACT_AT = 1024


class KeyJournal:
    """One rank's durable-key journal under ``state_dir``."""

    def __init__(self, state_dir: str, rank: int = 0):
        self.rank = rank
        self.path = os.path.join(state_dir, "kvjournal",
                                 f"rank{rank}.jsonl")
        self._mem: Dict[str, Optional[str]] = dict(self._load())
        self._lines = len(self._mem)

    # -- write side -----------------------------------------------------
    def record(self, key: str, value: str) -> None:
        """Journal one authored ``key = value`` (last write wins)."""
        self._mem[key] = value
        self._append({"k": key, "v": value})

    def forget(self, key: str) -> None:
        """Tombstone a deleted key so replay does not resurrect it."""
        if key in self._mem:
            self._mem[key] = None
            self._append({"k": key, "v": None})

    def _append(self, rec: dict) -> None:
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
            self._lines += 1
            if self._lines > _COMPACT_AT:
                self._compact()
        except OSError:
            logger.warning("kv journal: could not append to %s",
                           self.path, exc_info=True)

    def _compact(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for k, v in self._mem.items():
                f.write(json.dumps({"k": k, "v": v}, sort_keys=True)
                        + "\n")
        os.replace(tmp, self.path)
        self._lines = len(self._mem)

    # -- read side ------------------------------------------------------
    def _load(self) -> Dict[str, Optional[str]]:
        out: Dict[str, Optional[str]] = {}
        try:
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        out[rec["k"]] = rec["v"]
                    except (ValueError, KeyError, TypeError):
                        continue  # torn tail line: keep what parsed
        except OSError:
            pass
        return out

    def entries(self) -> Dict[str, str]:
        """Live (non-tombstoned) journaled keys, last value wins."""
        return {k: v for k, v in self._mem.items() if v is not None}

    def __len__(self) -> int:
        return len(self.entries())

    # -- replay ---------------------------------------------------------
    def replay(self, kv, skip_existing: bool = True) -> int:
        """Re-publish this rank's journaled keys into ``kv`` (a fresh
        coordinator after re-election).  With ``skip_existing`` a key
        some live writer already re-authored is left alone — replay
        restores history, never overwrites the present.  Returns the
        number of keys written; per-key failures are logged and
        skipped (replay is best-effort by design: the quorum/drain
        protocols degrade gracefully to recomputing)."""
        replayed = 0
        for key, value in sorted(self.entries().items()):
            if skip_existing:
                try:
                    kv.key_value_try_get(key)
                    continue
                except Exception:
                    pass  # absent (or unreadable): replay it
            try:
                kv.key_value_set(key, value)
                replayed += 1
            except Exception:
                logger.warning("kv journal: replay of %r failed", key,
                               exc_info=True)
        return replayed

    def clear(self) -> None:
        self._mem.clear()
        self._lines = 0
        try:
            os.unlink(self.path)
        except OSError:
            pass


# -- process-wide journal -----------------------------------------------
# All durable-key writers in one process (drain coordinator, restore
# quorum) share a single per-rank journal file so one replay covers
# everything this rank authored.  Keyed off the launcher-provided elastic
# state dir; absent that (non-elastic runs, unit tests) there is
# nothing durable to journal into and callers get None.

_default: Optional[KeyJournal] = None


def default_journal(rank: Optional[int] = None) -> Optional[KeyJournal]:
    """The process-wide :class:`KeyJournal` under
    ``HVTPU_ELASTIC_STATE_DIR``, or None when no state dir is set."""
    global _default
    state_dir = os.environ.get("HVTPU_ELASTIC_STATE_DIR")
    if not state_dir:
        return None
    r = int(rank or 0)
    if _default is None or (rank is not None and _default.rank != r):
        _default = KeyJournal(state_dir, rank=r)
    return _default


def reset_default() -> None:
    """Drop the cached process-wide journal (tests / re-init)."""
    global _default
    _default = None
