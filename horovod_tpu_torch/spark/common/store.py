"""Store abstraction for the Spark estimators' intermediate data and
checkpoints (counterpart of ``horovod_tpu/spark/common/store.py``).

Parity surface: ``horovod/spark/common/store.py`` (``Store``,
``FilesystemStore``, ``LocalStore``, ``HDFSStore``) — the reference's
Store owns three path families per training run: materialized train/val
data, per-run checkpoints, and per-run logs, plus small read/write
helpers the estimators use for metadata.

Scope: the durable medium is a (shared) local filesystem — the same
medium the launcher's function/result channel and the elastic
checkpoints already ride — so ``FilesystemStore`` is the real
implementation and ``LocalStore`` its alias (mirroring the reference,
where LocalStore is FilesystemStore pinned to ``file://``).  Object
stores (HDFS/S3/GCS/DBFS) raise with a pointer: a cluster's NFS or
mounted bucket serves the same role.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional


class Store:
    """Abstract run/data/checkpoint path layout for estimators.

    Matches the reference's surface: ``get_train_data_path()``,
    ``get_val_data_path()``, ``get_run_path(run_id)``,
    ``get_checkpoint_path(run_id)``, ``get_logs_path(run_id)``,
    ``exists()/read()/write_text()``, and the ``create(prefix)``
    factory that picks an implementation from the path scheme.
    """

    @classmethod
    def create(cls, prefix_path: str, *args, **kwargs) -> "Store":
        scheme = prefix_path.split("://", 1)[0] if "://" in prefix_path \
            else "file"
        if scheme in ("file", ""):
            return FilesystemStore(prefix_path, *args, **kwargs)
        raise NotImplementedError(
            f"store scheme {scheme!r}: object-store backends (HDFS/S3/"
            "GCS/DBFS) are out of scope in this build — mount the "
            "bucket (gcsfuse/NFS) and use a file:// prefix, or "
            "subclass Store (parity: horovod/spark/common/store.py)."
        )

    # -- path layout -------------------------------------------------
    def get_full_path(self, path: str) -> str:
        raise NotImplementedError

    def get_train_data_path(self, idx: Optional[int] = None) -> str:
        raise NotImplementedError

    def get_val_data_path(self, idx: Optional[int] = None) -> str:
        raise NotImplementedError

    def get_data_metadata_path(self) -> str:
        raise NotImplementedError

    def get_runs_path(self) -> str:
        raise NotImplementedError

    def get_run_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    # -- small IO helpers the estimators use -------------------------
    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write_text(self, path: str, text: str) -> None:
        raise NotImplementedError

    def saving_runs(self) -> bool:
        """Whether checkpoints/logs are persisted (reference knob)."""
        raise NotImplementedError


class FilesystemStore(Store):
    """Store over a plain filesystem prefix (shared FS on a pod).

    Layout under ``prefix_path`` (mirrors the reference's):
    ``intermediate_train_data/``, ``intermediate_val_data/``,
    ``runs/<run_id>/checkpoints/``, ``runs/<run_id>/logs/``.
    """

    def __init__(self, prefix_path: str, save_runs: bool = True):
        self.prefix_path = self._strip_scheme(prefix_path)
        self._save_runs = save_runs
        os.makedirs(self.prefix_path, exist_ok=True)

    @staticmethod
    def _strip_scheme(p: str) -> str:
        return p[len("file://"):] if p.startswith("file://") else p

    def get_full_path(self, path: str) -> str:
        path = self._strip_scheme(path)
        if os.path.isabs(path):
            return path
        return os.path.join(self.prefix_path, path)

    def get_train_data_path(self, idx: Optional[int] = None) -> str:
        base = os.path.join(self.prefix_path, "intermediate_train_data")
        return base if idx is None else os.path.join(base, f"part_{idx}")

    def get_val_data_path(self, idx: Optional[int] = None) -> str:
        base = os.path.join(self.prefix_path, "intermediate_val_data")
        return base if idx is None else os.path.join(base, f"part_{idx}")

    def get_data_metadata_path(self) -> str:
        return os.path.join(self.prefix_path, "intermediate_train_data",
                            "_metadata.json")

    def get_runs_path(self) -> str:
        return os.path.join(self.prefix_path, "runs")

    def get_run_path(self, run_id: str) -> str:
        return os.path.join(self.get_runs_path(), run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "checkpoints")

    def get_logs_path(self, run_id: str) -> str:
        return os.path.join(self.get_run_path(run_id), "logs")

    def get_checkpoints(self, run_id: str,
                        suffix: str = "") -> List[str]:
        """Checkpoint filenames for a run, sorted (reference helper)."""
        d = self.get_checkpoint_path(run_id)
        if not os.path.isdir(d):
            return []
        return sorted(f for f in os.listdir(d) if f.endswith(suffix))

    def exists(self, path: str) -> bool:
        return os.path.exists(self.get_full_path(path))

    def read(self, path: str) -> bytes:
        with open(self.get_full_path(path), "rb") as f:
            return f.read()

    def write_text(self, path: str, text: str) -> None:
        full = self.get_full_path(path)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = full + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, full)

    def read_json(self, path: str):
        return json.loads(self.read(path).decode())

    def saving_runs(self) -> bool:
        return self._save_runs


class LocalStore(FilesystemStore):
    """Reference alias: a FilesystemStore on node-local disk."""
