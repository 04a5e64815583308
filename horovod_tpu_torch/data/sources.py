"""Pluggable data sources for :class:`~horovod_tpu_torch.data.ElasticDataLoader`.

Counterpart of ``horovod_tpu/data/sources.py``, copied (numpy only) so
that the port imports nothing of the JAX package.

A source answers exactly two questions — how many samples exist
(``len(source)``) and "materialize these global indices as a batch"
(``fetch(indices)``).  Everything elastic (sharding, cursors, resize
re-sharding) lives in the loader/sharder; sources stay dumb and
stateless so a relaunched incarnation can rebuild one from scratch and
land on byte-identical batches.

``fetch`` returns a *batch structure*: a numpy array, or a dict/tuple
of them, each with the batch as the leading dimension.  The loader
treats the structure opaquely (optionally copying every array leaf onto
the training device), so the same sources serve both packages.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Batch = Union[np.ndarray, Dict[str, "Batch"], Tuple["Batch", ...]]


def map_structure(fn, struct):
    """Apply ``fn`` to every array leaf of a batch structure (dict /
    tuple / list / ndarray) — a tiny dependency-free tree map."""
    if isinstance(struct, dict):
        return {k: map_structure(fn, v) for k, v in struct.items()}
    if isinstance(struct, (tuple, list)):
        mapped = [map_structure(fn, v) for v in struct]
        return tuple(mapped) if isinstance(struct, tuple) else mapped
    return fn(struct)


class DataSource:
    """Base source protocol: ``__len__`` + ``fetch(indices)``."""

    def __len__(self) -> int:
        raise NotImplementedError

    def fetch(self, indices: np.ndarray) -> Batch:
        """Materialize the batch for ``indices`` (global sample ids,
        possibly empty on a ragged epoch tail)."""
        raise NotImplementedError


class ArraySource(DataSource):
    """In-memory arrays (or a dict/tuple of them sharing the leading
    dimension): ``fetch`` is a fancy-index gather per leaf."""

    def __init__(self, data: Batch):
        self.data = data
        lengths = []
        map_structure(lambda a: lengths.append(len(a)), data)
        if not lengths:
            raise ValueError("ArraySource needs at least one array")
        if len(set(lengths)) != 1:
            raise ValueError(
                f"ArraySource arrays disagree on the sample dimension: "
                f"{sorted(set(lengths))}")
        self._n = lengths[0]

    def __len__(self) -> int:
        return self._n

    def fetch(self, indices: np.ndarray) -> Batch:
        return map_structure(lambda a: np.asarray(a)[indices], self.data)


class FileListSource(DataSource):
    """One sample per file path: ``fetch`` loads and stacks the
    selected files (default loader ``np.load``); an optional parallel
    ``labels`` sequence rides along as the second tuple element."""

    def __init__(self, paths: Sequence[str],
                 load_fn: Optional[Callable[[str], np.ndarray]] = None,
                 labels: Optional[Sequence] = None):
        self.paths: List[str] = list(paths)
        self.load_fn = load_fn if load_fn is not None else np.load
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and len(self.labels) != len(self.paths):
            raise ValueError(
                f"labels ({len(self.labels)}) and paths "
                f"({len(self.paths)}) disagree")

    def __len__(self) -> int:
        return len(self.paths)

    def fetch(self, indices: np.ndarray) -> Batch:
        samples = [np.asarray(self.load_fn(self.paths[i]))
                   for i in indices]
        if samples:
            x = np.stack(samples)
        else:  # ragged-tail empty batch keeps a stackable shape
            x = np.empty((0,), dtype=np.float32)
        if self.labels is None:
            return x
        return (x, self.labels[indices])

    @classmethod
    def from_glob(cls, pattern: str, **kwargs) -> "FileListSource":
        import glob

        paths = sorted(glob.glob(pattern))
        if not paths:
            raise FileNotFoundError(
                f"FileListSource.from_glob: no files match {pattern!r} "
                f"(cwd {os.getcwd()})")
        return cls(paths, **kwargs)


class SyntheticSource(DataSource):
    """Deterministic index-derived samples for benchmarks and tests:
    sample ``i`` is a cheap pure function of ``i`` (a broadcast scalar
    pattern plus a modular label), so generation costs one memset-speed
    fill per batch and any two processes agree byte-for-byte without
    sharing data."""

    def __init__(self, num_samples: int, shape: Tuple[int, ...],
                 dtype=np.float32, num_classes: int = 1000,
                 seed: int = 0):
        self.num_samples = int(num_samples)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype) if not hasattr(dtype, "itemsize") \
            else dtype
        self.num_classes = int(num_classes)
        self.seed = int(seed)

    def __len__(self) -> int:
        return self.num_samples

    def fetch(self, indices: np.ndarray) -> Batch:
        idx = np.asarray(indices, dtype=np.int64)
        # per-sample scalar in [0, 1): a fixed-point hash of (seed, i)
        mixed = (idx * 2654435761 + self.seed * 97) % 104729
        base = (mixed / 104729.0).astype(np.float32)
        x = np.broadcast_to(
            base.reshape((-1,) + (1,) * len(self.shape)),
            (len(idx),) + self.shape).astype(self.dtype)
        y = ((idx + self.seed) % self.num_classes).astype(np.int32)
        return {"x": x, "y": y}
