"""Deterministic sample-space sharding with resize re-sharding.

Counterpart of ``horovod_tpu/data/sharder.py``, copied (numpy only) so
that the port imports nothing of the JAX package: the same seed, epoch
and cursor give the same indices in both packages.

The unit of truth is a **seeded per-epoch permutation** over the global
sample indices plus one **global cursor** — the number of samples the
whole world has consumed this epoch.  Both are pure functions of
committed state (``seed``, ``epoch``, ``cursor``), never of rank or
world size, which is what makes elastic resizes lossless:

* Every rank computes the same ``permutation(seed, epoch)``.
* At each step the world consumes one contiguous window
  ``perm[cursor : cursor + min(size * batch_size, n - cursor)]`` and
  splits it contiguously across ranks (``np.array_split`` semantics:
  piece sizes differ by at most one, possibly empty on a short tail).
* After a generation change the *unconsumed remainder* ``perm[cursor:]``
  is simply re-split across the NEW world — no sample in the remainder
  is repeated or dropped, because the cursor (restored from the elastic
  commit) marks exactly what was already delivered.

Because the step count per epoch — ``ceil((n - cursor0) /
(size * batch_size))`` — is itself a function of shared state, every
rank agrees on the epoch-end boundary without communication; the
loader's allreduce-min length agreement (docs/data.md) only exists to
catch *sources* that disagree about ``n`` across hosts.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def epoch_permutation(num_samples: int, seed: int, epoch: int,
                      shuffle: bool = True) -> np.ndarray:
    """The global sample order for one epoch: a permutation of
    ``arange(num_samples)`` drawn from a ``(seed, epoch)``-keyed RNG —
    identical on every rank and across elastic incarnations, different
    per epoch.  ``shuffle=False`` returns the identity order."""
    if num_samples < 0:
        raise ValueError(f"num_samples must be >= 0, got {num_samples}")
    if not shuffle:
        return np.arange(num_samples, dtype=np.int64)
    rng = np.random.Generator(
        np.random.PCG64(np.random.SeedSequence([int(seed), int(epoch)])))
    return rng.permutation(num_samples).astype(np.int64)


def world_batch(size: int, batch_size: int) -> int:
    """Samples the whole world consumes per step."""
    if size < 1 or batch_size < 1:
        raise ValueError(
            f"size and batch_size must be >= 1, got {size}, {batch_size}")
    return size * batch_size


def steps_remaining(num_samples: int, cursor: int, size: int,
                    batch_size: int) -> int:
    """Steps left in the epoch from ``cursor`` — the same number on
    every rank (it depends only on shared state), so no rank can run
    past its peers into a deadlocked collective."""
    left = max(num_samples - cursor, 0)
    wb = world_batch(size, batch_size)
    return -(-left // wb)  # ceil


def step_window(num_samples: int, cursor: int, size: int,
                batch_size: int) -> int:
    """How many samples the world consumes at THIS step (the full
    ``size * batch_size`` mid-epoch, the ragged remainder on the final
    step)."""
    return min(world_batch(size, batch_size), max(num_samples - cursor, 0))


def shard_window(perm: np.ndarray, cursor: int, rank: int, size: int,
                 batch_size: int) -> Tuple[np.ndarray, int]:
    """(this rank's sample indices for the step, the new global cursor).

    The step window is split contiguously: rank ``r`` takes the ``r``-th
    piece of ``np.array_split(window, size)``.  On a full window every
    piece is exactly ``batch_size``; on the epoch's ragged tail pieces
    differ by at most one sample and trailing ranks may get an empty
    batch (route those through ``hvd.join()`` if the training loop runs
    a collective per batch — see docs/data.md).
    """
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} out of range for size {size}")
    n = len(perm)
    take = step_window(n, cursor, size, batch_size)
    window = perm[cursor:cursor + take]
    piece = np.array_split(window, size)[rank]
    return piece.astype(np.int64), cursor + take


class Sharder:
    """Per-epoch permutation cache over the pure functions above."""

    def __init__(self, num_samples: int, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.num_samples = int(num_samples)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self._cached_epoch: int = -1
        self._cached_perm: np.ndarray = np.empty(0, dtype=np.int64)

    def permutation(self, epoch: int) -> np.ndarray:
        if epoch != self._cached_epoch:
            self._cached_perm = epoch_permutation(
                self.num_samples, self.seed, epoch, self.shuffle)
            self._cached_epoch = epoch
        return self._cached_perm

    def steps_remaining(self, cursor: int, size: int) -> int:
        return steps_remaining(self.num_samples, cursor, size,
                               self.batch_size)

    def next_indices(self, epoch: int, cursor: int, rank: int,
                     size: int) -> Tuple[np.ndarray, int]:
        """This rank's indices for the step starting at ``cursor``,
        plus the post-step global cursor."""
        return shard_window(self.permutation(epoch), cursor, rank, size,
                            self.batch_size)
