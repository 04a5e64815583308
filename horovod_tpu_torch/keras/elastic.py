"""Elastic keras surface of the port (counterpart of
``horovod_tpu/keras/elastic.py``; parity: ``horovod/keras/elastic.py``
and the shared ``horovod/_keras/elastic.py`` callbacks):
``KerasState`` plus the state-maintenance callbacks the reference's
elastic keras examples drive ``model.fit`` with, and the shared
``run`` decorator."""

import keras

from ..elastic import run  # noqa: F401  (parity: hvd.elastic.run)
from ..tensorflow.elastic import TensorFlowKerasState

KerasState = TensorFlowKerasState


class CommitStateCallback(keras.callbacks.Callback):
    """Commit the elastic state every ``batches_per_commit`` batches
    and at each epoch end (parity: ``hvd.elastic.CommitStateCallback``
    / ``CommitStateCallbackImpl`` in horovod/_keras/elastic.py; the
    epoch-end commit is an addition so the final epoch of a fit is
    never lost).  ``batches_per_commit=0`` disables the per-batch
    commits (reference semantics), leaving only the epoch-end ones.
    A commit is the rollback point for failure recovery and the
    boundary where a pending host update interrupts
    (``HostsUpdatedInterrupt``), so committing more often trades
    commit overhead for less lost work.  Order this AFTER the
    ``Update*StateCallback``s in the callbacks list so each commit
    captures the already-updated batch/epoch counters."""

    def __init__(self, state, batches_per_commit: int = 1):
        super().__init__()
        self.state = state
        self.batches_per_commit = batches_per_commit
        self._remaining = batches_per_commit

    def on_batch_end(self, batch, logs=None):
        if self.batches_per_commit <= 0:
            return
        self._remaining -= 1
        if self._remaining <= 0:
            self._remaining = self.batches_per_commit
            steps = (self.params or {}).get("steps")
            if steps is not None and batch + 1 >= steps:
                # the epoch's final batch: skip — the epoch-end commit
                # below snapshots the same weights WITH the updated
                # epoch/batch counters (the Update*StateCallbacks run
                # first), so committing here would only duplicate the
                # full deep-copy/pickle
                return
            self.state.commit()

    def on_epoch_end(self, epoch, logs=None):
        self._remaining = self.batches_per_commit
        self.state.commit()


class UpdateBatchStateCallback(keras.callbacks.Callback):
    """Track the in-epoch batch number on the state (parity:
    ``hvd.elastic.UpdateBatchStateCallback``); resets to 0 at each
    epoch end.

    Resume granularity under ``model.fit``: Keras 3's fit loop owns
    its iterator, so a restore mid-epoch cannot skip the
    already-consumed batches — fit resumes at EPOCH granularity
    (``initial_epoch=state.epoch``) and replays the interrupted epoch
    from its start (this callback logs that and re-zeros
    ``state.batch`` so in-epoch commits renumber correctly).  Custom
    training loops get true batch-granular resume by starting their
    step range at ``state.batch``."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def on_epoch_begin(self, epoch, logs=None):
        if self.state.batch > 0 and epoch == self.state.epoch:
            import logging

            logging.getLogger("horovod_tpu_torch").warning(
                "elastic resume: epoch %d replays from its start "
                "(%d batches were already consumed before the reset; "
                "keras fit cannot skip into an epoch)",
                epoch, self.state.batch)
            self.state.batch = 0

    def on_train_batch_end(self, batch, logs=None):
        self.state.batch = batch + 1

    def on_epoch_end(self, epoch, logs=None):
        self.state.batch = 0


class UpdateEpochStateCallback(keras.callbacks.Callback):
    """Keep ``state.epoch`` current so a restarted worker resumes from
    the right ``initial_epoch`` (parity:
    ``hvd.elastic.UpdateEpochStateCallback``)."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def on_epoch_end(self, epoch, logs=None):
        self.state.epoch = epoch + 1
