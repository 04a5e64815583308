"""Cross-rank synchronized BatchNormalization for tf.keras (counterpart
of ``horovod_tpu/tensorflow/sync_batch_norm.py``; parity:
``horovod/tensorflow/sync_batch_norm.py`` ``SyncBatchNormalization``).

The layer replaces the batch moments of keras's BatchNormalization
(Keras 3's ``_moments`` seam) with moments over the global batch: the
local sums, sums of squares and row count ride one packed Sum allreduce,
the port's wire structure of ``SyncBatchNorm``, and the backward
differentiates through that allreduce by its registered gradient.  The
moving averages and inference mode are the base layer's.
"""

from __future__ import annotations

import keras
import tensorflow as tf

from . import mpi_ops


class SyncBatchNormalization(keras.layers.BatchNormalization):
    """Drop-in for ``keras.layers.BatchNormalization`` whose training
    statistics span every rank's batch (parity:
    hvd.SyncBatchNormalization; ``process_set`` scopes them to a subset
    of ranks)."""

    def __init__(self, *args, process_set=None, **kwargs):
        # the cross-rank hook lives on the Keras 3 `_moments` seam; a base
        # class without it would silently train on local statistics
        if not hasattr(keras.layers.BatchNormalization, "_moments"):
            raise RuntimeError(
                "SyncBatchNormalization requires Keras 3 "
                "(keras.layers.BatchNormalization._moments seam not "
                "found)")
        super().__init__(*args, **kwargs)
        # a ProcessSet, or its id (what get_config round-trips; the
        # engine resolves ids against the live table)
        self._process_set = process_set

    def get_config(self):
        config = super().get_config()
        ps = self._process_set
        if ps is not None and not isinstance(ps, int):
            if ps.process_set_id is None:
                # an unbound set would serialize as None and silently
                # widen the reloaded layer to the global set
                raise ValueError(
                    "SyncBatchNormalization's process_set is not "
                    "registered — call hvd.add_process_set(ps) (after "
                    "init) before serializing the model")
            ps = ps.process_set_id
        config["process_set"] = ps
        return config

    def _moments(self, inputs, mask):
        from ..core import state as core_state
        from ..core.process_set import participant_count

        if not core_state.is_initialized() \
                or participant_count(self._process_set) == 1:
            return super()._moments(inputs, mask)
        if mask is not None:
            # local masked moments would silently desync the ranks
            raise NotImplementedError(
                "SyncBatchNormalization does not support masked "
                "moments in multi-rank training")

        x = tf.cast(inputs, tf.float32)
        axes = list(self._reduction_axes)
        local_sum = tf.reduce_sum(x, axis=axes)
        local_sqsum = tf.reduce_sum(tf.square(x), axis=axes)
        # the ranks' row counts may differ (a ragged last batch): the
        # count rides the same allreduce as the sums
        local_count = tf.cast(tf.size(x) / tf.size(local_sum), tf.float32)
        c = tf.size(local_sum)
        packed = tf.concat(
            [local_sum, local_sqsum, tf.reshape(local_count, [1])], 0)
        packed = mpi_ops.allreduce(
            packed, op=mpi_ops.Sum, name="sync_bn.stats",
            process_set=self._process_set)
        g_sum = packed[:c]
        g_sqsum = packed[c:2 * c]
        # every rank may see an empty batch on one step: a zero count
        # would poison the moving statistics with NaN, so the step
        # degrades to zero moments (the sums are zero too)
        g_count = tf.maximum(packed[2 * c], 1.0)
        mean = g_sum / g_count
        # E[x^2]-E[x]^2 can go fractionally negative by cancellation
        variance = tf.maximum(g_sqsum / g_count - tf.square(mean), 0.0)
        return (tf.cast(mean, inputs.dtype),
                tf.cast(variance, inputs.dtype))
