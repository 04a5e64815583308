"""Elastic keras state (parity: ``horovod/tensorflow/keras/elastic.py``
``KerasState``): the tf.keras alias of ``TensorFlowKerasState`` plus
the shared ``run`` decorator."""

from ...elastic import run  # noqa: F401  (parity: hvd.elastic.run)
from ...keras.elastic import (  # noqa: F401
    CommitStateCallback,
    UpdateBatchStateCallback,
    UpdateEpochStateCallback,
)
from ..elastic import TensorFlowKerasState

# Reference class name for the tf.keras path: KerasState(model,
# optimizer=None, **kwargs) with commit/restore/sync semantics.
KerasState = TensorFlowKerasState
