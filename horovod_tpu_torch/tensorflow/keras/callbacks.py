"""Parity shim: ``horovod/tensorflow/keras/callbacks.py`` re-exports
the shared callback implementations (reference shares them via
``horovod/_keras/callbacks.py``)."""

from ...keras.callbacks import (  # noqa: F401
    BroadcastGlobalVariablesCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    MetricAverageCallback,
)
