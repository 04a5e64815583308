"""Keras callbacks of the port (counterpart of
``horovod_tpu/keras/callbacks.py``; parity: horovod/keras/callbacks.py):
thin classes binding the shared implementations of
``_keras/callbacks.py`` to keras.callbacks.Callback."""

from __future__ import annotations

import keras

from .._keras import callbacks as _impl


class BroadcastGlobalVariablesCallback(
        _impl.BroadcastGlobalVariablesCallbackImpl,
        keras.callbacks.Callback):
    """Broadcast initial model/optimizer state from ``root_rank`` so
    every rank starts identical (parity:
    hvd.callbacks.BroadcastGlobalVariablesCallback)."""

    def __init__(self, root_rank: int = 0, device: str = ""):
        super().__init__(keras.backend, root_rank, device)


class MetricAverageCallback(_impl.MetricAverageCallbackImpl,
                            keras.callbacks.Callback):
    """Average epoch metrics across ranks before other callbacks see
    them (parity: hvd.callbacks.MetricAverageCallback)."""

    def __init__(self, device: str = ""):
        super().__init__(keras.backend, device)


class LearningRateWarmupCallback(_impl.LearningRateWarmupCallbackImpl,
                                 keras.callbacks.Callback):
    """Gradual LR warmup to lr×size (parity:
    hvd.callbacks.LearningRateWarmupCallback)."""

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch=None, verbose: int = 0,
                 initial_lr=None):
        super().__init__(keras.backend, warmup_epochs,
                         momentum_correction, steps_per_epoch, verbose,
                         initial_lr)


class LearningRateScheduleCallback(_impl.LearningRateScheduleCallbackImpl,
                                   keras.callbacks.Callback):
    """Piecewise LR schedule (parity:
    hvd.callbacks.LearningRateScheduleCallback)."""

    def __init__(self, multiplier, start_epoch: int = 0, end_epoch=None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch=None, initial_lr=None):
        super().__init__(keras.backend, multiplier, start_epoch,
                         end_epoch, staircase, momentum_correction,
                         steps_per_epoch, initial_lr)
