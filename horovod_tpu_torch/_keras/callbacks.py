"""Shared Keras callback implementations of the port (counterpart of
``horovod_tpu/_keras/callbacks.py``; parity: horovod/_keras/callbacks.py,
the logic behind horovod/keras/callbacks.py)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import horovod_tpu_torch as _hvt


class BroadcastGlobalVariablesCallbackImpl:
    """Broadcast model + optimizer state from root_rank at the start of
    training (parity: BroadcastGlobalVariablesCallbackImpl —
    on_batch_end of batch 0, so optimizer slots exist)."""

    def __init__(self, backend, root_rank: int, device: str = "",
                 *args):
        super().__init__(*args)
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        import horovod_tpu_torch.tensorflow as hvd_tf

        model = getattr(self, "model", None)
        if model is None:
            return
        variables = list(model.weights)
        opt = getattr(model, "optimizer", None)
        if opt is not None and hasattr(opt, "variables"):
            opt_vars = opt.variables
            variables += list(opt_vars() if callable(opt_vars)
                              else opt_vars)
        hvd_tf.broadcast_variables(variables, root_rank=self.root_rank)
        self.broadcast_done = True


class MetricAverageCallbackImpl:
    """Average epoch metrics over ranks so logs/checkpoint decisions
    agree everywhere (parity: MetricAverageCallbackImpl)."""

    def __init__(self, backend, device: str = "", *args):
        super().__init__(*args)

    def on_epoch_end(self, epoch, logs: Optional[Dict] = None):
        if not logs:
            return
        import torch

        from ..comm import eager

        dev = _hvt.device()
        for k, v in list(logs.items()):
            if isinstance(v, (int, float, np.floating, np.integer)):
                # a float32 scalar, as the reference averages
                # jnp.asarray(float(v)) with JAX's x64 off
                logs[k] = float(eager.allreduce(
                    torch.tensor(float(v), dtype=torch.float32,
                                 device=dev),
                    op=_hvt.Average, name=f"metric.{k}"))


class LearningRateWarmupCallbackImpl:
    """Linear LR warmup from lr to lr*size over warmup_epochs (parity:
    LearningRateWarmupCallbackImpl: 'epoch = full passes + progress';
    after warmup the multiplier stays at hvd.size())."""

    def __init__(self, backend, warmup_epochs: int = 5, momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0,
                 initial_lr: Optional[float] = None, *args):
        super().__init__(*args)
        self.warmup_epochs = warmup_epochs
        self.initial_lr = initial_lr
        self.verbose = verbose
        self.steps_per_epoch = steps_per_epoch
        self.current_epoch = 0

    def _lr(self):
        return self.model.optimizer.learning_rate

    def on_train_begin(self, logs=None):
        if self.initial_lr is None:
            self.initial_lr = float(np.asarray(self._lr()))

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch

    def _epoch_progress(self, batch):
        if self.steps_per_epoch:
            return self.current_epoch + batch / self.steps_per_epoch
        return float(self.current_epoch)

    def on_batch_begin(self, batch, logs=None):
        if self.current_epoch >= self.warmup_epochs:
            mult = _hvt.size()
        else:
            progress = min(
                self._epoch_progress(batch) / max(self.warmup_epochs, 1e-9),
                1.0,
            )
            mult = 1.0 + progress * (_hvt.size() - 1)
        self.model.optimizer.learning_rate = self.initial_lr * mult

    def on_epoch_end(self, epoch, logs=None):
        if (self.verbose and epoch == self.warmup_epochs - 1
                and _hvt.rank() == 0):
            print(
                f"Epoch {epoch + 1}: finished gradual learning rate "
                f"warmup to {float(np.asarray(self._lr())):g}."
            )


class LearningRateScheduleCallbackImpl:
    """Piecewise LR schedule as a multiplier on the initial LR between
    start_epoch and end_epoch (parity:
    LearningRateScheduleCallbackImpl; multiplier may be a constant or a
    function of epoch; staircase applies it at epoch granularity)."""

    def __init__(self, backend, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None,
                 initial_lr: Optional[float] = None, *args):
        super().__init__(*args)
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr = initial_lr
        self.current_epoch = 0
        if callable(multiplier):
            self.multiplier = multiplier
        else:
            self.multiplier = lambda epoch: multiplier

    def on_train_begin(self, logs=None):
        if self.initial_lr is None:
            self.initial_lr = float(
                np.asarray(self.model.optimizer.learning_rate)
            )

    def _in_range(self, epoch) -> bool:
        if epoch < self.start_epoch:
            return False
        return self.end_epoch is None or epoch < self.end_epoch

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch
        if self.staircase and self._in_range(epoch):
            self.model.optimizer.learning_rate = (
                self.initial_lr * self.multiplier(epoch)
            )

    def on_batch_begin(self, batch, logs=None):
        if self.staircase or not self._in_range(self.current_epoch):
            return
        if self.steps_per_epoch:
            epoch = self.current_epoch + batch / self.steps_per_epoch
        else:
            epoch = float(self.current_epoch)
        self.model.optimizer.learning_rate = (
            self.initial_lr * self.multiplier(epoch)
        )
