"""``horovod_tpu_torch.tensorflow.keras``, the tf.keras frontend of the
port (counterpart of ``horovod_tpu/tensorflow/keras``; parity:
``horovod/tensorflow/keras/__init__.py``).

The reference ships the keras surface twice — ``horovod.keras`` for
standalone keras and ``horovod.tensorflow.keras`` for ``tf.keras`` —
sharing one implementation under ``horovod/_keras/``.  Here the shared
implementation lives in ``horovod_tpu_torch.keras`` (keras 3 serves both
roles); this package keeps the reference's canonical import path
working unchanged::

    import horovod_tpu_torch.tensorflow.keras as hvd

    hvd.init()
    opt = hvd.DistributedOptimizer(keras.optimizers.SGD(0.01 * hvd.size()))
"""

from __future__ import annotations

from ...keras import *  # noqa: F401,F403
from ...keras import DistributedOptimizer  # noqa: F401
from . import callbacks  # noqa: F401  (pin the local shim module)
from . import elastic  # noqa: F401
