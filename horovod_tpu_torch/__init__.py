"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu``.

A second package beside the JAX one, with the same module names so each
part can be found by its counterpart.  It imports ``torch`` and never
``jax`` nor anything of ``horovod_tpu``.  Its entry points run on the
card (NCCL on ``cuda:{local_rank}``); the CPU, over gloo, only when the
caller asks for it with ``init(device="cpu")``.

The package root is the ``hvd`` surface (the same names as
``horovod_tpu_torch.torch``)::

    import horovod_tpu_torch as hvd
    hvd.init()
"""

from __future__ import annotations

from .torch import *  # noqa: F401,F403
from .torch import __all__  # noqa: F401
from . import elastic  # noqa: F401  (hvd.elastic)
