"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu``.

A second package beside the JAX one, with the same module names so each
part can be found by its counterpart.  It imports ``torch`` and never
``jax`` nor anything of ``horovod_tpu``.  Its entry points run on the
card (NCCL on ``cuda:{local_rank}``); the CPU, over gloo, only when the
caller asks for it with ``init(device="cpu")``.

The package root is the ``hvd`` surface (the names of
``horovod_tpu_torch.torch``) and the names of the reference's root that
are not torch's: the meshes (one device a rank), the collectives over a
mesh axis (``spmd``), ``allreduce_gradients``,
``ShardedDistributedOptimizer``, ``ShardedCheckpointer`` (every process
writes its shards of a tree of ``DTensor``s), ``Config``, ``ReduceOp``
and ``data``::

    import horovod_tpu_torch as hvd
    hvd.init()
    mesh = hvd.world_mesh()                 # a DeviceMesh, axis "world"
    y = hvd.spmd.allreduce(x, axis_name="world", mesh=mesh)
    grads = hvd.allreduce_gradients(
        {n: p.grad for n, p in model.named_parameters()})

``hvd.Compression`` is the torch frontend's (``none``, ``fp16``,
``bf16``), whose ops map any other codec to ``none`` as the reference's
torch surface does; the engine's codecs, int8 among them, are
``horovod_tpu_torch.comm.compression.Compression``.
"""

from __future__ import annotations

from .torch import *  # noqa: F401,F403
from .torch import __all__ as _torch_all
from . import comm, core, data, elastic  # noqa: F401  (hvd.elastic)
from .api.optimizer import ShardedDistributedOptimizer, allreduce_gradients
from .api.sharded_checkpoint import ShardedCheckpointer
from .comm import spmd  # noqa: F401
from .comm.reduce_ops import ReduceOp
from .core.basics import ici_built
from .core.config import Config
from .core.exceptions import HorovodTpuError
from .core.state import (
    hierarchical_mesh,
    local_devices,
    mesh,
    num_devices,
    world_mesh,
)
from .version import __version__

__all__ = _torch_all + [
    "__version__",
    "num_devices", "local_devices", "world_mesh", "hierarchical_mesh",
    "mesh", "spmd", "allreduce_gradients", "ShardedDistributedOptimizer",
    "ShardedCheckpointer",
    "ReduceOp", "Config", "HorovodTpuError", "ici_built",
    "comm", "core", "data",
]
