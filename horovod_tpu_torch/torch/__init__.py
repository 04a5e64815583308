"""horovod_tpu_torch.torch — the ``horovod.torch``-shaped surface of the
PyTorch port (counterpart of ``horovod_tpu/torch``).

Usage (the reference's shape)::

    import horovod_tpu_torch.torch as hvd
    hvd.init()                      # NCCL on cuda:{local_rank}
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.fp16,
        gradient_predivide_factor=2.0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

The collectives (``mpi_ops.py``) take the reference's positional
signatures, are differentiable, and map ``hvd.Compression.fp16`` /
``bf16`` onto the engine's cast codecs and anything else onto ``none``,
as the reference does.  The engine's int8 wire is reached through the
engine's own allreduce::

    from horovod_tpu_torch.comm import eager
    from horovod_tpu_torch.comm.compression import Compression
    eager.allreduce(t, compression=Compression.int8)
"""

from __future__ import annotations

from ..comm.reduce_ops import Average, Max, Min, Product, Sum
from ..core.exceptions import NotInitializedError
from ..core.process_set import ProcessSet, global_process_set
from ..core.state import (
    device,
    init,
    is_initialized,
    local_rank,
    rank,
    shutdown,
    size,
)
from .compression import Compression
from .functions import (
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .mpi_ops import (
    allgather,
    allreduce,
    allreduce_,
    alltoall,
    barrier,
    broadcast,
    broadcast_,
    grouped_allreduce,
    grouped_allreduce_,
    reducescatter,
)
from .optimizer import DistributedOptimizer

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "device", "ProcessSet", "global_process_set", "NotInitializedError",
    "Compression", "Sum", "Average", "Min", "Max", "Product",
    "allreduce", "allreduce_", "grouped_allreduce", "grouped_allreduce_",
    "allgather", "alltoall",
    "reducescatter", "broadcast", "broadcast_", "barrier",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_object", "DistributedOptimizer",
]
