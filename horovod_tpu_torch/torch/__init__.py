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
as the reference does.  The async ops (``allreduce_async`` and the rest)
go through the async controller and return handles for
``synchronize`` / ``poll``; process sets are added collectively::

    ps = hvd.add_process_set([0, 2])       # every rank calls it
    h = hvd.allreduce_async(t, op=hvd.Sum, process_set=ps)
    out = hvd.synchronize(h)

The engine's int8 wire is reached through the engine's own
allreduce::

    from horovod_tpu_torch.comm import eager
    from horovod_tpu_torch.comm.compression import Compression
    eager.allreduce(t, compression=Compression.int8)
"""

from __future__ import annotations

from ..comm.reduce_ops import Adasum, Average, Max, Min, Product, Sum
from ..core.exceptions import (
    HorovodInternalError,
    HvtpuMismatchError,
    NotInitializedError,
)
from ..core.process_set import ProcessSet, global_process_set
from ..core.state import (
    add_process_set,
    device,
    init,
    is_initialized,
    local_rank,
    rank,
    remove_process_set,
    shutdown,
    size,
)
from .compression import Compression
from .functions import (
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .mpi_ops import (
    SparseAllreduceHandle,
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    grouped_allgather,
    grouped_allgather_async,
    grouped_allreduce,
    grouped_allreduce_,
    grouped_allreduce_async,
    grouped_reducescatter,
    grouped_reducescatter_async,
    join,
    poll,
    reducescatter,
    reducescatter_async,
    sparse_allreduce_async,
    synchronize,
)
from .optimizer import DistributedOptimizer

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "device", "ProcessSet", "global_process_set", "add_process_set",
    "remove_process_set", "NotInitializedError", "HorovodInternalError",
    "HvtpuMismatchError",
    "Compression", "Sum", "Average", "Adasum", "Min", "Max", "Product",
    "allreduce", "allreduce_", "grouped_allreduce", "grouped_allreduce_",
    "allgather", "grouped_allgather", "alltoall",
    "reducescatter", "grouped_reducescatter", "broadcast", "broadcast_",
    "barrier",
    "allreduce_async", "allreduce_async_", "grouped_allreduce_async",
    "allgather_async", "grouped_allgather_async", "broadcast_async",
    "broadcast_async_", "alltoall_async", "reducescatter_async",
    "grouped_reducescatter_async", "sparse_allreduce_async",
    "SparseAllreduceHandle", "synchronize", "poll", "join",
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_object", "allgather_object", "DistributedOptimizer",
]
