"""horovod_tpu_torch.torch — the ``horovod.torch``-shaped surface of the
PyTorch port (counterpart of ``horovod_tpu/torch``).

Usage (the reference's shape)::

    import horovod_tpu_torch.torch as hvd
    hvd.init()                      # NCCL on cuda:{local_rank}
    hvd.local_size(), hvd.cross_rank(), hvd.is_homogeneous()
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

Past one rank the sync collectives and the optimizer's buckets run
under the stall watchdog (``HVTPU_STALL_CHECK_TIME_SECONDS``,
``HVTPU_STALL_SHUTDOWN_TIME_SECONDS``); ``stall_guard`` covers a
training step's boundary::

    step = hvd.stall_guard(train_step, name="train")

The timeline (``HVTPU_TIMELINE`` at ``init()``, or at any time)::

    hvd.start_timeline("/tmp/timeline.json", mark_cycles=False)
    ...
    hvd.stop_timeline()

Elastic training (``hvd.elastic``: ``run``, ``TorchState``,
``ElasticSampler``; the data loader in ``horovod_tpu_torch.data``) and
checkpoints (``hvd.Checkpointer``)::

    state = hvd.elastic.TorchState(model, optimizer, data=loader.state)

    @hvd.elastic.run
    def train(state):
        ...
        state.commit()

The engine's int8 wire is reached through the engine's own
allreduce::

    from horovod_tpu_torch.comm import eager
    from horovod_tpu_torch.comm.compression import Compression
    eager.allreduce(t, compression=Compression.int8)
"""

from __future__ import annotations

from ..comm.reduce_ops import Adasum, Average, Max, Min, Product, Sum
from ..comm.stall import stall_guard
from ..core.exceptions import (
    DrainInterrupt,
    HorovodInternalError,
    HostsUpdatedInterrupt,
    HvtpuDivergenceError,
    HvtpuMismatchError,
    NotInitializedError,
    StallError,
)
from ..core.basics import (
    ccl_built,
    cuda_built,
    ddl_built,
    gloo_built,
    gloo_enabled,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rocm_built,
    xla_built,
)
from ..core.process_set import ProcessSet, global_process_set
from ..core.state import (
    add_process_set,
    cross_rank,
    cross_size,
    device,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    rank,
    remove_process_set,
    shutdown,
    size,
    start_timeline,
    stop_timeline,
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
from .sync_batch_norm import SyncBatchNorm
from ..api.checkpoint import (
    Checkpointer,
    restore_checkpoint,
    save_checkpoint,
)
from . import elastic  # noqa: E402  (hvd.elastic.TorchState parity)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous",
    "mpi_enabled", "mpi_built", "mpi_threads_supported", "gloo_enabled",
    "gloo_built", "nccl_built", "ddl_built", "ccl_built", "cuda_built",
    "rocm_built", "xla_built",
    "device", "ProcessSet", "global_process_set", "add_process_set",
    "remove_process_set", "start_timeline", "stop_timeline",
    "NotInitializedError", "HorovodInternalError",
    "HvtpuMismatchError", "HvtpuDivergenceError", "StallError",
    "HostsUpdatedInterrupt", "DrainInterrupt", "stall_guard",
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
    "SyncBatchNorm",
    "Checkpointer", "save_checkpoint", "restore_checkpoint",
]
