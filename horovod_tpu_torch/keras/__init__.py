"""Keras frontend of the port (counterpart of
``horovod_tpu/keras/__init__.py``; parity: ``horovod/keras/__init__.py``
and ``horovod/tensorflow/keras/``): ``hvd.DistributedOptimizer`` for
keras optimizers, ``load_model``, the callbacks, and the surface of the
TensorFlow frontend.

Usage (only the import changes against the reference)::

    import horovod_tpu_torch.keras as hvd

    hvd.init()
    opt = keras.optimizers.SGD(0.01 * hvd.size())
    opt = hvd.DistributedOptimizer(opt)
    model.compile(optimizer=opt, ...)
    model.fit(..., callbacks=[
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
    ])
"""

from __future__ import annotations

from ..tensorflow import (  # noqa: F401
    Adasum,
    Average,
    Compression,
    HorovodInternalError,
    HostsUpdatedInterrupt,
    Max,
    Min,
    Product,
    ProcessSet,
    Sum,
    add_process_set,
    allgather,
    allgather_object,
    allreduce,
    alltoall,
    barrier,
    broadcast,
    broadcast_object,
    broadcast_variables,
    ccl_built,
    cross_rank,
    cross_size,
    cuda_built,
    ddl_built,
    gloo_built,
    gloo_enabled,
    grouped_allgather,
    grouped_allreduce,
    grouped_reducescatter,
    init,
    is_initialized,
    join,
    local_rank,
    local_size,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    nccl_built,
    rank,
    remove_process_set,
    rocm_built,
    shutdown,
    size,
    start_timeline,
    stop_timeline,
    xla_built,
)
from . import callbacks  # noqa: F401
from . import elastic  # noqa: F401  (hvd.elastic.KerasState parity)


def DistributedOptimizer(optimizer, name=None,
                         device_dense="", device_sparse="",
                         compression=Compression.none,
                         sparse_as_dense=False, op=Average,
                         gradient_predivide_factor: float = 1.0,
                         backward_passes_per_step: int = 1,
                         average_aggregated_gradients: bool = True,
                         process_set=None):
    """Wrap a keras optimizer with gradient allreduce (parity:
    horovod.keras.DistributedOptimizer)."""
    from .._keras import create_distributed_optimizer

    return create_distributed_optimizer(
        optimizer, name=name, compression=compression, op=op,
        gradient_predivide_factor=gradient_predivide_factor,
        backward_passes_per_step=backward_passes_per_step,
        average_aggregated_gradients=average_aggregated_gradients,
        process_set=process_set,
    )


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """Load a saved keras model with its optimizer wrapped in
    ``DistributedOptimizer`` (parity: horovod.keras.load_model /
    horovod.tensorflow.keras.load_model).  The optimizer deserializes
    INTO the wrapped class, so saved optimizer state (iterations,
    Adam m/v slots) restores and subsequent fits allreduce gradients
    — resuming a single-rank checkpoint distributed is the
    reference's canonical use."""
    import keras

    from .._keras import load_model_impl

    return load_model_impl(
        keras, filepath, custom_optimizers=custom_optimizers,
        custom_objects=custom_objects, compression=compression)
