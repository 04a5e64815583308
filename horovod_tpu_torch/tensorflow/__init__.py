"""TensorFlow frontend of the port: the ``horovod.tensorflow``-shaped
surface on the torch engine (counterpart of
``horovod_tpu/tensorflow/__init__.py``).

``hvd.init/rank/size`` and every other surface name are the port's
root's; the collectives (``mpi_ops.py``) bridge tf tensors onto the
engine through DLPack, eagerly and inside a ``tf.function``;
``DistributedGradientTape``, ``DistributedOptimizer``,
``broadcast_variables`` and the object helpers sit on top.  A tf.keras
user switches with only the import line changed::

    import horovod_tpu_torch.tensorflow as hvd

    hvd.init()                  # on the card; init(device="cpu") for gloo
    with tf.GradientTape() as tape:
        loss = ...
    tape = hvd.DistributedGradientTape(tape)
    grads = tape.gradient(loss, model.trainable_variables)

Importing this module imports tensorflow and keras; ``import
horovod_tpu_torch`` alone imports neither.
"""

from __future__ import annotations

import tensorflow as tf
import torch

import horovod_tpu_torch as _hvt

# ---- lifecycle / topology (the port's root) ----
init = _hvt.init
shutdown = _hvt.shutdown
is_initialized = _hvt.is_initialized
rank = _hvt.rank
size = _hvt.size
local_rank = _hvt.local_rank
local_size = _hvt.local_size
cross_rank = _hvt.cross_rank
cross_size = _hvt.cross_size
mpi_enabled = _hvt.mpi_enabled
mpi_built = _hvt.mpi_built
mpi_threads_supported = _hvt.mpi_threads_supported
gloo_enabled = _hvt.gloo_enabled
gloo_built = _hvt.gloo_built
nccl_built = _hvt.nccl_built
ddl_built = _hvt.ddl_built
ccl_built = _hvt.ccl_built
cuda_built = _hvt.cuda_built
rocm_built = _hvt.rocm_built
xla_built = _hvt.xla_built
start_timeline = _hvt.start_timeline
stop_timeline = _hvt.stop_timeline
ProcessSet = _hvt.ProcessSet
add_process_set = _hvt.add_process_set
remove_process_set = _hvt.remove_process_set
HorovodInternalError = _hvt.HorovodInternalError
HostsUpdatedInterrupt = _hvt.HostsUpdatedInterrupt
is_homogeneous = _hvt.is_homogeneous

from .compression import Compression  # noqa: E402
from . import mpi_ops  # noqa: E402
from .mpi_ops import (  # noqa: E402
    Adasum,
    Average,
    Max,
    Min,
    Product,
    Sum,
    allgather,
    allreduce,
    alltoall,
    barrier,
    broadcast,
    grouped_allgather,
    grouped_allreduce,
    grouped_reducescatter,
    join,
    reducescatter,
)
from . import elastic  # noqa: E402
from .sync_batch_norm import SyncBatchNormalization  # noqa: E402


# ---------------------------------------------------------------------------
# variable / object helpers
# ---------------------------------------------------------------------------

def size_op(process_set_id: int = 0, name=None):
    """Graph-usable size of the given process set (parity:
    hvd.size_op): a constant, since the value is fixed for the life of
    the world.  An unknown id raises."""
    if process_set_id == 0:
        n = size()
    else:
        st = _hvt.core.state.require_init("size_op")
        n = st.process_set_table.get(process_set_id).size
    return tf.constant(n, tf.int32, name=name or "horovod_size")


def rank_op(name=None):
    """Graph-usable rank (parity: hvd.rank_op)."""
    return tf.constant(rank(), tf.int32, name=name or "horovod_rank")


def local_rank_op(name=None):
    """Graph-usable local rank (parity: hvd.local_rank_op)."""
    return tf.constant(local_rank(), tf.int32,
                       name=name or "horovod_local_rank")


def local_size_op(name=None):
    """Graph-usable local size (parity: hvd.local_size_op)."""
    return tf.constant(local_size(), tf.int32,
                       name=name or "horovod_local_size")


def broadcast_variables(variables, root_rank: int = 0, process_set=None):
    """Assign every variable its root-rank value (parity:
    hvd.broadcast_variables).

    Eagerly, every variable rides one byte buffer on the port's device:
    the bridged values viewed as bytes and packed, one broadcast, and
    each variable assigned its slice.  Inside a graph (and for a
    single variable) the fused per-dtype path below runs.
    """
    variables = [v for v in variables if v is not None]
    if not variables:
        return
    if len(variables) == 1 or not tf.executing_eagerly():
        # TF1 session callers run the returned grouped op; tf.function
        # callers execute the assigns as traced side effects
        return _broadcast_variables_graph(variables, root_rank,
                                          process_set)
    xs = [mpi_ops._to_engine(v) for v in variables]
    # each variable at an offset aligned as tf needs its buffers, so
    # that its slice of the result goes back to tf without a copy
    align = mpi_ops.TF_ALIGN
    spans, total = [], 0
    for x in xs:
        n = x.numel() * x.element_size()
        spans.append((total, n))
        total += -(-n // align) * align
    buf = torch.zeros(total, dtype=torch.uint8, device=xs[0].device)
    for x, (off, n) in zip(xs, spans):
        buf[off:off + n] = x.contiguous().reshape(-1).view(torch.uint8)
    out = mpi_ops.eager.broadcast(buf, root_rank=root_rank,
                                  process_set=process_set)
    for var, x, (off, n) in zip(variables, xs, spans):
        piece = out[off:off + n].view(x.dtype).reshape(x.shape)
        var.assign(mpi_ops._from_engine(piece, var))


def _broadcast_variables_graph(variables, root_rank, process_set):
    """Trace-compatible fused broadcast: variables are grouped by dtype,
    each group concatenated into one flat tensor, broadcast once (one
    engine round trip a dtype rather than one a variable), then split
    and assigned back.  A dtype with one variable, and variables of
    dynamic shape, are broadcast alone.  Returns one grouped op so that
    a TF1 session caller can ``session.run`` it."""
    by_dtype = {}
    singles = []
    assigns = []
    for v in variables:
        if v.shape.is_fully_defined():
            by_dtype.setdefault(v.dtype.base_dtype, []).append(v)
        else:
            singles.append(v)
    for dtype, vs in by_dtype.items():
        if len(vs) == 1:
            singles.extend(vs)
            continue
        sizes = [int(v.shape.num_elements()) for v in vs]
        fused = tf.concat(
            [tf.reshape(tf.convert_to_tensor(v), [-1]) for v in vs], 0)
        out = broadcast(fused, root_rank=root_rank, process_set=process_set)
        # py_function erases the static shape; restore it for the split
        out = tf.ensure_shape(out, [sum(sizes)])
        for v, part in zip(vs, tf.split(out, sizes)):
            assigns.append(v.assign(tf.reshape(part, v.shape)))
    for v in singles:
        assigns.append(v.assign(
            broadcast(tf.convert_to_tensor(v), root_rank=root_rank,
                      process_set=process_set)))
    return tf.group(*assigns)


def broadcast_global_variables(root_rank: int = 0):
    """TF1 parity: ``hvd.broadcast_global_variables(root_rank)``, an op
    assigning every variable of the v1 GLOBAL_VARIABLES collection its
    root-rank value; run it once after the session is created."""
    if tf.executing_eagerly():
        raise RuntimeError(
            "broadcast_global_variables() is graph-mode only (the "
            "global-variables collection is a TF1 concept); use "
            "broadcast_variables(model.variables, root_rank) eagerly")
    return _broadcast_variables_graph(
        tf.compat.v1.global_variables(), root_rank, None)


class BroadcastGlobalVariablesHook(tf.compat.v1.train.SessionRunHook):
    """TF1 parity: ``hvd.BroadcastGlobalVariablesHook(0)``, a
    SessionRunHook for ``tf.compat.v1.train.MonitoredTrainingSession``
    that broadcasts the root's initial global variables once the
    session exists."""

    def __init__(self, root_rank: int = 0, device: str = ""):
        super().__init__()
        self.root_rank = root_rank
        # accepted for signature parity; the engine places the tensors
        self.device = device
        self.bcast_op = None

    def begin(self):
        self.bcast_op = broadcast_global_variables(self.root_rank)

    def after_create_session(self, session, coord):
        session.run(self.bcast_op)


def broadcast_object(obj, root_rank: int = 0, process_set=None):
    return _hvt.broadcast_object(obj, root_rank=root_rank,
                                 process_set=process_set)


def broadcast_object_fn(root_rank: int = 0, session=None, name=None,
                        process_set=None):
    """Parity: hvd.broadcast_object_fn, a callable ``bcast(obj)`` bound
    to the given root (``session`` and ``name`` accepted for signature
    compatibility)."""
    def _bcast(obj):
        return broadcast_object(obj, root_rank=root_rank,
                                process_set=process_set)

    return _bcast


def allgather_object(obj, process_set=None):
    return _hvt.allgather_object(obj, process_set=process_set)


# ---------------------------------------------------------------------------
# DistributedGradientTape (the TF2 training idiom)
# ---------------------------------------------------------------------------

class _DistributedGradientTape:
    """Parity: hvd.DistributedGradientTape, a tape whose ``gradient()``
    allreduces every gradient before returning it.

    A delegating proxy rather than a tf.GradientTape subclass: the real
    tape stays untouched, so ``watch``, ``jacobian`` and the context
    manager behave as the wrapped tape's.
    """

    def __init__(self, tape: tf.GradientTape, device_dense="",
                 device_sparse="", compression=Compression.none,
                 sparse_as_dense=False, op=Average,
                 gradient_predivide_factor: float = 1.0,
                 num_groups: int = 0, process_set=None):
        self.__dict__["_tape"] = tape
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense
        self._op = op
        self._predivide = gradient_predivide_factor
        self._process_set = process_set

    def __getattr__(self, item):
        return getattr(self.__dict__["_tape"], item)

    def __enter__(self):
        self.__dict__["_tape"].__enter__()
        return self

    def __exit__(self, *exc):
        return self.__dict__["_tape"].__exit__(*exc)

    def _allreduce_one(self, grad):
        if grad is None:
            return None
        if isinstance(grad, tf.IndexedSlices) and self._sparse_as_dense:
            grad = tf.convert_to_tensor(grad)
        op, prescale, postscale = mpi_ops.predivide_scaling(
            self._op, self._predivide, self._process_set)
        return allreduce(
            grad, op=op, compression=self._compression,
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=self._process_set)

    def gradient(self, target, sources, output_gradients=None, **kwargs):
        grads = self.__dict__["_tape"].gradient(
            target, sources, output_gradients, **kwargs)
        # sources may be any nest; every leaf is allreduced (None leaves
        # pass through)
        return tf.nest.map_structure(self._allreduce_one, grads)


def DistributedGradientTape(gradtape, device_dense="", device_sparse="",
                            compression=Compression.none,
                            sparse_as_dense=False, op=Average,
                            gradient_predivide_factor: float = 1.0,
                            num_groups: int = 0, process_set=None):
    """Parity: hvd.DistributedGradientTape(tape)."""
    return _DistributedGradientTape(
        gradtape, device_dense, device_sparse, compression,
        sparse_as_dense, op, gradient_predivide_factor, num_groups,
        process_set)


# ---------------------------------------------------------------------------
# DistributedOptimizer
# ---------------------------------------------------------------------------

def DistributedOptimizer(optimizer, name=None, device_dense="",
                         device_sparse="", compression=Compression.none,
                         sparse_as_dense=False, op=Average,
                         gradient_predivide_factor: float = 1.0,
                         backward_passes_per_step: int = 1,
                         average_aggregated_gradients: bool = True,
                         num_groups: int = 0, process_set=None):
    """Wrap an optimizer so that gradients are allreduced before they are
    applied (parity: hvd.DistributedOptimizer for TF): a keras optimizer
    through ``_keras.create_distributed_optimizer``, a
    ``tf.compat.v1.train.Optimizer`` through its ``compute_gradients``."""
    import keras as _keras_pkg

    if isinstance(optimizer, _keras_pkg.optimizers.Optimizer):
        from .._keras import create_distributed_optimizer

        return create_distributed_optimizer(
            optimizer, name=name, compression=compression, op=op,
            gradient_predivide_factor=gradient_predivide_factor,
            backward_passes_per_step=backward_passes_per_step,
            average_aggregated_gradients=average_aggregated_gradients,
            process_set=process_set)
    if isinstance(optimizer, tf.compat.v1.train.Optimizer):
        return _LegacyDistributedOptimizer(
            optimizer, compression=compression, op=op,
            process_set=process_set)
    raise ValueError(
        f"unsupported optimizer type {type(optimizer)!r}; expected a "
        "keras optimizer or tf.compat.v1.train.Optimizer")


class _LegacyDistributedOptimizer(tf.compat.v1.train.Optimizer):
    """The ``compute_gradients`` wrap of a v1 optimizer (parity: the v1
    optimizer wrap in horovod/tensorflow/__init__.py)."""

    def __init__(self, optimizer, compression=Compression.none,
                 op=Average, process_set=None):
        self._optimizer = optimizer
        self._compression = compression
        self._op = op
        self._process_set = process_set
        super().__init__(name="HvtpuDistributed", use_locking=False)

    def compute_gradients(self, *args, **kwargs):
        gradvars = self._optimizer.compute_gradients(*args, **kwargs)
        return [
            (allreduce(g, op=self._op, compression=self._compression,
                       process_set=self._process_set)
             if g is not None else None, v)
            for g, v in gradvars
        ]

    def apply_gradients(self, *args, **kwargs):
        return self._optimizer.apply_gradients(*args, **kwargs)

    def get_slot(self, *args, **kwargs):
        return self._optimizer.get_slot(*args, **kwargs)

    def get_slot_names(self, *args, **kwargs):
        return self._optimizer.get_slot_names(*args, **kwargs)

    def variables(self, *args, **kwargs):
        return self._optimizer.variables(*args, **kwargs)


__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size",
    "mpi_enabled", "mpi_built", "mpi_threads_supported", "gloo_enabled",
    "gloo_built", "nccl_built", "ddl_built", "ccl_built", "cuda_built",
    "rocm_built", "xla_built",
    "start_timeline", "stop_timeline",
    "ProcessSet", "add_process_set", "remove_process_set",
    "HorovodInternalError", "HostsUpdatedInterrupt",
    "Sum", "Average", "Adasum", "Min", "Max", "Product",
    "allreduce", "grouped_allreduce", "allgather", "grouped_allgather",
    "broadcast", "alltoall", "reducescatter", "grouped_reducescatter",
    "barrier", "join", "elastic", "SyncBatchNormalization",
    "broadcast_variables", "broadcast_global_variables",
    "BroadcastGlobalVariablesHook", "broadcast_object",
    "broadcast_object_fn", "allgather_object",
    "is_homogeneous", "size_op", "rank_op", "local_rank_op",
    "local_size_op",
    "Compression", "DistributedGradientTape", "DistributedOptimizer",
]


def __getattr__(name: str):
    # the root's live attribute (parity: hvd.global_process_set);
    # AttributeError keeps hasattr contracts
    if name == "global_process_set":
        return getattr(_hvt, "global_process_set")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
