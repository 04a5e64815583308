"""TF-tensor collectives over the port's torch engine (counterpart of
``horovod_tpu/tensorflow/mpi_ops.py``; parity: horovod/tensorflow/
mpi_ops.py and the custom ops of mpi_ops.cc).

The bridge is DLPack both ways.  ``_to_engine`` takes a tf tensor as a
torch tensor sharing tf's buffer (a ``tf.Variable`` is snapshot first:
DLPack refuses it, and an ``assign`` would change the buffer under the
engine) and moves it onto the port's device,
``core_state.global_state().device``: ``cuda:{local_rank}`` unless the
caller asked ``init()`` for the CPU.  The engine never writes into its
input (``comm/eager.py`` clones before it scales).  ``_from_engine``
hands the result back on the tf tensor's device, in its dtype; a result
on the card is synchronized first, because DLPack orders neither tf's
stream after torch's nor the other way round.  The device is always
named, never taken from ``torch.cuda.current_device()``: inside a
``tf.function`` the ops run under ``tf.py_function`` on a TF executor
thread, and CUDA keeps its current device per thread.

float64 is reduced in float64, as the port's torch surface does; the
reference narrows it to float32 on the wire unless JAX's x64 mode is on.
``tf.IndexedSlices`` take the allgather path.  Every op has the
reference's registered gradient (``tf.custom_gradient``).
"""

from __future__ import annotations

import collections
from typing import List

import numpy as np
import tensorflow as tf
import torch
from torch.utils import dlpack as _torch_dlpack

from ..comm import eager
from ..comm.compression import Compression as EngineCompression
from ..comm.reduce_ops import (
    Adasum,
    Average,
    Max,
    Min,
    Product,
    ReduceOp,
    Sum,
    normalize_op,
)
from ..core import state as core_state
from ..core.process_set import (
    participant_count as _participant_count,
    participant_rank as _participant_rank,
)
from ..torch import mpi_ops as _torch_ops
from .compression import BF16Compressor, Compression, FP16Compressor

#: Tensors the bridge handed to the engine, by the engine device's name
#: (``"cuda:0"``, ``"cpu"``).
bridged: "collections.Counter[str]" = collections.Counter()

#: The alignment tf's kernels check on a buffer (Eigen's widest vector);
#: an engine result that is a view at another offset is copied first.
TF_ALIGN = 64


def _engine_compression(compression):
    if compression is FP16Compressor or compression is Compression.fp16:
        return EngineCompression.fp16
    if compression is BF16Compressor or compression is Compression.bf16:
        return EngineCompression.bf16
    return EngineCompression.none


def predivide_scaling(op, gradient_predivide_factor: float, process_set):
    """The reference's gradient_predivide_factor: Average becomes Sum
    with the averaging split into prescale=1/factor and
    postscale=factor/N over the participating ranks.  Returns (op,
    prescale, postscale); shared by the tape and the keras optimizer."""
    if gradient_predivide_factor == 1.0 or op != Average:
        return op, 1.0, 1.0
    n = _participant_count(process_set)
    return (Sum, 1.0 / gradient_predivide_factor,
            gradient_predivide_factor / n)


def _unwrap(t):
    """A keras Variable's tf.Variable; anything else as it is."""
    if not isinstance(t, (tf.Tensor, tf.Variable)) \
            and isinstance(getattr(t, "value", None), tf.Variable):
        return t.value
    return t


def _to_engine(t) -> torch.Tensor:
    """tf (or array-like) -> a torch tensor on the port's device."""
    dev = core_state.require_init("the tensorflow frontend").device
    t = _unwrap(t)
    if isinstance(t, tf.Variable):
        t = tf.identity(t.value())
    if isinstance(t, tf.Tensor):
        if _tf_device(t).device_type == "GPU":
            # tf's stream may still be writing the buffer
            tf.test.experimental.sync_devices()
        x = torch.from_dlpack(tf.experimental.dlpack.to_dlpack(t))
    else:
        x = torch.as_tensor(np.asarray(t))
    x = x.to(dev)
    bridged[str(x.device)] += 1
    return x


def _tf_device(t) -> tf.DeviceSpec:
    return tf.DeviceSpec.from_string(getattr(_unwrap(t), "device", "") or "")


def _from_engine(x: torch.Tensor, like, dtype=None):
    """torch -> tf on ``like``'s device (a tf tensor, or a tf or keras
    variable), cast to ``dtype`` when given."""
    spec = _tf_device(like)
    if spec.device_type == "GPU":
        x = x.to(torch.device("cuda", spec.device_index or 0))
    else:
        x = x.cpu()
    if not x.is_contiguous() or x.data_ptr() % TF_ALIGN:
        x = x.clone(memory_format=torch.contiguous_format)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    out = tf.experimental.dlpack.from_dlpack(_torch_dlpack.to_dlpack(x))
    if dtype is not None and out.dtype != dtype:
        out = tf.cast(out, dtype)
    return out


def _graph_op(fn, inputs, out_dtype, out_shape=None):
    """Run ``fn`` (an engine call on torch tensors) on ``inputs``: eagerly
    on the bridged buffers, or inside a graph through
    ``tf.py_function``, whose declared ``Tout`` dtype is restored."""
    def run(*ts):
        return _from_engine(fn(*[_to_engine(t) for t in ts]), ts[0],
                            out_dtype)

    if tf.executing_eagerly():
        return run(*inputs)
    out = tf.py_function(run, inputs, Tout=out_dtype)
    if out_shape is not None:
        out.set_shape(out_shape)
    return out


def _check_grad_op(rop, allowed, what: str) -> None:
    if rop not in allowed:
        raise NotImplementedError(
            f"gradient of a {rop.name} {what} is not defined")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# AutoGraph must not convert these ops when a user's @tf.function body
# calls them: their bodies are host-side engine dispatches.
_no_autograph = tf.autograph.experimental.do_not_convert


@_no_autograph
def allreduce(tensor, average=None, op=None, name=None,
              compression=Compression.none,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None):
    """Averaged (by default) allreduce (parity: hvd.allreduce for TF).

    ``tf.IndexedSlices`` inputs return IndexedSlices assembled from an
    allgather of values and indices (the reference's sparse path).
    """
    if isinstance(tensor, tf.IndexedSlices):
        # sum = the concatenated contributions, scatter-added at apply;
        # average divides the values by the participating rank count;
        # pre/postscale distribute over the sum
        values = allgather(tensor.values, process_set=process_set)
        indices = allgather(tensor.indices, process_set=process_set)
        rop = normalize_op(op, average)
        scale = prescale_factor * postscale_factor
        if rop == ReduceOp.AVERAGE:
            scale /= _participant_count(process_set)
        elif rop != ReduceOp.SUM:
            raise NotImplementedError(
                f"IndexedSlices allreduce supports Sum/Average, got {rop}")
        if scale != 1.0:
            values = values * tf.cast(scale, values.dtype)
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)

    def impl(x):
        return eager.allreduce(
            x, op=op, average=average, name=name,
            compression=_engine_compression(compression),
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set)

    # the gradient of an allreduce is an allreduce of the gradient with
    # the same attributes (RegisterGradient('HorovodAllreduce'))
    @tf.custom_gradient
    def _op(x):
        y = _graph_op(impl, [x], x.dtype, x.shape)

        def grad(dy):
            _check_grad_op(normalize_op(op, average),
                           (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM),
                           "allreduce")
            return allreduce(
                dy, average=average, op=op, compression=compression,
                prescale_factor=prescale_factor,
                postscale_factor=postscale_factor, process_set=process_set)

        return y, grad

    return _op(tf.convert_to_tensor(tensor))


@_no_autograph
def grouped_allreduce(tensors: List, average=None, op=None, name=None,
                      compression=Compression.none, process_set=None):
    if not tf.executing_eagerly():
        return [allreduce(t, average=average, op=op,
                          compression=compression, process_set=process_set)
                for t in tensors]

    # the group's gradient is a grouped allreduce of the gradients with
    # the same attributes (RegisterGradient('HorovodGroupedAllreduce'))
    @tf.custom_gradient
    def _op(*xs):
        outs = eager.grouped_allreduce(
            [_to_engine(x) for x in xs], op=op, average=average,
            compression=_engine_compression(compression),
            process_set=process_set)
        ys = tuple(_from_engine(o, x, x.dtype) for x, o in zip(xs, outs))

        def grad(*dys):
            _check_grad_op(normalize_op(op, average),
                           (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM),
                           "grouped_allreduce")
            return tuple(grouped_allreduce(
                list(dys), average=average, op=op,
                compression=compression, process_set=process_set))

        return ys, grad

    return list(_op(*[tf.convert_to_tensor(t) for t in tensors]))


def _rows_shape(tensor):
    """dim 0 unknown, the rest as given (None for a scalar or unknown
    rank)."""
    if tensor.shape.rank is not None and tensor.shape.rank > 0:
        return tf.TensorShape([None]).concatenate(tensor.shape[1:])
    return None


@_no_autograph
def allgather(tensor, name=None, process_set=None):
    """Concatenate along dim 0 across ranks (ragged dim 0 supported)."""

    def impl(x):
        return eager.allgather(x, process_set=process_set, name=name)

    # sum the upstream gradient across ranks, then slice out the rows
    # this rank contributed (RegisterGradient('HorovodAllgather'))
    @tf.custom_gradient
    def _op(x):
        y = _graph_op(impl, [x], x.dtype, _rows_shape(x))

        def grad(dy):
            summed = allreduce(dy, op=Sum, process_set=process_set)
            my_rows = tf.shape(x)[0]
            sizes = allgather(tf.reshape(my_rows, [1]),
                              process_set=process_set)
            r = _participant_rank(process_set)
            offset = tf.reduce_sum(sizes[:r])
            return summed[offset:offset + my_rows]

        return y, grad

    return _op(tf.convert_to_tensor(tensor))


@_no_autograph
def grouped_allgather(tensors: List, name=None, process_set=None):
    """Allgather a list of tensors (parity: hvd.grouped_allgather for
    TF; ``name`` accepted for signature compatibility)."""
    if not tf.executing_eagerly():
        return [allgather(t, process_set=process_set) for t in tensors]

    # one grouped allreduce-sum of the upstream gradients, then each
    # member slices out this rank's rows; every member's row count
    # rides one size allgather ([1, N] a rank)
    @tf.custom_gradient
    def _op(*xs):
        ys = tuple(
            _from_engine(eager.allgather(_to_engine(x),
                                         process_set=process_set), x,
                         x.dtype)
            for x in xs)

        def grad(*dys):
            summed = grouped_allreduce(list(dys), op=Sum,
                                       process_set=process_set)
            r = _participant_rank(process_set)
            rows = tf.stack([tf.shape(x)[0] for x in xs])
            sizes = allgather(tf.reshape(rows, [1, -1]),
                              process_set=process_set)   # [p, N]
            offsets = tf.reduce_sum(sizes[:r, :], axis=0)
            return tuple(s[offsets[i]:offsets[i] + tf.shape(x)[0]]
                         for i, (x, s) in enumerate(zip(xs, summed)))

        return ys, grad

    return list(_op(*[tf.convert_to_tensor(t) for t in tensors]))


def _reducescatter_grad(rop, dys, process_set, gather):
    _check_grad_op(rop, (ReduceOp.SUM, ReduceOp.AVERAGE), "reducescatter")
    gs = gather(dys)
    if rop == ReduceOp.AVERAGE:
        n = _participant_count(process_set)
        gs = [g / tf.cast(n, g.dtype) for g in gs]
    return gs


@_no_autograph
def grouped_reducescatter(tensors: List, op=None, name=None,
                          process_set=None):
    """Reducescatter a list of tensors (parity:
    hvd.grouped_reducescatter for TF; ``name`` accepted for signature
    compatibility)."""
    if not tf.executing_eagerly():
        return [reducescatter(t, op=op, process_set=process_set)
                for t in tensors]

    # allgather each member's shard gradient; an Average forward also
    # averages the backward (RegisterGradient('HorovodGroupedReducescatter'))
    @tf.custom_gradient
    def _op(*xs):
        ys = tuple(
            _from_engine(eager.reducescatter(_to_engine(x), op=op,
                                             process_set=process_set), x,
                         x.dtype)
            for x in xs)

        def grad(*dys):
            return tuple(_reducescatter_grad(
                normalize_op(op, None), list(dys), process_set,
                lambda gs: grouped_allgather(gs, process_set=process_set)))

        return ys, grad

    return list(_op(*[tf.convert_to_tensor(t) for t in tensors]))


@_no_autograph
def broadcast(tensor, root_rank: int = 0, name=None, process_set=None):
    def impl(x):
        return eager.broadcast(x, root_rank=root_rank,
                               process_set=process_set, name=name)

    # gradients reduce to the root: every rank allreduce-sums, the root
    # keeps the sum, the others get zeros (RegisterGradient('HorovodBroadcast'))
    @tf.custom_gradient
    def _op(x):
        y = _graph_op(impl, [x], x.dtype, x.shape)

        def grad(dy):
            summed = allreduce(dy, op=Sum, process_set=process_set)
            if core_state.rank() == root_rank:
                return summed
            return tf.zeros_like(summed)

        return y, grad

    return _op(tf.convert_to_tensor(tensor))


@_no_autograph
def alltoall(tensor, splits=None, name=None, process_set=None):
    """Parity: hvd.alltoall: returns (output, received_splits) when
    splits is given, else just the output."""
    if splits is None:
        # the explicit-splits path with an equal send vector, so that the
        # backward replays with the negotiated received splits (ranks may
        # send different dim-0 row counts)
        tensor = tf.convert_to_tensor(tensor)
        p = _participant_count(process_set)
        n = tensor.shape[0]
        if n is not None and int(n) % p:
            raise ValueError(
                f"alltoall dim0 {int(n)} not divisible by size {p}")
        dyn = tf.shape(tensor)[0]
        if n is None:
            tf.debugging.assert_equal(
                dyn % p, 0,
                message=f"alltoall dim0 not divisible by size {p}")
        out, _received = alltoall(tensor, splits=tf.fill([p], dyn // p),
                                  name=name, process_set=process_set)
        return out

    def exchange(x, s):
        o, rs = eager.alltoall(_to_engine(x), s.numpy(),
                               process_set=process_set, name=name)
        return (_from_engine(o, x, x.dtype),
                tf.convert_to_tensor(rs.numpy().astype(np.int32)))

    def forward(x, s):
        if tf.executing_eagerly():
            return exchange(x, s)
        o, rs = tf.py_function(exchange, [x, s], Tout=[x.dtype, tf.int32])
        o.set_shape(_rows_shape(x))
        return o, rs

    # route each gradient chunk back to its sender by replaying the
    # exchange with the received splits; the splits get no gradient
    # (RegisterGradient('HorovodAlltoall'))
    @tf.custom_gradient
    def _op(x, s):
        out, rsplits = forward(x, s)

        def grad(dy, drsplits):
            g, _ = alltoall(dy, splits=rsplits, process_set=process_set)
            return g, None

        return (out, rsplits), grad

    s = splits if tf.is_tensor(splits) else tf.convert_to_tensor(
        np.asarray(splits).astype(np.int32))
    return _op(tf.convert_to_tensor(tensor), s)


@_no_autograph
def reducescatter(tensor, op=None, name=None, process_set=None):
    def impl(x):
        return eager.reducescatter(x, op=op, process_set=process_set,
                                   name=name)

    # the adjoint of reduce+scatter is gather: allgather the shard
    # gradients (RegisterGradient('HorovodReducescatter'))
    @tf.custom_gradient
    def _op(x):
        y = _graph_op(impl, [x], x.dtype, _rows_shape(x))

        def grad(dy):
            (g,) = _reducescatter_grad(
                normalize_op(op, None), [dy], process_set,
                lambda gs: [allgather(gs[0], process_set=process_set)])
            return g

        return y, grad

    return _op(tf.convert_to_tensor(tensor))


@_no_autograph
def barrier(process_set=None):
    eager.barrier(process_set)


@_no_autograph
def join(device=None) -> int:
    return _torch_ops.join(device)
