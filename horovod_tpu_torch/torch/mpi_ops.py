"""The torch surface's collectives (counterpart of
``horovod_tpu/torch/mpi_ops.py``, parity: horovod/torch/mpi_ops.py).

Each function takes the reference's positional signature, runs its
forward through ``comm/eager.py`` and maps the surface codec onto the
engine's as the reference does (``engine_compression``): ``fp16`` and
``bf16`` become the engine's cast codecs, which cast every floating
tensor, bfloat16 included; anything else, engine codecs too, becomes
``none``.  The engine's int8 wire is reached through
``horovod_tpu_torch.comm.eager.allreduce``.

A tensor that requires grad (with grad enabled) goes through a
``torch.autograd.Function`` whose backward is the reference's adjoint:
allreduce's is an allreduce with the same attributes, allgather's sums
and slices this rank's rows, broadcast's sums to the root (zeros
elsewhere), alltoall's replays the exchange with the received splits,
reducescatter's allgathers (divided by n for Average).  Every op takes a
process set.

The async ops (``*_async``) enqueue on the async controller
(``api/async_ops.py``) and return an integer handle, or a
``SparseAllreduceHandle``; ``synchronize`` returns the result, writes it
into the tensor for the in-place forms (``*_async_``), and ``poll`` says
whether it finished.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..api import async_ops as _async
from ..comm import eager
from ..comm.compression import Compression as EngineCompression
from ..comm.reduce_ops import Average, ReduceOp, Sum, normalize_op
from ..core import state as core_state
from ..core.process_set import participant_count, participant_rank
from .compression import Compression


def engine_compression(compression):
    """The engine codec of a torch-surface ``Compression`` (parity:
    ``horovod_tpu/torch/mpi_ops.py`` ``_engine_compression``)."""
    if compression is Compression.fp16:
        return EngineCompression.fp16
    if compression is Compression.bf16:
        return EngineCompression.bf16
    return EngineCompression.none


def _set_size(process_set) -> int:
    return participant_count(process_set)


def _check_grad_op(op, average):
    rop = normalize_op(op, average)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        raise NotImplementedError(
            f"gradient of a {rop.name} allreduce is not defined "
            "(reference registers gradients for sum/average/adasum)")


# -- allreduce -----------------------------------------------------------------

def _allreduce_impl(tensor, average, compression, op, prescale_factor,
                    postscale_factor, process_set, name=None):
    return eager.allreduce(
        tensor, op=op, average=average, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor,
        compression=engine_compression(compression),
        process_set=process_set, name=name)


class _AllreduceFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, average, name, compression, op,
                prescale_factor, postscale_factor, process_set):
        ctx.meta = (average, compression, op, prescale_factor,
                    postscale_factor, process_set)
        return _allreduce_impl(tensor, average, compression, op,
                               prescale_factor, postscale_factor,
                               process_set, name)

    @staticmethod
    def backward(ctx, grad):
        average, compression, op, pre, post, process_set = ctx.meta
        _check_grad_op(op, average)
        g = allreduce(grad, average, None, compression, op, pre, post,
                      process_set)
        return (g,) + (None,) * 7


def allreduce(tensor: torch.Tensor, average=None, name=None,
              compression=Compression.none, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set=None) -> torch.Tensor:
    """Averaged (by default) allreduce returning a new tensor;
    differentiable."""
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _AllreduceFunction.apply(
            tensor, average, name, compression, op, prescale_factor,
            postscale_factor, process_set)
    return _allreduce_impl(tensor, average, compression, op,
                           prescale_factor, postscale_factor, process_set,
                           name)


def allreduce_(tensor: torch.Tensor, average=None, name=None,
               compression=Compression.none, op=None,
               prescale_factor: float = 1.0, postscale_factor: float = 1.0,
               process_set=None) -> torch.Tensor:
    """In-place allreduce."""
    tensor.data.copy_(_allreduce_impl(
        tensor, average, compression, op, prescale_factor,
        postscale_factor, process_set, name))
    return tensor


# -- grouped allreduce ---------------------------------------------------------

def _grouped_impl(tensors, average, compression, op, prescale_factor,
                  postscale_factor, process_set):
    return eager.grouped_allreduce(
        tensors, op=op, average=average, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor,
        compression=engine_compression(compression),
        process_set=process_set)


class _GroupedAllreduceFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grad_mask, average, compression, op, prescale_factor,
                postscale_factor, process_set, *tensors):
        # forward sees detached tensors: which inputs need grad is
        # captured by the caller
        ctx.meta = (grad_mask, average, compression, op, prescale_factor,
                    postscale_factor, process_set)
        outs = _grouped_impl(list(tensors), average, compression, op,
                             prescale_factor, postscale_factor, process_set)
        non_diff = [o for o, m in zip(outs, grad_mask) if not m]
        if non_diff:
            ctx.mark_non_differentiable(*non_diff)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        grad_mask, average, compression, op, pre, post, process_set = \
            ctx.meta
        _check_grad_op(op, average)
        idx = [i for i, m in enumerate(grad_mask) if m]
        gs = grouped_allreduce([grads[i] for i in idx], average, None,
                               compression, op, process_set,
                               prescale_factor=pre, postscale_factor=post)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for j, i in enumerate(idx):
            out[i] = gs[j]
        return (None,) * 7 + tuple(out)


def grouped_allreduce(tensors, average=None, name=None,
                      compression=Compression.none, op=None,
                      process_set=None, *,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """Allreduce a list of tensors as one unit; differentiable.  The
    reference's positional order (``process_set`` sixth); the scales,
    which the reference lacks, are keyword-only, as
    ``grouped_allreduce_async`` has them."""
    tensors = list(tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        mask = tuple(t.requires_grad for t in tensors)
        return list(_GroupedAllreduceFunction.apply(
            mask, average, compression, op, prescale_factor,
            postscale_factor, process_set, *tensors))
    return _grouped_impl(tensors, average, compression, op, prescale_factor,
                         postscale_factor, process_set)


def grouped_allreduce_(tensors, average=None, name=None,
                       compression=Compression.none, op=None,
                       process_set=None, *,
                       prescale_factor: float = 1.0,
                       postscale_factor: float = 1.0) -> List[torch.Tensor]:
    """In-place grouped allreduce."""
    outs = _grouped_impl(list(tensors), average, compression, op,
                         prescale_factor, postscale_factor, process_set)
    for t, o in zip(tensors, outs):
        t.data.copy_(o)
    return tensors


# -- allgather -----------------------------------------------------------------

class _AllgatherFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name, process_set):
        ctx.meta = (tensor.shape[0], process_set)
        return eager.allgather(tensor, process_set=process_set, name=name)

    @staticmethod
    def backward(ctx, grad):
        rows, process_set = ctx.meta
        summed = allreduce(grad, op=Sum, process_set=process_set)
        sizes = allgather(torch.tensor([rows], device=grad.device),
                          process_set=process_set)
        offset = int(sizes[:participant_rank(process_set)].sum())
        return summed[offset:offset + rows], None, None


def allgather(tensor: torch.Tensor, name=None, process_set=None
              ) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0 (ragged dim 0
    allowed); differentiable."""
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _AllgatherFunction.apply(tensor, name, process_set)
    return eager.allgather(tensor, process_set=process_set, name=name)


# -- broadcast -----------------------------------------------------------------

class _BroadcastFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, root_rank, name, process_set):
        ctx.meta = (root_rank, process_set)
        return eager.broadcast(tensor, root_rank, process_set, name=name)

    @staticmethod
    def backward(ctx, grad):
        root_rank, process_set = ctx.meta
        summed = allreduce(grad, op=Sum, process_set=process_set)
        if core_state.rank() != root_rank:
            summed = torch.zeros_like(summed)
        return summed, None, None, None


def broadcast(tensor: torch.Tensor, root_rank: int = 0, name=None,
              process_set=None) -> torch.Tensor:
    """A new tensor holding ``root_rank``'s value; differentiable."""
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _BroadcastFunction.apply(tensor, root_rank, name,
                                        process_set)
    return eager.broadcast(tensor, root_rank, process_set, name=name)


def broadcast_(tensor: torch.Tensor, root_rank: int = 0, name=None,
               process_set=None) -> torch.Tensor:
    """In-place broadcast from ``root_rank``."""
    tensor.data.copy_(eager.broadcast(tensor, root_rank, process_set,
                                      name=name))
    return tensor


# -- alltoall ------------------------------------------------------------------

class _AlltoallFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, splits, name, process_set):
        single = splits is None
        if single:
            # the adjoint replays with the received counts, so an
            # equal-split call records them too
            p = _set_size(process_set)
            if tensor.shape[0] % p:
                raise ValueError(f"alltoall dim0 {tensor.shape[0]} not "
                                 f"divisible by size {p}")
            splits = [tensor.shape[0] // p] * p
        data, received = eager.alltoall(tensor, splits,
                                        process_set=process_set, name=name)
        ctx.meta = (received, process_set)
        return data if single else (data, received)

    @staticmethod
    def backward(ctx, grad, *_):
        received, process_set = ctx.meta
        g, _ = eager.alltoall(grad, received, process_set=process_set)
        return g, None, None, None


def alltoall(tensor: torch.Tensor, splits=None, name=None,
             process_set=None):
    """Send ``splits[i]`` rows of dim 0 to rank i (equal splits when
    None); returns the received tensor, and the received splits when
    ``splits`` is given; differentiable."""
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _AlltoallFunction.apply(tensor, splits, name, process_set)
    return eager.alltoall(tensor, splits, process_set=process_set,
                          name=name)


# -- reducescatter -------------------------------------------------------------

class _ReducescatterFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, op, name, process_set):
        ctx.meta = (op, process_set)
        return eager.reducescatter(tensor, op=op, process_set=process_set,
                                   name=name)

    @staticmethod
    def backward(ctx, grad):
        op, process_set = ctx.meta
        rop = normalize_op(op, None)
        if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise NotImplementedError(
                f"gradient of a {rop.name} reducescatter is not defined")
        g = allgather(grad, process_set=process_set)
        if rop == ReduceOp.AVERAGE:
            g = g / _set_size(process_set)
        return g, None, None, None


def reducescatter(tensor: torch.Tensor, op=None, name=None,
                  process_set=None) -> torch.Tensor:
    """Reduce over the ranks and return this rank's dim-0 shard;
    differentiable."""
    if torch.is_grad_enabled() and tensor.requires_grad:
        return _ReducescatterFunction.apply(tensor, op, name, process_set)
    return eager.reducescatter(tensor, op=op, process_set=process_set,
                               name=name)


def barrier(process_set=None) -> None:
    eager.barrier(process_set)


# -- grouped allgather and reducescatter --------------------------------------

def grouped_allgather(tensors: List[torch.Tensor], name=None,
                      process_set=None) -> List[torch.Tensor]:
    """Allgather a list of tensors (parity: hvd.grouped_allgather)."""
    return _async.grouped_allgather(tensors, process_set=process_set)


def grouped_reducescatter(tensors: List[torch.Tensor], op=None,
                          process_set=None) -> List[torch.Tensor]:
    """Reducescatter a list of tensors (parity:
    hvd.grouped_reducescatter)."""
    return _async.grouped_reducescatter(tensors, op=op,
                                        process_set=process_set)


# -- async ops and their handles ----------------------------------------------

# handle -> (mode, the caller's tensor): "new" reshapes the result like
# the tensor, "inplace" writes it into the tensor, "gather" keeps its
# shape; each casts to the tensor's dtype
_TORCH_HANDLES = {}


def _register(handles, mode: str, tensors):
    for h, t in zip(handles, tensors):
        _TORCH_HANDLES[h] = (mode, t)
    return handles


def allreduce_async(tensor: torch.Tensor, average=None, name=None, op=None,
                    compression=Compression.none,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set=None) -> int:
    handle = _async.allreduce_async(
        tensor, op=op, average=average, name=name,
        compression=engine_compression(compression),
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set)
    return _register([handle], "new", [tensor])[0]


def allreduce_async_(tensor: torch.Tensor, average=None, name=None, op=None,
                     compression=Compression.none,
                     prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     process_set=None) -> int:
    """Async in-place allreduce: the result lands in ``tensor`` at
    ``synchronize`` (parity: hvd.allreduce_async_); the controller's
    zero-copy route writes it there directly."""
    handle = _async.allreduce_async(
        tensor, op=op, average=average, name=name,
        compression=engine_compression(compression),
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set, out=tensor)
    return _register([handle], "inplace", [tensor])[0]


def grouped_allreduce_async(tensors: List[torch.Tensor], average=None,
                            names=None, op=None,
                            compression=Compression.none,
                            process_set=None, *,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> List[int]:
    """Async grouped allreduce: one handle a tensor; the group executes
    together, as one fused group while it fits the fusion threshold."""
    tensors = list(tensors)
    handles = _async.grouped_allreduce_async(
        tensors, op=op, average=average, names=names,
        compression=engine_compression(compression),
        process_set=process_set, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)
    return _register(handles, "new", tensors)


def grouped_allgather_async(tensors: List[torch.Tensor], names=None,
                            process_set=None) -> List[int]:
    tensors = list(tensors)
    handles = _async.grouped_allgather_async(tensors, names=names,
                                             process_set=process_set)
    return _register(handles, "gather", tensors)


def grouped_reducescatter_async(tensors: List[torch.Tensor], op=None,
                                names=None, process_set=None) -> List[int]:
    tensors = list(tensors)
    handles = _async.grouped_reducescatter_async(
        tensors, op=op, names=names, process_set=process_set)
    return _register(handles, "gather", tensors)


def allgather_async(tensor: torch.Tensor, name=None,
                    process_set=None) -> int:
    handle = _async.allgather_async(tensor, name=name,
                                    process_set=process_set)
    return _register([handle], "gather", [tensor])[0]


def broadcast_async(tensor: torch.Tensor, root_rank: int = 0, name=None,
                    process_set=None) -> int:
    handle = _async.broadcast_async(tensor, root_rank=root_rank, name=name,
                                    process_set=process_set)
    return _register([handle], "new", [tensor])[0]


def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0, name=None,
                     process_set=None) -> int:
    handle = _async.broadcast_async(tensor, root_rank=root_rank, name=name,
                                    process_set=process_set)
    return _register([handle], "inplace", [tensor])[0]


def alltoall_async(tensor: torch.Tensor, splits=None, name=None,
                   process_set=None) -> int:
    handle = _async.alltoall_async(tensor, splits, name=name,
                                   process_set=process_set)
    return _register([handle], "gather", [tensor])[0]


def reducescatter_async(tensor: torch.Tensor, op=None, name=None,
                        process_set=None) -> int:
    handle = _async.reducescatter_async(tensor, op=op, name=name,
                                        process_set=process_set)
    return _register([handle], "gather", [tensor])[0]


class SparseAllreduceHandle:
    """Handle of a sparse allreduce: two allgathers in flight, the
    indices and the values, reassembled at ``synchronize`` (parity:
    horovod/torch/mpi_ops.py sparse_allreduce_async's handle tuple)."""

    def __init__(self, h_indices: int, h_values: int, shape, op, like,
                 divisor: int):
        self.h_indices = h_indices
        self.h_values = h_values
        self.shape = tuple(shape)
        self.op = op
        self.like = like
        self.divisor = divisor


_sparse_noname = iter(range(1 << 62))


def sparse_allreduce_async(tensor: torch.Tensor, name=None, op=None,
                           process_set=None) -> SparseAllreduceHandle:
    """Allreduce a ``torch.sparse_coo`` tensor (embedding gradients):
    every rank's (indices, values) are allgathered; ``synchronize``
    reassembles and coalesces them (duplicate indices sum), dividing by
    the set's rank count for Average."""
    if not tensor.is_sparse:
        raise ValueError("sparse_allreduce_async expects a sparse tensor")
    rop = op if op is not None else Average
    if rop not in (Sum, Average):
        raise ValueError("sparse_allreduce_async supports op=Sum or Average")
    t = tensor.detach().coalesce()
    name = name or f"sparse_allreduce.noname.{next(_sparse_noname)}"
    # indices: (sparse_dim, nnz) -> rows = nnz for the ragged allgather
    idx_rows = t.indices().t().contiguous()
    h_i = _async.allgather_async(idx_rows, name=f"{name}.indices",
                                 process_set=process_set)
    h_v = _async.allgather_async(t.values().contiguous(),
                                 name=f"{name}.values",
                                 process_set=process_set)
    return SparseAllreduceHandle(h_i, h_v, t.shape, rop, t.values(),
                                 divisor=participant_count(process_set))


def _synchronize_sparse(handle: SparseAllreduceHandle) -> torch.Tensor:
    idx = _async.synchronize(handle.h_indices)
    vals = _async.synchronize(handle.h_values).to(handle.like.dtype)
    if handle.op == Average:
        vals = vals / float(handle.divisor)
    out = torch.sparse_coo_tensor(idx.t().to(torch.int64), vals,
                                  size=handle.shape)
    return out.coalesce()


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` is ``b``'s memory in ``b``'s layout (a result the
    controller already wrote into the in-place op's tensor)."""
    return (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
            and a.shape == b.shape and a.stride() == b.stride())


def synchronize(handle):
    """Wait for an async op and return its torch result (written into
    the tensor for the in-place forms)."""
    if isinstance(handle, SparseAllreduceHandle):
        return _synchronize_sparse(handle)
    mode, ref = _TORCH_HANDLES.pop(handle, ("new", None))
    out = _async.synchronize(handle)
    if isinstance(out, tuple):  # alltoall with splits
        data, received = out
        return data.to(ref.dtype) if ref is not None else data, received
    if out is None:
        return None
    if ref is not None and out.dtype != ref.dtype:
        out = out.to(ref.dtype)
    if mode == "inplace" and ref is not None:
        if not _same_storage(out, ref):
            ref.data.copy_(out.reshape(ref.shape))
        return ref
    if mode == "new" and ref is not None:
        return out.reshape(ref.shape)
    return out


def poll(handle) -> bool:
    if isinstance(handle, SparseAllreduceHandle):
        return _async.poll(handle.h_indices) and _async.poll(handle.h_values)
    return _async.poll(handle)


def join(device=None) -> int:
    return _async.join(device)
