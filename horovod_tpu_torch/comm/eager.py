"""Synchronous collectives on torch tensors over ``torch.distributed``.

Counterpart of the public eager ops of ``horovod_tpu/comm/eager.py``
(``allreduce``, ``grouped_allreduce``, ``allgather``, ``broadcast``,
``alltoall``, ``reducescatter``, ``barrier``) with the reduction
semantics of ``horovod_tpu/comm/spmd.py`` ``allreduce``:

* in a world of one, every op is the identity: ``allreduce`` multiplies
  once by ``prescale * postscale`` in the tensor's dtype (a copy when
  that is 1) and skips wire compression;
* otherwise the prescale multiplies in the tensor's dtype, then Sum and
  Average with an int8 codec on a floating tensor take the two-phase
  ``quantized_allreduce``, other codecs compress, sum and decompress;
  Average multiplies by the reciprocal of the rank count (floor division
  for integers); Adasum compresses, combines by recursive distance
  doubling (``comm/adasum.py``, a power-of-two set size) and
  decompresses; Min and Max reduce; Product gathers and multiplies; the
  postscale multiplies in the output's dtype.

Every op returns a new tensor.  Every op takes a process set (a
``ProcessSet``, its id, or None for the global set) and runs over the
set's group: Average divides by the set's size, a broadcast root is a
global rank that must be a member, and a rank outside the set raises the
reference's ``RuntimeError``.  Inside :func:`controller_execution` (the
async controller's executor) the ops run over each set's controller
group instead.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import state as core_state
from ..core.process_set import ProcessSet, global_process_set
from .adasum import adasum_reduce
from .compression import Int8Compressor, NoneCompressor
from .packing import pack_flat, unpack_flat
from .quantized import quantized_allreduce
from .reduce_ops import ReduceOp, normalize_op


_exec = threading.local()


@contextlib.contextmanager
def controller_execution():
    """The ops called inside run over each process set's controller
    group (``ProcessSet.controller_group``): the async controller's
    executor never shares a communicator with the caller's thread."""
    _exec.active = True
    try:
        yield
    finally:
        _exec.active = False


def _group(ps: ProcessSet):
    return ps.controller_group if getattr(_exec, "active", False) \
        else ps.group


def _resolve_process_set(process_set, name: str) -> ProcessSet:
    """The set of ``process_set`` (None: the global set; an int: its id);
    raises the reference's error when this rank is not a member
    (``horovod_tpu/comm/eager.py:167``)."""
    st = core_state.require_init(name)
    if process_set is None:
        return global_process_set
    ps = (st.process_set_table.get(process_set)
          if isinstance(process_set, int) else process_set)
    if ps.rank_in_set(st.rank) < 0:
        raise RuntimeError(
            "calling process is not a member of this process set")
    return ps


def _is_int8(compression) -> bool:
    """Subclass-aware: ``Int8StochasticCompressor`` counts too."""
    return (isinstance(compression, Int8Compressor)
            or (isinstance(compression, type)
                and issubclass(compression, Int8Compressor)))


def _is_stochastic_int8(compression) -> bool:
    return _is_int8(compression) and bool(
        getattr(compression, "STOCHASTIC", False))


def _scale(t: torch.Tensor, factor: float) -> torch.Tensor:
    # eager.py parity at world size 1: ``x * jnp.asarray(factor,
    # x.dtype)`` — the factor takes the tensor's dtype first (integers
    # truncate it).
    return t * torch.tensor(factor, dtype=t.dtype, device=t.device)


def _scale_f32(t: torch.Tensor, factor: float) -> torch.Tensor:
    # eager.py parity across ranks: the factor travels as a float32
    # scalar and is cast to the tensor's dtype (``pre.astype(x.dtype)``)
    f = torch.tensor(factor, dtype=torch.float32, device=t.device)
    return t * f.to(t.dtype)


def average_(t: torch.Tensor, n: int) -> torch.Tensor:
    """In-place Average over ``n`` participants, as XLA compiles
    spmd.py's ``out / n`` (read from its optimized HLO on the CPU):
    floats multiply by the reciprocal ``1/n`` rounded to their dtype, and
    bfloat16 computes ``f32(x) * f32(1/n)`` then rounds once; integers
    floor-divide.  For an ``n`` that is not a power of two this differs
    from ``x / n`` in the last bit of many elements."""
    if not t.is_floating_point():
        return t.floor_divide_(n)
    if t.dtype == torch.bfloat16:
        return t.copy_(t.float().mul_(_reciprocal(n, torch.float32)))
    return t.mul_(_reciprocal(n, t.dtype))


def _reciprocal(n: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(1.0 / n, dtype=torch.float64).to(dtype)


def _gather(x: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    """``(size,) + x.shape``: every rank's ``x``, in rank order."""
    x = x.contiguous().reshape((1,) + tuple(x.shape))
    out = x.new_empty((ps.size,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=_group(ps))
    return out


def _reduce(x: torch.Tensor, rop: ReduceOp, compression,
            ps: ProcessSet) -> torch.Tensor:
    """The reduction of ``spmd.allreduce`` over ``ps``; ``x`` is a
    contiguous tensor the caller owns."""
    if rop in (ReduceOp.SUM, ReduceOp.AVERAGE):
        if _is_int8(compression) and x.is_floating_point():
            # int8 codes cannot be summed (per-rank scales, overflow):
            # the two-phase quantized allreduce
            return quantized_allreduce(
                x, group=_group(ps), average=rop == ReduceOp.AVERAGE,
                stochastic=_is_stochastic_int8(compression)).to(x.dtype)
        wire, ctx = compression.compress(x)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=_group(ps))
        out = compression.decompress(wire, ctx)
        if rop == ReduceOp.AVERAGE:
            out = average_(out, ps.size)
        return out
    if rop == ReduceOp.ADASUM:
        wire, ctx = compression.compress(x)
        return compression.decompress(adasum_reduce(wire, ps), ctx)
    if rop in (ReduceOp.MIN, ReduceOp.MAX):
        dist.all_reduce(x, op=dist.ReduceOp.MIN if rop == ReduceOp.MIN
                        else dist.ReduceOp.MAX, group=_group(ps))
        return x
    if rop == ReduceOp.PRODUCT:
        return torch.prod(_gather(x, ps), dim=0, dtype=x.dtype)
    raise ValueError(f"unsupported op {rop}")


def allreduce(
    tensor: torch.Tensor,
    *,
    op: Optional[ReduceOp] = None,
    average: Optional[bool] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    compression=NoneCompressor,
    process_set: Optional[ProcessSet] = None,
    name: Optional[str] = None,
) -> torch.Tensor:
    """Reduce ``tensor`` over the ranks (``compression`` is an engine
    codec of ``comm/compression.py``; ``name`` is accepted for parity and
    unused until the port has a timeline)."""
    rop = normalize_op(op, average)
    if rop == ReduceOp.ADASUM and _is_int8(compression):
        # size-independent, as in the reference: dot products over
        # per-rank block-scaled codes are meaningless
        raise ValueError(
            "int8 compression cannot ride Adasum (per-rank scales "
            "would corrupt the dot products); use fp16/bf16/none")
    ps = _resolve_process_set(process_set, "allreduce")
    x = tensor.detach()
    if ps.size == 1:
        factor = prescale_factor * postscale_factor
        if factor != 1.0:
            return _scale(x, factor)
        return x.clone(memory_format=torch.contiguous_format)
    x = x.clone(memory_format=torch.contiguous_format)
    if prescale_factor != 1.0:
        x = _scale_f32(x, prescale_factor)
    out = _reduce(x, rop, compression, ps)
    if postscale_factor != 1.0:
        out = _scale_f32(out, postscale_factor)
    return out


def grouped_allreduce(
    tensors: Sequence[torch.Tensor],
    *,
    op: Optional[ReduceOp] = None,
    average: Optional[bool] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    compression=NoneCompressor,
    process_set: Optional[ProcessSet] = None,
) -> List[torch.Tensor]:
    """Reduce a list of tensors as one unit: Sum/Average pack into one
    flat buffer and one allreduce; Min/Max/Product go tensor by
    tensor."""
    rop = normalize_op(op, average)
    tensors = list(tensors)
    if not tensors:
        return []
    kwargs = dict(prescale_factor=prescale_factor,
                  postscale_factor=postscale_factor,
                  compression=compression, process_set=process_set)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        return [allreduce(t, op=rop, **kwargs) for t in tensors]
    flat, specs = pack_flat([t.detach() for t in tensors])
    return unpack_flat(allreduce(flat, op=rop, **kwargs), specs)


def allgather(tensor: torch.Tensor, *,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0; dim 0 may differ per
    rank (the sizes are exchanged first)."""
    ps = _resolve_process_set(process_set, "allgather")
    x = tensor.detach()
    if ps.size == 1:
        return x.clone(memory_format=torch.contiguous_format)
    dim0 = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = _gather(dim0, ps).reshape(-1).tolist()
    maxd = max(sizes)
    if x.shape[0] != maxd:
        x = torch.cat([x, x.new_zeros((maxd - x.shape[0],) + x.shape[1:])])
    gathered = _gather(x, ps)                       # (size, maxd, ...)
    if all(s == maxd for s in sizes):
        return gathered.reshape((-1,) + tuple(x.shape[1:]))
    return torch.cat([gathered[r, :s] for r, s in enumerate(sizes)])


def alltoall(tensor: torch.Tensor, splits=None, *,
             process_set: Optional[ProcessSet] = None):
    """Send ``splits[i]`` rows of dim 0 to rank i (equal splits when
    ``splits`` is None).  Returns the received tensor, or ``(received,
    received_splits)`` when ``splits`` is given."""
    ps = _resolve_process_set(process_set, "alltoall")
    x = tensor.detach()
    p = ps.size
    return_splits = splits is not None
    if splits is None:
        if x.shape[0] % p:
            raise ValueError(
                f"alltoall dim0 {x.shape[0]} not divisible by size {p}")
        splits = [x.shape[0] // p] * p
    splits = torch.as_tensor(splits)
    if splits.shape != (p,) or int(splits.sum()) != x.shape[0]:
        raise ValueError("splits must be a (size,) vector summing to dim0")
    splits = splits.tolist()
    if p == 1:
        out = x.clone(memory_format=torch.contiguous_format)
        return (out, torch.tensor(splits, dtype=torch.int32)) \
            if return_splits else out
    # row r of the split matrix: what rank r sends to each rank
    mine = torch.tensor(splits, dtype=torch.int64, device=x.device)
    matrix = _gather(mine, ps).tolist()
    me = ps.rank_in_set(core_state.global_state().rank)
    recv = [row[me] for row in matrix]
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                           input_split_sizes=splits, group=_group(ps))
    return (out, torch.tensor(recv, dtype=torch.int32)) \
        if return_splits else out


def reducescatter(tensor: torch.Tensor, *, op: Optional[ReduceOp] = None,
                  process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Reduce over the ranks and return this rank's dim-0 shard.  An
    uneven dim 0 gives the first ``dim0 % size`` ranks one extra row."""
    rop = normalize_op(op, None)
    ps = _resolve_process_set(process_set, "reducescatter")
    x = tensor.detach()
    p = ps.size
    if p == 1:
        return x.clone(memory_format=torch.contiguous_format)
    if x.shape[0] % p == 0:
        if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError("reducescatter supports Sum and Average")
        out = x.new_empty((x.shape[0] // p,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(),
                                   op=dist.ReduceOp.SUM, group=_group(ps))
        if rop == ReduceOp.AVERAGE:
            average_(out, p)
        return out
    reduced = allreduce(x, op=rop, process_set=ps)
    r = ps.rank_in_set(core_state.global_state().rank)
    base, extra = divmod(x.shape[0], p)
    start = r * base + min(r, extra)
    return reduced[start:start + base + (1 if r < extra else 0)]


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Return a new tensor holding ``root_rank``'s value (a global rank,
    a member of the set)."""
    ps = _resolve_process_set(process_set, "broadcast")
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    if ps.size == 1:
        return out
    if ps.rank_in_set(root_rank) < 0:
        raise ValueError(
            f"root_rank {root_rank} is not a member of process set "
            f"{ps.process_set_id} (ranks {ps.ranks})")
    dist.broadcast(out, src=root_rank, group=_group(ps))
    return out


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """In-place broadcast from ``root_rank``."""
    with torch.no_grad():
        tensor.copy_(broadcast(tensor, root_rank, process_set))
    return tensor


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    ps = _resolve_process_set(process_set, "barrier")
    dist.barrier(group=_group(ps))
