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

Past one member every op runs under the stall watchdog
(``comm/stall.py``), with the reference's descriptors: ``check`` records
the op before its collective, ``dispatch`` launches the collective (on
the watchdog's executor thread until its launches have proven
asynchronous), and ``finish`` polls its completion before anything on
the host reads the result (the sizes and splits an allgather or
alltoall exchanges first included).  Each op is also the
``collective.pre`` fault site for its input and the ``collective.post``
site for its result (``core/faults.py``); both are skipped inside
:func:`controller_execution`, whose ops fired ``collective.pre`` at
enqueue.

Each op takes the user's ``name``; without one it is named as the
reference names it (``allreduce.(2, 3).float32``, the shape a tuple and
the dtype numpy's spelling).  The name is in the op's stall descriptor,
so two ranks entering differently named ops are diagnosed as diverged.
Observability, as in the reference (``horovod_tpu/comm/eager.py``):
every op counts in ``hvtpu_<kind>_total`` and, past one member, in
``hvtpu_tensor_bytes_total`` and ``hvtpu_wire_bytes_total`` (the int8
wire with its scales).  ``allreduce`` also opens a ``NCCL_ALLREDUCE``
timeline span and an ``EXEC`` trace span (not on the controller's
threads, whose phase chain spans the op already), observes
``hvtpu_allreduce_latency_seconds`` and records its wall window for the
step profiler; these come before the world-of-one shortcut, as the
reference's do.  With a timeline set, an allreduce on the card waits
for its result before the span ends; without one, no hook synchronizes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import faults
from ..core import state as core_state
from ..core.process_set import ProcessSet, global_process_set
from ..obs import metrics as obs_metrics
from ..obs import stepprof
from ..obs import tracing
from ..obs.timeline import NCCL_ALLREDUCE
from . import stall
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


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's spelling of a dtype (``float32``), as the reference's
    names and descriptors carry it."""
    return str(dtype).rsplit(".", 1)[-1]


def default_name(kind: str, shape, dtype: torch.dtype) -> str:
    """The reference's name of an unnamed op:
    ``<kind>.<shape tuple>.<dtype>``."""
    return f"{kind}.{tuple(shape)}.{dtype_name(dtype)}"


def _record_collective(kind: str, x: torch.Tensor, ps: ProcessSet,
                       compression=None) -> torch.Tensor:
    """The ``collective.pre`` fault site: an armed clause can delay,
    error or kill this rank at the dispatch boundary, or ``corrupt`` its
    input.  Then the op's counters (:func:`count_collective`).  Returns
    the (possibly poisoned) tensor."""
    if faults.ACTIVE and not getattr(_exec, "active", False):
        x = faults.inject_tensor("collective.pre", x,
                                 pset=ps.process_set_id, detail=kind)
    count_collective(kind, x, ps, compression)
    return x


def count_collective(kind: str, x: torch.Tensor, ps: ProcessSet,
                     compression=None) -> None:
    """``hvtpu_<kind>_total`` always; past one member the payload bytes
    and the bytes on the wire after ``compression`` (the int8 codes with
    their float32 block scales)."""
    obs_metrics.op_counter(kind).inc()
    if ps.size <= 1:
        return
    nbytes = x.numel() * x.element_size()
    obs_metrics.TENSOR_BYTES.inc(nbytes)
    wire_nbytes = nbytes
    if compression is not None:
        wd = compression.wire_dtype(x.dtype)
        wire_nbytes = x.numel() * torch.empty((), dtype=wd).element_size()
        if wd == torch.int8 and x.is_floating_point():
            wire_nbytes += 4 * (-(-x.numel() // Int8Compressor.BLOCK))
    obs_metrics.WIRE_BYTES.inc(wire_nbytes)


@contextlib.contextmanager
def untraced():
    """Allreduces called inside open no trace span: their caller (the
    optimizer's bucket plan) spans the ops itself."""
    prev = getattr(_exec, "untraced", False)
    _exec.untraced = True
    try:
        yield
    finally:
        _exec.untraced = prev


class AllreduceSpan:
    """The reference's hooks around one allreduce
    (``horovod_tpu/comm/eager.py`` ``allreduce``): a ``NCCL_ALLREDUCE``
    timeline span, an ``EXEC`` trace span ending in a ``DONE`` instant
    with the wall window (not on the controller's threads, nor inside
    :func:`untraced`), the latency histogram and the step profiler's
    comm window.  Opened at dispatch; :meth:`close` ends it — after the
    result is complete on the card when a timeline is set, and only
    then."""

    __slots__ = ("name", "nbytes", "timeline", "traced", "t0", "wall0")

    def __init__(self, st, name: str, nbytes: int):
        self.name, self.nbytes = name, nbytes
        self.t0 = time.monotonic()
        # wall clock: the step profiler joins it against the device
        # trace's wall-aligned timestamps
        self.wall0 = time.time()
        self.timeline = st.timeline
        if self.timeline is not None:
            self.timeline.begin(name, NCCL_ALLREDUCE)
        self.traced = (tracing.ACTIVE and not stall.bypass_active()
                       and not getattr(_exec, "untraced", False))
        if self.traced:
            tracing.op_begin(name, "allreduce", phase=tracing.EXEC)

    def close(self, out=None, completed: bool = False) -> None:
        """End the span; ``completed``: the op succeeded with ``out``."""
        try:
            if completed:
                if self.timeline is not None:
                    _complete(out)
                obs_metrics.ALLREDUCE_LATENCY.observe(
                    time.monotonic() - self.t0)
        finally:
            wall1 = time.time()
            if stepprof.ACTIVE:
                stepprof.note_comm(self.name, self.wall0, wall1,
                                   nbytes=self.nbytes)
            if self.traced:
                tracing.op_done(self.name, bytes=self.nbytes,
                                wall_t0_us=int(self.wall0 * 1e6),
                                wall_t1_us=int(wall1 * 1e6))
            if self.timeline is not None:
                self.timeline.end(self.name)


def _complete(out) -> None:
    """Wait until a card result is complete (the timeline's span ends
    then); called only with a timeline set, after the watchdog's
    interruptible wait."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))
        done.synchronize()


def _post_collective(kind: str, out: torch.Tensor, ps: ProcessSet
                     ) -> torch.Tensor:
    """The ``collective.post`` fault site: a ``corrupt`` clause poisons
    this rank's result only."""
    if faults.ACTIVE and not getattr(_exec, "active", False):
        return faults.inject_tensor("collective.post", out,
                                    pset=ps.process_set_id, detail=kind)
    return out


def _guarded(st, ps: ProcessSet, sdesc, owner, launch):
    """Run ``launch()`` (which enqueues a collective and returns what
    ``stall.finish`` waits on) under the watchdog, or directly when it
    does not engage; returns that value once complete."""
    out = stall.dispatch(st, ps, launch, (), owner=owner, desc=sdesc)
    return stall.finish(st, ps, out, sdesc)


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
    codec of ``comm/compression.py``; ``name`` names the op in its stall
    descriptor, its timeline span and its trace span)."""
    rop = normalize_op(op, average)
    if rop == ReduceOp.ADASUM and _is_int8(compression):
        # size-independent, as in the reference: dot products over
        # per-rank block-scaled codes are meaningless
        raise ValueError(
            "int8 compression cannot ride Adasum (per-rank scales "
            "would corrupt the dot products); use fp16/bf16/none")
    ps = _resolve_process_set(process_set, "allreduce")
    st = core_state.global_state()
    x = _record_collective("allreduce", tensor.detach(), ps, compression)
    tname = name or default_name("allreduce", x.shape, x.dtype)
    span = AllreduceSpan(st, tname, x.numel() * x.element_size())
    out = None
    try:
        if ps.size == 1:
            factor = prescale_factor * postscale_factor
            out = (_scale(x, factor) if factor != 1.0
                   else x.clone(memory_format=torch.contiguous_format))
        else:
            # the descriptor carries the tensor NAME: two ranks entering
            # different same-shaped collectives are still diagnosed as
            # diverged
            sdesc = stall.check(
                st, ps, f"allreduce:{tname}:{tuple(x.shape)}:"
                f"{dtype_name(x.dtype)}:{rop.name}")
            x = x.clone(memory_format=torch.contiguous_format)
            if prescale_factor != 1.0:
                x = _scale_f32(x, prescale_factor)
            out = _guarded(st, ps, sdesc,
                           ("allreduce", rop, _is_int8(compression)),
                           lambda: _reduce(x, rop, compression, ps))
            if postscale_factor != 1.0:
                out = _scale_f32(out, postscale_factor)
        span.close(out, completed=True)
    except BaseException:
        span.close()
        raise
    return _post_collective("allreduce", out, ps)


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
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0; dim 0 may differ per
    rank (the sizes are exchanged first)."""
    ps = _resolve_process_set(process_set, "allgather")
    st = core_state.global_state()
    x = _record_collective("allgather", tensor.detach(), ps)
    if ps.size == 1:
        return x.clone(memory_format=torch.contiguous_format)
    # dim0 left out of the descriptor: per-rank sizes are legitimate
    # for allgather and exchanged right below
    tname = name or default_name("allgather", x.shape[1:], x.dtype)
    sdesc = stall.check(
        st, ps,
        f"allgather:{tname}:{tuple(x.shape[1:])}:{dtype_name(x.dtype)}")
    dim0 = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    # the size exchange completes under the watchdog before the host
    # reads it (.tolist() would park in a CUDA wait)
    sizes = _guarded(st, ps, None, "allgather.sizes",
                     lambda: _gather(dim0, ps)).reshape(-1).tolist()
    maxd = max(sizes)
    if x.shape[0] != maxd:
        x = torch.cat([x, x.new_zeros((maxd - x.shape[0],) + x.shape[1:])])
    gathered = _guarded(st, ps, sdesc, "allgather",
                        lambda: _gather(x, ps))     # (size, maxd, ...)
    if all(s == maxd for s in sizes):
        out = gathered.reshape((-1,) + tuple(x.shape[1:]))
    else:
        out = torch.cat([gathered[r, :s] for r, s in enumerate(sizes)])
    return _post_collective("allgather", out, ps)


def alltoall(tensor: torch.Tensor, splits=None, *,
             process_set: Optional[ProcessSet] = None,
             name: Optional[str] = None):
    """Send ``splits[i]`` rows of dim 0 to rank i (equal splits when
    ``splits`` is None).  Returns the received tensor, or ``(received,
    received_splits)`` when ``splits`` is given."""
    ps = _resolve_process_set(process_set, "alltoall")
    st = core_state.global_state()
    x = _record_collective("alltoall", tensor.detach(), ps)
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
    tname = name or default_name("alltoall", x.shape[1:], x.dtype)
    sdesc = stall.check(
        st, ps,
        f"alltoall:{tname}:{tuple(x.shape[1:])}:{dtype_name(x.dtype)}")
    # row r of the split matrix: what rank r sends to each rank
    mine = torch.tensor(splits, dtype=torch.int64, device=x.device)
    matrix = _guarded(st, ps, None, "alltoall.splits",
                      lambda: _gather(mine, ps)).tolist()
    me = ps.rank_in_set(st.rank)
    recv = [row[me] for row in matrix]
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    send = x.contiguous()

    def launch():
        dist.all_to_all_single(out, send, output_split_sizes=recv,
                               input_split_sizes=splits, group=_group(ps))
        return out

    out = _guarded(st, ps, sdesc, "alltoall", launch)
    return (out, torch.tensor(recv, dtype=torch.int32)) \
        if return_splits else out


def reducescatter(tensor: torch.Tensor, *, op: Optional[ReduceOp] = None,
                  process_set: Optional[ProcessSet] = None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce over the ranks and return this rank's dim-0 shard.  An
    uneven dim 0 gives the first ``dim0 % size`` ranks one extra row."""
    rop = normalize_op(op, None)
    ps = _resolve_process_set(process_set, "reducescatter")
    st = core_state.global_state()
    x = _record_collective("reducescatter", tensor.detach(), ps)
    p = ps.size
    if p == 1:
        return x.clone(memory_format=torch.contiguous_format)
    even = x.shape[0] % p == 0
    if even and rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports Sum and Average")
    tname = name or default_name("reducescatter", x.shape, x.dtype)
    sdesc = stall.check(
        st, ps, f"reducescatter:{tname}:{tuple(x.shape)}:"
        f"{dtype_name(x.dtype)}:{rop.name}")
    if even:
        out = x.new_empty((x.shape[0] // p,) + tuple(x.shape[1:]))
        send = x.contiguous()

        def launch():
            dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM,
                                       group=_group(ps))
            return out

        out = _guarded(st, ps, sdesc, "reducescatter", launch)
        if rop == ReduceOp.AVERAGE:
            average_(out, p)
        return _post_collective("reducescatter", out, ps)
    reduced = allreduce(x, op=rop, process_set=ps)
    r = ps.rank_in_set(st.rank)
    base, extra = divmod(x.shape[0], p)
    start = r * base + min(r, extra)
    return reduced[start:start + base + (1 if r < extra else 0)]


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """Return a new tensor holding ``root_rank``'s value (a global rank,
    a member of the set)."""
    ps = _resolve_process_set(process_set, "broadcast")
    st = core_state.global_state()
    x = _record_collective("broadcast", tensor.detach(), ps)
    out = x.clone(memory_format=torch.contiguous_format)
    if ps.size == 1:
        return out
    if ps.rank_in_set(root_rank) < 0:
        raise ValueError(
            f"root_rank {root_rank} is not a member of process set "
            f"{ps.process_set_id} (ranks {ps.ranks})")
    tname = name or default_name("broadcast", x.shape, x.dtype)
    sdesc = stall.check(
        st, ps, f"broadcast:{tname}:{tuple(x.shape)}:"
        f"{dtype_name(x.dtype)}:root{root_rank}")

    def launch():
        dist.broadcast(out, src=root_rank, group=_group(ps))
        return out

    return _post_collective(
        "broadcast", _guarded(st, ps, sdesc, "broadcast", launch), ps)


def broadcast_(tensor: torch.Tensor, root_rank: int = 0,
               process_set: Optional[ProcessSet] = None,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place broadcast from ``root_rank``."""
    with torch.no_grad():
        tensor.copy_(broadcast(tensor, root_rank, process_set, name=name))
    return tensor


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until every member reaches the barrier.  Under the watchdog
    the barrier is launched asynchronously and its ``Work`` polled (a
    NCCL barrier's own wait synchronizes the card)."""
    ps = _resolve_process_set(process_set, "barrier")
    st = core_state.global_state()
    obs_metrics.op_counter("barrier").inc()
    sdesc = stall.check(st, ps, "barrier")
    if not stall.engaged(st, ps):
        dist.barrier(group=_group(ps))
        return
    _guarded(st, ps, sdesc, "barrier",
             lambda: dist.barrier(group=_group(ps), async_op=True))
