"""The engine-level async collectives and their handles.

Counterpart of the async half of the JAX package's top level
(``horovod_tpu/__init__.py:333-505``): each ``*_async`` op enqueues on
the process's ``EagerController`` (``horovod_tpu_torch.eager``) and
returns an integer handle of ``api/handles.py``; ``synchronize`` waits
for the op and returns its result, ``poll`` says whether it finished.
Ranks may enqueue in any order: the controllers agree on one fused
schedule.  Codecs are the engine's (``comm/compression.py``).

The package root re-exports the torch surface (``torch/mpi_ops.py``),
whose async ops call these with the reference's positional signatures
and the surface's codec mapping.  ``grouped_allreduce_async`` also takes
``prescale_factor`` / ``postscale_factor``, which the reference's
controller accepts (``grouped_enqueue(**kw)``) and its top level does
not pass on.
"""

from __future__ import annotations

from typing import List

from ..comm import eager as _eager
from ..comm.compression import Compression
from ..comm.reduce_ops import normalize_op
from ..core import state as _state
from . import handles as _handles


def _controller():
    from ..eager import get_controller

    return get_controller()


def _allocate(fut) -> int:
    return _handles.manager().allocate(fut)


def allreduce_async(tensor, *, op=None, average=None, name=None,
                    compression=Compression.none, process_set=None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, out=None) -> int:
    """``out``: a tensor the controller may write the result into (the
    torch surface's in-place ``allreduce_async_`` passes its own; the
    zero-copy route's unpack takes it, and ``synchronize`` returns it)."""
    _state.require_init("allreduce_async")
    fut = _controller().enqueue(
        "allreduce", tensor, name=name, op=normalize_op(op, average),
        compression=compression, process_set=process_set,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        out=out)
    return _allocate(fut)


def grouped_allreduce_async(tensors, *, op=None, average=None, names=None,
                            compression=Compression.none, process_set=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> List[int]:
    """Async grouped allreduce: the set executes only when every member
    is ready on every rank (parity: group_table.cc)."""
    _state.require_init("grouped_allreduce_async")
    futs = _controller().grouped_enqueue(
        "allreduce", list(tensors), names=names,
        op=normalize_op(op, average), compression=compression,
        process_set=process_set, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)
    return [_allocate(f) for f in futs]


def grouped_allgather(tensors, *, process_set=None):
    """Allgather a list of tensors, each in order (parity:
    hvd.grouped_allgather)."""
    _state.require_init("grouped_allgather")
    return [_eager.allgather(t, process_set=process_set) for t in tensors]


def grouped_allgather_async(tensors, *, names=None,
                            process_set=None) -> List[int]:
    """Async grouped allgather: executes only when every member is ready
    on every rank."""
    _state.require_init("grouped_allgather_async")
    futs = _controller().grouped_enqueue(
        "allgather", list(tensors), names=names, process_set=process_set)
    return [_allocate(f) for f in futs]


def grouped_reducescatter(tensors, *, op=None, process_set=None):
    """Reducescatter a list of tensors, each in order (parity:
    hvd.grouped_reducescatter)."""
    _state.require_init("grouped_reducescatter")
    return [_eager.reducescatter(t, op=op, process_set=process_set)
            for t in tensors]


def grouped_reducescatter_async(tensors, *, op=None, names=None,
                                process_set=None) -> List[int]:
    _state.require_init("grouped_reducescatter_async")
    futs = _controller().grouped_enqueue(
        "reducescatter", list(tensors), names=names,
        op=normalize_op(op, None), process_set=process_set)
    return [_allocate(f) for f in futs]


def allgather_async(tensor, *, name=None, process_set=None) -> int:
    _state.require_init("allgather_async")
    return _allocate(_controller().enqueue(
        "allgather", tensor, name=name, process_set=process_set))


def broadcast_async(tensor, root_rank: int = 0, *, name=None,
                    process_set=None) -> int:
    _state.require_init("broadcast_async")
    return _allocate(_controller().enqueue(
        "broadcast", tensor, name=name, root_rank=root_rank,
        process_set=process_set))


def alltoall_async(tensor, splits=None, *, name=None,
                   process_set=None) -> int:
    _state.require_init("alltoall_async")
    return _allocate(_controller().enqueue(
        "alltoall", tensor, name=name, splits=splits,
        process_set=process_set))


def reducescatter_async(tensor, *, op=None, name=None,
                        process_set=None) -> int:
    _state.require_init("reducescatter_async")
    return _allocate(_controller().enqueue(
        "reducescatter", tensor, name=name, op=normalize_op(op, None),
        process_set=process_set))


def synchronize(handle: int):
    """Block until an async op completes and return its result."""
    return _handles.manager().synchronize(handle)


def poll(handle: int) -> bool:
    return _handles.manager().poll(handle)


def join(device=None) -> int:
    """Signal this rank has no more work this epoch (parity: hvd.join /
    EnqueueJoin + JoinOp): while joined, this rank's controller keeps
    cycling and contributes zeros to the collectives the other ranks
    run.  Every rank calls it; it returns the rank that joined last, on
    every rank.  ``device`` is accepted for parity and unused."""
    st = _state.require_init("join")
    if st.size == 1:
        return 0
    return int(_controller().join().result())
