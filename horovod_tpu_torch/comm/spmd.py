"""Collectives over a mesh axis.

Counterpart of ``horovod_tpu/comm/spmd.py``: the same functions, names
and keywords, over an axis of a ``torch.distributed`` ``DeviceMesh``.
The reference's functions run inside ``jax.shard_map`` and find their
axis there; these run eagerly, every rank of the mesh calling them in
the same order, and take the mesh as ``mesh=`` (default: the world
mesh, ``core/state.world_mesh()``).  The axis is the mesh's group
``mesh.get_group(axis_name)``; ``groups`` (the reference's
``axis_index_groups``, e.g. ``ProcessSet.device_groups()``) partitions
the axis indices, each part a group of its own made at the partition's
first use and cached on the mesh (``core/topology.axis_view``), and
every rank reduces over its part, so a non-member's result is what its
own part gives.

The arithmetic is the reference's as XLA compiles it:

* prescale and postscale multiply by the factor in the tensor's dtype;
* Average divides integers by floor and multiplies floats by the
  reciprocal of the count (``comm/eager.average_``); the count is the
  axis size, or the size of the first part of ``groups``;
* Sum and Average with an int8 codec on a floating tensor take the
  two-phase ``quantized_allreduce`` over the axis's group, and with
  ``HVTPU_QUANTIZED_RING=1`` at two or more ranks its ring, kernel A6;
  other codecs compress, sum and decompress, at any axis size;
* Adasum combines by recursive distance doubling (``comm/adasum.py``),
  per segment when given ``adasum_segments``;
* ``broadcast`` contributes zeros off the root and sums (a bool through
  int8); ``allreduce(op=Product)`` gathers and multiplies;
  ``reducescatter`` and ``alltoall`` are tiled along dim 0.

Every function returns a new tensor.  Like the reference's, they run
under no watchdog and count in no metric: they are the program's own
collectives, not the engine's ops.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.topology import GroupView, axis_view
from .adasum import adasum_reduce
from .compression import NoneCompressor
from .eager import _is_int8, _is_stochastic_int8, _scale, average_
from .reduce_ops import ReduceOp, normalize_op


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from ..core.state import world_mesh

    return world_mesh()


def axis_size(axis_name: str, *, mesh=None) -> int:
    """The number of ranks along ``axis_name``."""
    m = _mesh(mesh)
    return m.size(m.mesh_dim_names.index(axis_name))


def rank(axis_name: str, *, mesh=None) -> int:
    """This rank's index along ``axis_name``."""
    return _mesh(mesh).get_local_rank(axis_name)


def _view(axis_name: str, mesh, groups) -> GroupView:
    return axis_view(_mesh(mesh), axis_name, groups)


def _group_size(axis_name: str, mesh, groups) -> int:
    if groups is None:
        return axis_size(axis_name, mesh=mesh)
    return len(groups[0])


def _require_equal_groups(groups, op_name: str):
    """The gather- and scatter-shaped collectives need parts of one size;
    ``ProcessSet.device_groups()`` can give unequal ones (the members and
    the singletons of the rest), which only Sum, Average, Min and Max
    accept."""
    if groups is not None and len({len(g) for g in groups}) > 1:
        raise ValueError(
            f"{op_name} requires equal-size axis_index_groups; got sizes "
            f"{[len(g) for g in groups]}. Scope {op_name} to a process set "
            "whose non-members also form equal-size groups, or use the "
            "eager layer (per-set sub-mesh) instead."
        )


def _owned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy the collective may write into."""
    return t.clone(memory_format=torch.contiguous_format)


def _gather(x: torch.Tensor, view: GroupView) -> torch.Tensor:
    """``(n,) + x.shape``: every rank's ``x`` in the span, in order."""
    out = x.new_empty((view.size,) + tuple(x.shape))
    dist.all_gather_into_tensor(out, x.contiguous().unsqueeze(0),
                                group=view.group)
    return out


def allreduce(
    tensor: torch.Tensor,
    *,
    axis_name: str,
    op: Optional[ReduceOp] = None,
    average: Optional[bool] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    compression=NoneCompressor,
    groups: Optional[List[List[int]]] = None,
    adasum_segments=None,
    mesh=None,
) -> torch.Tensor:
    """Reduce ``tensor`` along ``axis_name``.  ``groups`` scopes the
    reduction to parts of the axis; ``adasum_segments`` — (offset, size)
    pairs — applies Adasum's dot products per tensor within a fused
    flat buffer."""
    rop = normalize_op(op, average)
    if prescale_factor != 1.0:
        tensor = _scale(tensor, prescale_factor)

    if rop == ReduceOp.ADASUM:
        if groups is not None:
            raise NotImplementedError(
                "Adasum over process-set groups is not supported in-jit; "
                "use the global set"
            )
        if _is_int8(compression):
            raise ValueError(
                "int8 compression cannot ride Adasum (per-rank scales "
                "would corrupt the dot products); use fp16/bf16/none"
            )
        wire, ctx = compression.compress(tensor)
        out = adasum_reduce(_owned(wire), _view(axis_name, mesh, None),
                            adasum_segments)
        out = compression.decompress(out, ctx)
    elif rop in (ReduceOp.SUM, ReduceOp.AVERAGE):
        if _is_int8(compression) and tensor.is_floating_point():
            # int8 codes cannot be summed (per-rank scales, overflow):
            # the two-phase quantized allreduce, or the ring A6
            if groups is not None:
                raise NotImplementedError(
                    "int8 compression over process-set groups is not "
                    "supported; use the global set"
                )
            from .quantized import quantized_allreduce

            out = quantized_allreduce(
                tensor, group=_view(axis_name, mesh, None).group,
                average=rop == ReduceOp.AVERAGE,
                stochastic=_is_stochastic_int8(compression),
            ).to(tensor.dtype)
        else:
            wire, ctx = compression.compress(tensor)
            wire = _owned(wire)
            dist.all_reduce(wire, op=dist.ReduceOp.SUM,
                            group=_view(axis_name, mesh, groups).group)
            out = compression.decompress(wire, ctx)
            if rop == ReduceOp.AVERAGE:
                out = average_(out, _group_size(axis_name, mesh, groups))
    elif rop in (ReduceOp.MIN, ReduceOp.MAX):
        out = _owned(tensor)
        dist.all_reduce(out, op=dist.ReduceOp.MIN if rop == ReduceOp.MIN
                        else dist.ReduceOp.MAX,
                        group=_view(axis_name, mesh, groups).group)
    elif rop == ReduceOp.PRODUCT:
        _require_equal_groups(groups, "allreduce(op=Product)")
        gathered = _gather(tensor, _view(axis_name, mesh, groups))
        out = torch.prod(gathered, dim=0, dtype=tensor.dtype)
    else:
        raise ValueError(f"unsupported op {rop}")

    if postscale_factor != 1.0:
        out = _scale(out, postscale_factor)
    return out


def grouped_allreduce(
    tensors: Sequence[torch.Tensor],
    *,
    axis_name: str,
    op: Optional[ReduceOp] = None,
    average: Optional[bool] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    compression=NoneCompressor,
    groups: Optional[List[List[int]]] = None,
    mesh=None,
) -> List[torch.Tensor]:
    """One fused collective for a list of tensors: Sum and Average pack
    them into one flat buffer (one wire cast, one allreduce) and unpack;
    Min, Max, Product and Adasum go tensor by tensor."""
    rop = normalize_op(op, average)
    tensors = list(tensors)
    kwargs = dict(axis_name=axis_name, op=rop,
                  prescale_factor=prescale_factor,
                  postscale_factor=postscale_factor,
                  compression=compression, groups=groups, mesh=mesh)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE) or not tensors:
        return [allreduce(t, **kwargs) for t in tensors]

    from .packing import pack_flat, unpack_flat

    flat, specs = pack_flat(tensors)
    return unpack_flat(allreduce(flat, **kwargs), specs)


def allgather(
    tensor: torch.Tensor,
    *,
    axis_name: str,
    groups: Optional[List[List[int]]] = None,
    mesh=None,
) -> torch.Tensor:
    """Every rank's tensor along the axis, concatenated along dim 0 (each
    rank's tensor has the same shape)."""
    _require_equal_groups(groups, "allgather")
    gathered = _gather(tensor, _view(axis_name, mesh, groups))
    return gathered.reshape((-1,) + tuple(tensor.shape[1:]))


def broadcast(
    tensor: torch.Tensor,
    *,
    root_rank: int,
    axis_name: str,
    groups: Optional[List[List[int]]] = None,
    mesh=None,
) -> torch.Tensor:
    """Every rank gets the value of the rank at axis index ``root_rank``:
    the others contribute zeros to a sum."""
    if rank(axis_name, mesh=mesh) == root_rank:
        contrib = _owned(tensor)
    else:
        contrib = torch.zeros_like(tensor,
                                   memory_format=torch.contiguous_format)
    is_bool = tensor.dtype == torch.bool
    if is_bool:
        contrib = contrib.to(torch.int8)
    dist.all_reduce(contrib, op=dist.ReduceOp.SUM,
                    group=_view(axis_name, mesh, groups).group)
    return contrib.to(torch.bool) if is_bool else contrib


def alltoall(
    tensor: torch.Tensor,
    *,
    axis_name: str,
    groups: Optional[List[List[int]]] = None,
    mesh=None,
) -> torch.Tensor:
    """Equal-split all-to-all along dim 0: rank i's block j goes to rank
    j's block i.  dim 0 must divide by the group size."""
    _require_equal_groups(groups, "alltoall")
    n = _group_size(axis_name, mesh, groups)
    if tensor.shape[0] % n:
        raise ValueError(
            f"alltoall dim0 {tensor.shape[0]} not divisible by group size {n}"
        )
    out = torch.empty_like(tensor, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, tensor.contiguous(),
                           group=_view(axis_name, mesh, groups).group)
    return out


def reducescatter(
    tensor: torch.Tensor,
    *,
    axis_name: str,
    op: Optional[ReduceOp] = None,
    groups: Optional[List[List[int]]] = None,
    mesh=None,
) -> torch.Tensor:
    """Reduce along the axis, then this rank's block of dim 0 (ZeRO's
    building block).  dim 0 must divide by the group size."""
    rop = normalize_op(op, None)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("reducescatter supports Sum and Average")
    _require_equal_groups(groups, "reducescatter")
    n = _group_size(axis_name, mesh, groups)
    if tensor.shape[0] % n:
        raise ValueError(
            f"reducescatter dim0 {tensor.shape[0]} not divisible by {n}"
        )
    out = tensor.new_empty((tensor.shape[0] // n,) + tuple(tensor.shape[1:]))
    dist.reduce_scatter_tensor(out, tensor.contiguous(),
                               op=dist.ReduceOp.SUM,
                               group=_view(axis_name, mesh, groups).group)
    if rop == ReduceOp.AVERAGE:
        out = average_(out, n)
    return out


def barrier(axis_name: str, *, mesh=None) -> torch.Tensor:
    """Synchronize the ranks along the axis; returns the int32 zero their
    sum gives, as the reference's does."""
    m = _mesh(mesh)
    device = (torch.device("cuda", torch.cuda.current_device())
              if m.device_type == "cuda" else torch.device("cpu"))
    z = torch.zeros((), dtype=torch.int32, device=device)
    dist.all_reduce(z, op=dist.ReduceOp.SUM,
                    group=axis_view(m, axis_name).group)
    return z
