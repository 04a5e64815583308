"""The ``lax`` collectives the parallel layers call, over a mesh axis.

The reference's layers run inside ``jax.shard_map`` and call ``lax.psum``,
``all_gather``, ``psum_scatter``, ``all_to_all``, ``ppermute``,
``axis_index`` and ``axis_size``; JAX differentiates them.  Here each is a
``torch.autograd.Function`` over the group of one axis of a
``DeviceMesh`` (``core/topology.axis_view``), called eagerly by every rank
of the mesh in the same order.  The forward reuses ``comm/spmd.py``'s
collectives; the backward of each is its exact linear adjoint:

======================  ===================================
forward                 backward
======================  ===================================
``psum``                ``psum``
``all_gather``          ``psum_scatter`` (sum)
``psum_scatter``        ``all_gather``
``all_to_all(a, b)``    ``all_to_all(b, a)``
``ppermute(perm)``      ``ppermute(inverse of perm)``
======================  ===================================

So ``backward()`` on every rank computes, for rank r's leaves, the
derivative of the sum over ranks of each rank's objective with respect
to rank r's own copy (``models/transformer.py`` states how the
transformer turns that into the reference's gradients).  At axis size 1
each function is the identity and makes no call, as XLA's are.

A backward collective runs only where autograd reaches its node, and in
autograd's order.  Every rank must therefore build the same graph: a
choice that depends on the rank (the pipeline stage, the ring position,
a causal mask) is a ``torch.where`` on tensors, never a Python branch, as
the reference's ``jnp.where`` is.  ``torch.distributed.nn.functional`` is
not used: its ``all_reduce`` backward is another convention.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..comm import spmd
from ..comm.reduce_ops import ReduceOp
from ..core.topology import axis_view

Axes = Union[str, Sequence[str]]


def axis_size(axis_name: str, *, mesh=None) -> int:
    """The number of ranks along ``axis_name`` (``lax.axis_size``)."""
    return spmd.axis_size(axis_name, mesh=mesh)


def axis_index(axis_name: str, *, mesh=None) -> int:
    """This rank's index along ``axis_name`` (``lax.axis_index``)."""
    return spmd.rank(axis_name, mesh=mesh)


def _names(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# -- the forward collectives (plain functions; no autograd) ------------------

def _psum(x, axis, mesh):
    return spmd.allreduce(x, axis_name=axis, op=ReduceOp.SUM,
                          mesh=mesh)


def _all_gather(x, axis, mesh, dim: int, tiled: bool):
    parts = spmd.allgather(x.unsqueeze(0), axis_name=axis, mesh=mesh)
    if tiled:
        return torch.cat(parts.unbind(0), dim=dim)
    return parts.movedim(0, dim)


def _psum_scatter(x, axis, mesh, dim: int, tiled: bool):
    n = axis_size(axis, mesh=mesh)
    if not tiled and x.shape[dim] != n:
        raise ValueError(
            f"psum_scatter(tiled=False) needs dim {dim} of size {n}, got "
            f"{x.shape[dim]}")
    out = spmd.reducescatter(x.movedim(dim, 0), axis_name=axis,
                             op=ReduceOp.SUM, mesh=mesh)
    return out.movedim(0, dim) if tiled else out[0]


def _all_to_all(x, axis, mesh, split: int, concat: int, tiled: bool):
    n = axis_size(axis, mesh=mesh)
    if tiled:
        if x.shape[split] % n:
            raise ValueError(
                f"all_to_all: dim {split} of size {x.shape[split]} not "
                f"divisible by axis {axis!r} size {n}")
        chunks = x.unflatten(split, (n, -1)).movedim(split, 0)
    else:
        if x.shape[split] != n:
            raise ValueError(
                f"all_to_all requires the size of the mapped axis {axis!r} "
                f"to equal x.shape[split_axis], but they are {n} and "
                f"{x.shape[split]} respectively")
        chunks = x.movedim(split, 0)
    out = spmd.alltoall(chunks.contiguous(), axis_name=axis, mesh=mesh)
    if tiled:       # peer i's block at position i of dim ``concat``
        return out.movedim(0, concat).flatten(concat, concat + 1)
    return out.movedim(0, concat)


def _check_perm(perm, n: int):
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: perm {perm} sends or receives twice")
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: perm {perm} outside axis size {n}")


def _ppermute(x, axis, mesh, perm):
    """``out`` of the axis index that ``perm`` maps onto this rank, zeros
    where none does, by ``batch_isend_irecv`` with the axis's global
    ranks."""
    if mesh is None:
        from ..core.state import world_mesh

        mesh = world_mesh()
    view = axis_view(mesh, axis)
    me = axis_index(axis, mesh=mesh)
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if dst is not None and dst != me:
        ops.append(dist.P2POp(dist.isend, x, view.ranks[dst], view.group))
    if src is not None and src != me:
        ops.append(dist.P2POp(dist.irecv, out, view.ranks[src], view.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if src == me:
        out = x.clone()
    return out


# -- autograd: each forward with its adjoint ----------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return _psum(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, *ctx.args), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim, tiled):
        ctx.args = (axis, mesh, dim, tiled)
        return _all_gather(x, axis, mesh, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, *ctx.args), None, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dim, tiled):
        ctx.args = (axis, mesh, dim, tiled)
        return _psum_scatter(x, axis, mesh, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split, concat, tiled):
        ctx.args = (axis, mesh, split, concat, tiled)
        return _all_to_all(x, axis, mesh, split, concat, tiled)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, split, concat, tiled = ctx.args
        return (_all_to_all(g, axis, mesh, concat, split, tiled),
                None, None, None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, perm):
        ctx.args = (axis, mesh, tuple((d, s) for s, d in perm))
        return _ppermute(x, axis, mesh, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, *ctx.args), None, None, None


# -- the public functions ------------------------------------------------------

def psum(x: torch.Tensor, axes: Axes, *, mesh=None) -> torch.Tensor:
    """Sum over one axis or several (``lax.psum``); one axis after the
    other, axes of size 1 skipped."""
    for axis in _names(axes):
        if axis_size(axis, mesh=mesh) > 1:
            x = _Psum.apply(x, axis, mesh)
    return x


def pmean(x: torch.Tensor, axes: Axes, *, mesh=None) -> torch.Tensor:
    """``psum`` divided by the product of the axes' sizes (``lax.pmean``)."""
    n = 1
    for axis in _names(axes):
        n *= axis_size(axis, mesh=mesh)
    return psum(x, axes, mesh=mesh) / n


def all_gather(x: torch.Tensor, axis_name: str, *, dim: int = 0,
               tiled: bool = False, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` along the axis, in axis order: concatenated
    along ``dim`` when ``tiled``, else stacked on a new dim ``dim``."""
    if axis_size(axis_name, mesh=mesh) == 1:
        return x if tiled else x.unsqueeze(dim)
    return _AllGather.apply(x, axis_name, mesh, dim, tiled)


def psum_scatter(x: torch.Tensor, axis_name: str, *,
                 scatter_dimension: int = 0, tiled: bool = False,
                 mesh=None) -> torch.Tensor:
    """Sum over the axis, then this rank's block of ``scatter_dimension``
    (``tiled``), or its index of that dim, which must be the axis size."""
    if axis_size(axis_name, mesh=mesh) == 1:
        return x if tiled else x.squeeze(scatter_dimension)
    return _PsumScatter.apply(x, axis_name, mesh, scatter_dimension, tiled)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, *, tiled: bool = False,
               mesh=None) -> torch.Tensor:
    """Block j of ``split_axis`` goes to rank j; the blocks received are
    concatenated along ``concat_axis`` in peer order (``tiled``), or
    stacked there on a new dim that replaces ``split_axis`` (which must
    be the axis size)."""
    if axis_size(axis_name, mesh=mesh) == 1:
        if tiled:
            return x
        return x.squeeze(split_axis).unsqueeze(concat_axis)
    return _AllToAll.apply(x, axis_name, mesh, split_axis, concat_axis,
                           tiled)


def ppermute(x: torch.Tensor, axis_name: str, perm, *,
             mesh=None) -> torch.Tensor:
    """Send ``x`` from axis index ``s`` to ``d`` for each ``(s, d)`` of
    ``perm``; a rank that no pair sends to gets zeros."""
    n = axis_size(axis_name, mesh=mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    _check_perm(perm, n)
    if n == 1:
        return x if perm else torch.zeros_like(x)
    return _Ppermute.apply(x, axis_name, mesh, perm)
