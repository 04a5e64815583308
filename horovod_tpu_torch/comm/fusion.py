"""Tensor fusion: deterministic size-bounded buckets.

Counterpart of ``horovod_tpu/comm/fusion.py`` ``BucketEntry`` /
``BucketPlan`` / ``plan_buckets`` (parity surface: the reference's
fusion step, ``Controller::FuseResponses``): tensors are ordered by
name, so every rank builds the same plan, and packed greedily up to a
byte threshold (``HVTPU_FUSION_THRESHOLD``); a tensor larger than the
threshold gets a bucket of its own.

:func:`fused_tree_allreduce` (``horovod_tpu/comm/fusion.py:101``) reduces
a dict or a list of tensors along a mesh axis: one ``spmd.allreduce`` a
bucket, with Adasum's dot products kept per tensor.  The names that
order the plan are the reference's tree paths (``['key']`` for a dict
entry, ``[i]`` for a list item), so both packages bucket alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

from .compression import NoneCompressor
from .reduce_ops import ReduceOp, normalize_op


@dataclasses.dataclass(frozen=True)
class BucketEntry:
    name: str
    index: int          # position in the original flat list
    shape: Tuple[int, ...]
    dtype: Any
    size: int           # element count
    nbytes: int


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Tuple[BucketEntry, ...], ...]

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


def plan_buckets(
    names: Sequence[str],
    tensors: Sequence[Any],
    threshold_bytes: int,
) -> BucketPlan:
    """Greedy size-bounded bucketing in deterministic (sorted-name) order.

    ``tensors`` need ``shape`` and a torch ``dtype``; their data is not
    read.
    """
    entries = []
    for i, (name, t) in enumerate(zip(names, tensors)):
        shape = tuple(t.shape)
        size = 1
        for d in shape:
            size *= d
        nbytes = size * t.dtype.itemsize
        entries.append(BucketEntry(name, i, shape, t.dtype, size, nbytes))
    entries.sort(key=lambda e: e.name)

    buckets: List[List[BucketEntry]] = []
    cur: List[BucketEntry] = []
    cur_bytes = 0
    for e in entries:
        if cur and cur_bytes + e.nbytes > threshold_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(e)
        cur_bytes += e.nbytes
        if e.nbytes > threshold_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return BucketPlan(tuple(tuple(b) for b in buckets))


def tree_leaves(tree) -> Tuple[List[str], List[Any], Callable]:
    """``(names, tensors, rebuild)`` of a dict or a list (or tuple) of
    tensors: the reference's path names (``jax.tree_util.keystr``), the
    tensors in the input's order, and the function that puts a list of
    results back into the input's structure."""
    if isinstance(tree, dict):
        keys = list(tree)
        return ([f"[{k!r}]" for k in keys], [tree[k] for k in keys],
                lambda outs: type(tree)(zip(keys, outs)))
    if isinstance(tree, (list, tuple)):
        return ([f"[{i}]" for i in range(len(tree))], list(tree),
                lambda outs: type(tree)(outs))
    raise TypeError(
        f"expected a dict or a list of tensors, got {type(tree).__name__}")


def fused_tree_allreduce(
    tree,
    *,
    axis_name: str,
    threshold_bytes: int,
    op: Optional[ReduceOp] = None,
    average: Optional[bool] = None,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    compression=NoneCompressor,
    groups: Optional[List[List[int]]] = None,
    plan: Optional[BucketPlan] = None,
    mesh=None,
):
    """Allreduce every tensor of a dict or list along ``axis_name`` in
    buckets: one pack, one ``spmd.allreduce`` and one unpack a bucket.
    Returns the input's structure."""
    from . import spmd
    from .packing import pack_flat, unpack_flat

    rop = normalize_op(op, average)
    names, leaves, rebuild = tree_leaves(tree)
    if plan is None:
        plan = plan_buckets(names, leaves, threshold_bytes)
    if rop not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        raise ValueError("fused_tree_allreduce supports Sum/Average/Adasum")

    out: List[Any] = [None] * len(leaves)
    for bucket in plan.buckets:
        flat, _ = pack_flat([leaves[e.index] for e in bucket])
        # a segment a tensor: Adasum's correction stays per tensor inside
        # the fused buffer, so the result does not depend on the plan
        segments, off = [], 0
        for e in bucket:
            segments.append((off, e.size))
            off += e.size
        red = spmd.allreduce(
            flat, axis_name=axis_name, op=rop,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, compression=compression,
            groups=groups,
            adasum_segments=segments if rop == ReduceOp.ADASUM else None,
            mesh=mesh)
        specs = [(e.shape, e.dtype, e.size) for e in bucket]
        for e, o in zip(bucket, unpack_flat(red, specs)):
            out[e.index] = o
    return rebuild(out)
