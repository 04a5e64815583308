"""The gradient reduction of a training step, outside the torch frontend.

Counterpart of ``horovod_tpu/api/optimizer.py``'s ``allreduce_gradients``
and ``ShardedDistributedOptimizer``.  The JAX functions take pytrees and
optax transformations; these take a dict or a list of tensors and
``torch.optim`` optimizers.  (The torch frontend's hook-driven
``DistributedOptimizer`` is ``horovod_tpu_torch/torch/optimizer.py``; the
reference's optax ``DistributedOptimizer``, and with it
``HVTPU_NONFINITE_ACTION``, has no counterpart here.)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..comm import eager as eager_comm
from ..comm import spmd
from ..comm.compression import NoneCompressor
from ..comm.fusion import fused_tree_allreduce, plan_buckets, tree_leaves
from ..comm.packing import pack_flat, unpack_flat
from ..comm.reduce_ops import ReduceOp, normalize_op
from ..core import state as core_state
from ..obs import metrics as obs_metrics


def allreduce_gradients(
    grads,
    *,
    axis_name: Optional[str] = None,
    op=None,
    average=None,
    compression=NoneCompressor,
    prescale_factor: float = 1.0,
    postscale_factor: float = 1.0,
    fusion_threshold_bytes: Optional[int] = None,
    process_set=None,
    mesh=None,
):
    """Fused allreduce of a dict or list of gradients; returns the same
    structure (the dict's keys, the list's order).

    ``axis_name`` set: :func:`~horovod_tpu_torch.comm.fusion.fused_tree_allreduce`
    along that axis of ``mesh`` (default: the world mesh), a process set
    scoping it through ``ProcessSet.device_groups()``.  ``axis_name=None``:
    the same deterministic bucket plan over the engine's eager
    ``allreduce``, one packed bucket an op named ``allreduce.bucket_{k}``
    (Adasum tensor by tensor, ``adasum.<name>``, so that its result does
    not depend on the threshold).

    The threshold is ``fusion_threshold_bytes``; else, on the eager path
    of a world of one under ``HVTPU_AUTOTUNE``, the autotuner's current
    candidate, and the step's bytes are recorded for it (past one rank
    the async controller owns the tuning: a tuner a rank would give the
    ranks different plans); else ``Config.fusion_threshold_bytes``; else
    64 MB."""
    rop = normalize_op(op, average)
    st = core_state.global_state()
    use_autotune = (
        fusion_threshold_bytes is None
        and st.initialized and st.autotuner is not None
        and axis_name is None and st.size == 1
    )
    if fusion_threshold_bytes is None:
        if use_autotune:
            fusion_threshold_bytes = st.autotuner.current[0]
        elif st.initialized and st.config:
            fusion_threshold_bytes = st.config.fusion_threshold_bytes
        else:
            fusion_threshold_bytes = 64 * 1024 * 1024

    if axis_name is not None:
        groups = None
        if process_set is not None:
            ps = process_set
            if isinstance(ps, int):
                ps = core_state.require_init(
                    "process_set collectives").process_set_table.get(ps)
            groups = ps.device_groups()
        return fused_tree_allreduce(
            grads, axis_name=axis_name,
            threshold_bytes=fusion_threshold_bytes, op=rop,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, compression=compression,
            groups=groups, mesh=mesh)

    names, leaves, rebuild = tree_leaves(grads)
    plan = plan_buckets(names, leaves, fusion_threshold_bytes)
    kwargs = dict(op=rop, prescale_factor=prescale_factor,
                  postscale_factor=postscale_factor,
                  compression=compression, process_set=process_set)
    out = [None] * len(leaves)
    total_bytes = 0
    for k, bucket in enumerate(plan.buckets):
        total_bytes += sum(e.nbytes for e in bucket)
        if rop == ReduceOp.ADASUM:
            for e in bucket:
                out[e.index] = eager_comm.allreduce(
                    leaves[e.index], name=f"adasum.{e.name}", **kwargs)
            continue
        flat, _ = pack_flat([leaves[e.index] for e in bucket])
        red = eager_comm.allreduce(flat, name=f"allreduce.bucket_{k}",
                                   **kwargs)
        specs = [(e.shape, e.dtype, e.size) for e in bucket]
        for e, o in zip(bucket, unpack_flat(red, specs)):
            out[e.index] = o
    if use_autotune:
        st.autotuner.record_step(total_bytes)
    obs_metrics.note_step()
    return rebuild(out)


class ShardedDistributedOptimizer(torch.optim.Optimizer):
    """ZeRO-1: reduce-scatter the gradients, step an inner optimizer on
    this rank's 1/N shard of the flattened parameters, all-gather the
    updated shard.

    ``optimizer_cls_or_factory`` is called once, as
    ``optimizer_cls_or_factory([shard], **optimizer_kwargs)``, over one
    flat tensor holding this rank's shard, so the inner optimizer's state
    is 1/N of the model's.  A step:

    1. packs the parameters' gradients into one flat buffer (the
       promoted dtype; a missing gradient counts as zeros), zero-pads it
       to a multiple of the axis size N and reduce-scatters it along
       ``axis_name`` under ``compression`` (Average, or Sum with
       ``average=False``);
    2. refreshes the shard from the parameters, hands it the reduced
       gradient shard and steps the inner optimizer;
    3. all-gathers the shards, drops the padding and writes the result
       back into the parameters.

    Against the reference's optax form,
    ``ShardedDistributedOptimizer(optax.sgd(lr, momentum=0.9),
    axis_name="world")`` with ``init`` and ``update`` inside
    ``shard_map`` and ``optax.apply_updates`` after, is here
    ``ShardedDistributedOptimizer(torch.optim.SGD, model.parameters(),
    axis_name="world", lr=lr, momentum=0.9)`` and ``step()``: the
    reference gathers the updates and adds them to the parameters, this
    gathers the updated parameters.

    The inner optimizer must be elementwise (SGD, momentum, Adam(W),
    RMSprop, ...): the shard is a flat slice that ignores tensor
    boundaries, so per-tensor transforms are not supported.  int8
    compression is refused, as the reference refuses it."""

    def __init__(self, optimizer_cls_or_factory, params, *, axis_name: str,
                 average: bool = True, compression=NoneCompressor,
                 mesh=None, **optimizer_kwargs):
        if eager_comm._is_int8(compression):
            # int8's per-block scales do not survive a summed wire, and
            # the reduce-scatter does not requantize per hop
            raise ValueError(
                "ShardedDistributedOptimizer does not support int8 "
                "compression; use fp16/bf16")
        super().__init__(params, {})
        self._params = [p for g in self.param_groups for p in g["params"]]
        if not self._params:
            raise ValueError("ShardedDistributedOptimizer got no parameters")
        self.axis_name, self.average = axis_name, average
        self.compression, self.mesh = compression, mesh
        self._n = spmd.axis_size(axis_name, mesh=mesh)
        self._index = spmd.rank(axis_name, mesh=mesh)
        flat = self._flat_params()
        self._chunk = -(-flat.numel() // self._n)
        self._pad = self._chunk * self._n - flat.numel()
        self.shard = self._my_shard(flat).clone()
        self.inner = optimizer_cls_or_factory([self.shard],
                                              **optimizer_kwargs)

    def _flat_params(self) -> torch.Tensor:
        return pack_flat([p.detach() for p in self._params])[0]

    def _padded(self, flat: torch.Tensor) -> torch.Tensor:
        if self._pad:
            flat = torch.cat([flat, flat.new_zeros(self._pad)])
        return flat

    def _my_shard(self, flat: torch.Tensor) -> torch.Tensor:
        start = self._index * self._chunk
        return self._padded(flat)[start:start + self._chunk]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        gflat, _ = pack_flat([p.grad if p.grad is not None
                              else torch.zeros_like(p)
                              for p in self._params])
        wire, ctx = self.compression.compress(
            self._padded(gflat).reshape(self._n, self._chunk))
        gshard = spmd.reducescatter(
            wire, axis_name=self.axis_name,
            op=ReduceOp.AVERAGE if self.average else ReduceOp.SUM,
            mesh=self.mesh).reshape(self._chunk)
        gshard = self.compression.decompress(gshard, ctx)
        self.shard.copy_(self._my_shard(self._flat_params()))
        self.shard.grad = gshard.to(self.shard.dtype)
        self.inner.step()
        full = spmd.allgather(self.shard, axis_name=self.axis_name,
                              mesh=self.mesh)
        specs = [(tuple(p.shape), p.dtype, p.numel()) for p in self._params]
        for p, new in zip(self._params,
                          unpack_flat(full[:full.numel() - self._pad],
                                      specs)):
            p.copy_(new)
        return loss

    def state_dict(self):
        """The inner optimizer's state: this rank's shard."""
        return self.inner.state_dict()

    def load_state_dict(self, state_dict) -> None:
        self.inner.load_state_dict(state_dict)
