"""Torch DistributedOptimizer (parity: horovod/torch/optimizer.py
``_DistributedOptimizer`` / ``DistributedOptimizer``; counterpart of
``horovod_tpu/torch/optimizer.py``).

Wraps any ``torch.optim.Optimizer``.  Per-parameter post-accumulate-grad
hooks mark each gradient ready.  The gradients are grouped by the
deterministic bucket plan of ``comm/fusion.py`` (sorted names, fusion
threshold), and a bucket launches once it and every bucket before it in
plan order are ready, so every rank issues the same collectives in the
same order.  ``synchronize()`` (run by ``step()``) launches what is left,
waits, and writes the reduced gradients back in place.

One group's reduction follows the JAX engine's
(``eager/controller.py`` ``_execute_allreduce``):

* a group of several tensors takes the staged fused path: prescale (only
  when it is not 1), wire compression, ``pack_flat``, one
  ``all_reduce(SUM)`` launched with ``async_op=True``, then at finish
  ``unpack_flat``, decompression and postscale (only when it is not 1).
  The order holds in a world of one too.  Where every tensor of the
  group is a contiguous float32/bfloat16/float16 and the codec is
  ``none``, ``fp16`` or ``bf16``, each direction is one pass of kernel A1
  over the group (``scale_cast_pack``, ``unpack_cast_scale``; at scale 1
  the multiply is exact, so the pass is the cast and the pack alone),
  and the postscale writes straight into the gradients; any other group
  runs the reference's steps tensor by tensor, floats scaled through
  ``fused_scale_cast``;
* a group of one tensor goes through ``comm/eager.allreduce`` with the
  group's op, scales and codec, which in a world of one skips the wire
  compression and multiplies once by ``prescale * postscale``.

``op=Adasum`` reduces each gradient as its own Adasum
(``comm/adasum.py`` through ``comm/eager.allreduce``), tensor by tensor:
its coefficients are per tensor, as the reference's per-gradient
``allreduce_async_`` keeps them (its controller takes Adasum off the
fused path).

The wire codec is the engine's (``comm/compression.py``): the torch
surface's ``Compression.fp16`` / ``bf16`` map onto it and anything else
onto ``none`` (``mpi_ops.engine_compression``, as
``horovod_tpu/torch/mpi_ops.py`` maps them), so the
fp16 wire casts every floating gradient, bfloat16 ones included.

``gradient_predivide_factor=f`` (requires ``op=Average``) reduces with
``op=Sum``, prescale ``1/f`` and postscale ``f/n``, ``n`` the size of
the optimizer's process set (the world's by default).

Past one member the buckets run under the stall watchdog
(``comm/stall.py``), as the reference's gradients do on its controller:
``launch`` records the bucket's op (a descriptor of its index in the
plan, byte count and wire dtype, the same on every rank under the
deterministic plan) and launches its ``all_reduce`` through the
watchdog's ``dispatch``; ``finish`` polls the collective's completion
(its ``Work``, which on the card is its CUDA event) before it waits on
it.  A rank that stops stepping is then named by the others instead of
leaving them parked in the collective.

``op=Min``, ``Max`` and ``Product`` (which ``GroupReduction`` does not
serve) take the reference's own route: each gradient goes through the
async controller as ``allreduce_async_`` from its hook, and
``synchronize()`` waits for them; the bucket plan is not used.

Observability, as the reference's fused path emits it for the same
gradients (``horovod_tpu/eager/controller.py``): per gradient, under
``allreduce.<parameter name>``, a ``NEGOTIATE_ALLREDUCE`` timeline span
from its hook to its bucket's completion and the trace chain (the
op's span opens at the hook; ``FUSE`` at the bucket's pack, ``EXEC`` at
its collective, then a ``DONE`` instant with ``fused=n``); and per
bucket one ``NCCL_ALLREDUCE`` timeline span under the reference's fused
name ``fused.<first name>.<n>``, which also counts in
``hvtpu_allreduce_total`` and the latency histogram and is the step
profiler's comm window.  A bucket of one gradient is its gradient's
allreduce.  No step hook: the training loop notes steps with
``metrics.note_step()``.

Sparse gradients (``nn.Embedding(sparse=True)``) follow the reference
(``horovod_tpu/torch/optimizer.py:127-142``): with
``sparse_as_dense=True`` a sparse gradient becomes dense in its hook and
rides its bucket; otherwise it goes through ``sparse_allreduce_async``
(the async controller) and ``synchronize()`` replaces the gradient with
the coalesced result, which ``gradient_predivide_factor`` refuses.  The
dense gradients keep the bucket plan; they do not go through the async
controller, as the reference's do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..comm import eager, stall
from ..comm.fusion import plan_buckets
from ..comm.packing import pack_flat, unpack_flat
from ..comm.reduce_ops import ReduceOp, normalize_op
from ..core import state as core_state
from ..core.process_set import ProcessSet, global_process_set
from ..obs import tracing
from ..ops.scale_cast import (
    casts_to_wire,
    fused_scale_cast,
    scale_cast_pack,
    unpack_cast_scale,
)
from . import mpi_ops
from .compression import Compression
from .mpi_ops import engine_compression


@dataclasses.dataclass
class PendingGroup:
    """One group's allreduce in flight; a single-tensor group is
    reduced at launch and carries its result in ``outs``.  ``grouped``:
    the group takes the grouped A1 passes."""

    flat: Optional[torch.Tensor] = None
    specs: Optional[list] = None
    ctxs: Optional[list] = None
    work: object = None
    outs: Optional[List[torch.Tensor]] = None
    grouped: bool = False
    # the watchdog's descriptor of the op (None: not guarded)
    sdesc: Optional[str] = None
    # the gradients' trace names and the bucket's allreduce span
    names: Optional[List[str]] = None
    span: object = None


def apply_scale(t: torch.Tensor, factor: float,
                scale: Callable = fused_scale_cast) -> torch.Tensor:
    """Pre/postscale of one tensor on the fused path (the reference
    controller's ``_apply_scale``): floats through the one-pass scale
    kernel ``scale``, integers keep the truncating-scale semantics
    (``t * factor`` in their dtype)."""
    if t.is_floating_point():
        return scale(t.reshape(-1), factor).reshape(t.shape)
    return t * torch.tensor(factor, dtype=t.dtype, device=t.device)


@dataclasses.dataclass(frozen=True)
class GroupReduction:
    """The reduction of one group of gradients, Sum, Average or Adasum
    (tensor by tensor); the async controller reduces its fused groups
    through it too.

    ``compression`` is an engine codec; ``scale`` is the per-tensor
    pre/postscale of the fused path, ``pack`` and ``unpack`` its grouped
    passes; the optimizer uses the kernel wrappers.  The collective runs
    over the process set's group for the calling thread
    (``comm/eager._group``: the controller's group on its executor).
    """

    op: ReduceOp
    prescale: float
    postscale: float
    compression: type
    process_set: ProcessSet
    scale: Callable = fused_scale_cast
    pack: Callable = scale_cast_pack
    unpack: Callable = unpack_cast_scale

    def grouped(self, tensors: Sequence[torch.Tensor]) -> bool:
        """Whether a group of several tensors takes the grouped A1
        passes: every tensor contiguous, on one device, of a dtype the
        kernel reads, and cast by the codec to a wire it writes.  Decided
        before any launch."""
        return all(t.is_contiguous() and t.device == tensors[0].device
                   and casts_to_wire(self.compression, t.dtype)
                   for t in tensors)

    def launch(self, tensors: Sequence[torch.Tensor],
               index: Optional[int] = None,
               names: Optional[Sequence[str]] = None) -> PendingGroup:
        """Launch the group's reduction; ``index`` is its bucket's place
        in the plan (the watchdog's descriptor names it).  ``names``, the
        tensors' op names, turn on the reference's fused-path telemetry:
        the trace phases of each op and the group's allreduce span under
        ``fused.<first name>.<n>``."""
        if len(tensors) == 1 or self.op == ReduceOp.ADASUM:
            return PendingGroup(outs=self._per_tensor(tensors, names))
        if names is not None and tracing.ACTIVE:
            tracing.op_phase_many(names, tracing.FUSE)
        grouped = self.grouped(tensors)
        if grouped:
            flat, specs = self.pack(tensors, self.prescale, self.compression)
            # each piece back to its gradient's dtype (under the none
            # codec that is the piece's own)
            ctxs = [t.dtype for t in tensors]
        else:
            wires, ctxs = [], []
            for t in tensors:
                if self.prescale != 1.0:
                    t = apply_scale(t, self.prescale, self.scale)
                t, ctx = self.compression.compress(t)
                wires.append(t)
                ctxs.append(ctx)
            flat, specs = pack_flat(wires)
        ps = self.process_set
        st = core_state.global_state()
        eager.count_collective("allreduce", flat, ps)
        span = None
        if names is not None:
            if tracing.ACTIVE:
                tracing.op_phase_many(names, tracing.EXEC)
            # untraced: the ops' own trace spans cover the collective
            with eager.untraced():
                span = eager.AllreduceSpan(
                    st, f"fused.{names[0]}.{len(names)}",
                    flat.numel() * flat.element_size())
        sdesc = stall.check(
            st, ps, f"bucket:{'-' if index is None else index}:"
            f"{flat.numel() * flat.element_size()}:{flat.dtype}")
        work = stall.dispatch(
            st, ps, dist.all_reduce, (flat, dist.ReduceOp.SUM,
                                      eager._group(ps), True),
            owner="bucket", desc=sdesc)
        return PendingGroup(flat, specs, ctxs, work, grouped=grouped,
                            sdesc=sdesc,
                            names=None if names is None else list(names),
                            span=span)

    def _per_tensor(self, tensors, names) -> List[torch.Tensor]:
        """A group of one tensor, or Adasum's: each tensor its own
        allreduce, under its op's name (the op's trace span covers it)."""
        outs = []
        for i, t in enumerate(tensors):
            name = None if names is None else names[i]
            if name is not None and tracing.ACTIVE:
                tracing.op_phase(name, tracing.EXEC)
            with eager.untraced():
                out = eager.allreduce(
                    t, op=self.op, prescale_factor=self.prescale,
                    postscale_factor=self.postscale,
                    compression=self.compression,
                    process_set=self.process_set, name=name)
            outs.append(out)
            if name is not None and tracing.ACTIVE:
                wire = self.compression.wire_dtype(t.dtype)
                tracing.op_done(name, bytes=t.numel() * torch.empty(
                    (), dtype=wire).element_size())
        return outs

    def finish(self, pending: PendingGroup,
               outs: Optional[Sequence[torch.Tensor]] = None
               ) -> List[torch.Tensor]:
        """The group's reduced tensors, written into ``outs`` (the
        launched tensors' shapes and dtypes) when given."""
        if pending.outs is not None:
            return _into(outs, pending.outs)
        try:
            stall.finish(core_state.global_state(), self.process_set,
                         pending.work, pending.sdesc)
            pending.work.wait()
            flat = pending.flat
            if self.op == ReduceOp.AVERAGE:
                eager.average_(flat, self.process_set.size)
        except BaseException:
            if pending.span is not None:
                pending.span.close()
            raise
        if pending.span is not None:
            pending.span.close(flat, completed=True)
        if pending.names is not None and tracing.ACTIVE:
            size = flat.element_size()
            tracing.op_done_many(
                [(n, {"bytes": int(spec[2]) * size})
                 for n, spec in zip(pending.names, pending.specs)],
                fused=len(pending.names), zero_copy=False)
        if pending.grouped:
            return self.unpack(flat, pending.specs, pending.ctxs,
                               self.postscale, outs)
        results = []
        for piece, ctx in zip(unpack_flat(flat, pending.specs),
                              pending.ctxs):
            out = self.compression.decompress(piece, ctx)
            if self.postscale != 1.0:
                out = apply_scale(out, self.postscale, self.scale)
            results.append(out)
        return _into(outs, results)

    def reduce(self, tensors: Sequence[torch.Tensor],
               names: Optional[Sequence[str]] = None
               ) -> List[torch.Tensor]:
        return self.finish(self.launch(tensors, names=names))


def _into(outs, results: List[torch.Tensor]) -> List[torch.Tensor]:
    if outs is None:
        return results
    for o, r in zip(outs, results):
        o.copy_(r)
    return list(outs)


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1,
                 op=None, gradient_predivide_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None,
                 sparse_as_dense: bool = False):
        super(self.__class__, self).__init__(params)
        st = core_state.require_init("DistributedOptimizer")
        op = normalize_op(op)
        if gradient_predivide_factor != 1.0 and op != ReduceOp.AVERAGE:
            raise ValueError(
                "gradient_predivide_factor requires op=Average"
            )
        # Min/Max/Product: each gradient through the async controller
        self._per_op = op not in (ReduceOp.SUM, ReduceOp.AVERAGE,
                                  ReduceOp.ADASUM)
        self._compression = compression
        self._handles: dict = {}
        self._process_set = process_set
        process_set = process_set or global_process_set
        self._op = op
        self._predivide = gradient_predivide_factor
        self._sparse_as_dense = sparse_as_dense
        self.backward_passes_per_step = backward_passes_per_step

        wire = engine_compression(compression)
        if gradient_predivide_factor != 1.0:
            self.reduction = GroupReduction(
                ReduceOp.SUM, 1.0 / gradient_predivide_factor,
                gradient_predivide_factor / process_set.size,
                wire, process_set)
        else:
            self.reduction = GroupReduction(op, 1.0, 1.0, wire, process_set)

        named = list(named_parameters) if named_parameters is not None else []
        name_of = {id(p): n for n, p in named}
        self._params: List[torch.nn.Parameter] = []
        names = []
        for group in self.param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                names.append(name_of.get(
                    id(p), f"allreduce.noname.{len(self._params)}"))
                self._params.append(p)
        plan = plan_buckets(names, self._params,
                            st.config.fusion_threshold_bytes)
        # the parameters of each bucket, in plan order
        self.buckets = [[self._params[e.index] for e in b]
                        for b in plan.buckets]
        self._bucket_of = {p: k for k, b in enumerate(self.buckets)
                           for p in b}
        self._name_of = dict(zip(self._params, names))
        # sparse gradients in flight through sparse_allreduce_async
        self._sparse: dict = {}

        self._passes = {p: 0 for p in self._params}
        self._ready = set()
        self._ready_count = [0] * len(self.buckets)
        self._next_bucket = 0
        self._pending: List[tuple] = []
        self._synchronized = False
        self._should_synchronize = True
        for p in self._params:
            p.register_post_accumulate_grad_hook(self._on_grad_ready)

    # -- hook plumbing ----------------------------------------------------
    def _on_grad_ready(self, p):
        if p in self._ready:
            raise AssertionError(
                "Gradients were computed more than "
                "backward_passes_per_step times before call to step(). "
                "Increase backward_passes_per_step to accumulate more."
            )
        self._passes[p] += 1
        if self._passes[p] == self.backward_passes_per_step:
            self._begin_op(p)
            if self._per_op:
                self._handles[p] = self._allreduce_async(p)
                self._ready.add(p)
                return
            if p.grad.is_sparse:
                self._sparse_grad(p)
            self._mark_ready(p)
            self._launch_ready()

    def _op_name(self, p) -> str:
        return f"allreduce.{self._name_of[p]}"

    def _begin_op(self, p):
        """The gradient's op begins: its timeline span and its trace
        span open (a gradient through the controller gets both from the
        controller)."""
        if self._per_op or (p.grad is not None and p.grad.is_sparse
                            and not self._sparse_as_dense):
            return
        name = self._op_name(p)
        timeline = core_state.global_state().timeline
        if timeline is not None:
            timeline.begin(name, "NEGOTIATE_ALLREDUCE")
        if tracing.ACTIVE:
            tracing.op_begin(name, "allreduce")

    def _end_ops(self, params):
        """The bucket completed: its gradients' timeline spans end (their
        trace spans ended with the bucket's ``DONE`` instants)."""
        timeline = core_state.global_state().timeline
        if timeline is not None:
            for p in params:
                timeline.end(self._op_name(p))

    def _allreduce_async(self, p):
        """Min/Max/Product: the gradient through the async controller, in
        place (the reference's per-gradient ``allreduce_async_``)."""
        return mpi_ops.allreduce_async_(
            p.grad, name=self._op_name(p), op=self._op,
            compression=self._compression, process_set=self._process_set)

    def _sparse_grad(self, p):
        """A sparse gradient becomes dense (``sparse_as_dense``) and rides
        its bucket, or goes through ``sparse_allreduce_async``."""
        if self._sparse_as_dense:
            p.grad = p.grad.to_dense()
            return
        if self._predivide != 1.0:
            raise ValueError(
                "gradient_predivide_factor is not supported with sparse "
                "gradients (use sparse_as_dense)")
        self._sparse[p] = mpi_ops.sparse_allreduce_async(
            p.grad, name=f"allreduce.{self._name_of[p]}", op=self._op,
            process_set=self._process_set)

    def _mark_ready(self, p):
        self._ready.add(p)
        self._ready_count[self._bucket_of[p]] += 1

    def _launch_ready(self):
        """Launch, in plan order, every bucket whose gradients are all
        ready and whose predecessors have launched."""
        while (self._next_bucket < len(self.buckets)
               and self._ready_count[self._next_bucket]
               == len(self.buckets[self._next_bucket])):
            dense = [p for p in self.buckets[self._next_bucket]
                     if p not in self._sparse]
            if dense:
                self._pending.append(
                    (dense, self.reduction.launch(
                        [p.grad for p in dense], self._next_bucket,
                        [self._op_name(p) for p in dense])))
            self._next_bucket += 1

    # -- public contract --------------------------------------------------
    def set_backward_passes_per_step(self, passes: int):
        self.backward_passes_per_step = passes
        for p in self._passes:
            self._passes[p] = 0

    def synchronize(self):
        """Reduce every registered gradient; grads are updated in place
        (the grouped postscale writes into them directly).

        A parameter whose hook never fired (unused this step, or a
        partial accumulation) is reduced too, with zeros when it has no
        grad: every rank must issue the same collectives."""
        if self._per_op:
            self._synchronize_per_op()
            return
        for p in self._params:
            if p not in self._ready:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif p.grad.is_sparse:
                    self._sparse_grad(p)
                self._begin_op(p)
                self._mark_ready(p)
        self._launch_ready()
        with torch.no_grad():
            for dense, pending in self._pending:
                self.reduction.finish(pending, [p.grad for p in dense])
                self._end_ops(dense)
        for p, handle in self._sparse.items():
            # sparse results cannot land in place: the gradient is
            # replaced (parity: p.grad = synchronize(handle))
            p.grad = mpi_ops.synchronize(handle)
        self._sparse.clear()
        self._pending.clear()
        self._ready.clear()
        self._ready_count = [0] * len(self.buckets)
        self._next_bucket = 0
        for p in self._passes:
            self._passes[p] = 0
        self._synchronized = True

    def _synchronize_per_op(self):
        """Min/Max/Product: wait for every gradient's async allreduce
        (enqueued now, with zeros when it has no grad, for a hook that
        never fired), each written into its gradient in place."""
        for p in self._params:
            if p not in self._handles:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                self._handles[p] = self._allreduce_async(p)
        for p in self._params:
            mpi_ops.synchronize(self._handles[p])
        self._handles.clear()
        self._ready.clear()
        for p in self._passes:
            self._passes[p] = 0
        self._synchronized = True

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Run step() without synchronizing (caller already did; parity:
        optimizer.skip_synchronize() in the reference)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called without a preceding "
                    "backward; called synchronize() twice"
                )
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, set_to_none: bool = True):
        if self._ready or self._pending or self._sparse or self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(). "
                "This is prohibited as it can cause a race condition."
            )
        return super(self.__class__, self).zero_grad(set_to_none)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op=None,
                         gradient_predivide_factor: float = 1.0,
                         process_set: Optional[ProcessSet] = None,
                         sparse_as_dense: bool = False
                         ) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` for data-parallel training (parity:
    hvd.DistributedOptimizer for torch).

    Dynamically subclasses the optimizer's own class (same trick as
    horovod/torch/optimizer.py) so isinstance checks and hyperparameter
    access keep working.
    """
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op, gradient_predivide_factor,
               process_set, sparse_as_dense)
