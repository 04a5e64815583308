"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

Counterpart of ``horovod_tpu/parallel/pipeline.py``, the same SPMD
schedule: every stage runs ``stage_fn`` at every one of the ``M + S - 1``
ticks; stage 0 feeds microbatch ``t`` at tick ``t``; activations advance
one stage a tick by ``ppermute``; the last stage writes microbatch
``t - (S - 1)`` once the pipe is full; bubble executions are masked out
of the outputs and of ``aux``; a final ``psum`` over the axis replicates
the last stage's outputs to every stage.  The masks are ``torch.where``s
on the stage index, as the reference's ``jnp.where``s, so every stage
builds the same graph and runs the same backward ``ppermute``s (the
backward pipeline).  ``lax.scan`` becomes a Python loop over the ticks.
Bubble work is computed and discarded, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ._collectives import axis_index, axis_size, ppermute, psum


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    stage_params: Any,
    microbatches: torch.Tensor,
    axis_name: str,
    *,
    with_aux: bool = False,
    mesh=None,
):
    """Run ``stage_fn`` as a GPipe pipeline over ``axis_name``.

    Args:
      stage_fn: ``(params, x) -> y`` (or ``(params, x) -> (y, aux)``
        with ``with_aux=True``, ``aux`` a float32 scalar accumulated over
        the valid (non-bubble) stage executions and psum'd over the pp
        axis).  ``y`` has the shape and dtype of ``x``.
      stage_params: THIS stage's parameters.
      microbatches: ``[M, ...]`` input microbatches, the same on every
        stage (only stage 0 reads them).
      axis_name: the pp mesh axis.

    Returns:
      ``[M, ...]`` stage ``S-1``'s outputs, replicated to all stages
      (plus the accumulated aux scalar when ``with_aux``).
    """
    n_stages = axis_size(axis_name, mesh=mesh)
    stage = axis_index(axis_name, mesh=mesh)
    n_micro = microbatches.shape[0]
    ticks = n_micro + n_stages - 1
    dev = microbatches.device

    def flag(cond: bool) -> torch.Tensor:
        return torch.tensor(cond, device=dev)

    x_in = torch.zeros_like(microbatches[0])
    outs = list(torch.zeros_like(microbatches).unbind(0))
    aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
    fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    is_first = flag(stage == 0)
    for t in range(ticks):
        # stage 0 sources microbatch t (clamped; zeros past M)
        mb = microbatches[min(max(t, 0), n_micro - 1)]
        feed = mb if t < n_micro else torch.zeros_like(mb)
        x = torch.where(is_first, feed, x_in)
        res = stage_fn(stage_params, x)
        if with_aux:
            y, aux = res
        else:
            y, aux = res, torch.zeros((), dtype=torch.float32, device=dev)
        # stage s does useful work for microbatch t-s at ticks
        # s <= t < s + M; bubble executions contribute nothing
        useful = flag(stage <= t < stage + n_micro)
        aux_acc = aux_acc + torch.where(useful, aux, 0.0)
        # the last stage writes microbatch t-(S-1) once the pipe is full
        out_idx = min(max(t - (n_stages - 1), 0), n_micro - 1)
        valid = flag(stage == n_stages - 1 and t >= n_stages - 1)
        outs[out_idx] = torch.where(valid, y, outs[out_idx])
        if t < ticks - 1:   # the last tick's send feeds nothing
            x_in = ppermute(y, axis_name, fwd_perm, mesh=mesh)
    # replicate the last stage's collected outputs to every stage
    outs = torch.stack(outs)
    outs = psum(torch.where(flag(stage == n_stages - 1), outs,
                            torch.zeros_like(outs)), axis_name, mesh=mesh)
    if with_aux:
        return outs, psum(aux_acc, axis_name, mesh=mesh)
    return outs


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe bubble overhead for a given schedule size."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
