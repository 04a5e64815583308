"""Expert parallelism: Switch-style top-1 MoE with all-to-all dispatch.

Counterpart of ``horovod_tpu/parallel/moe.py``.  Routing is dense algebra
over one-hot ``[N, E, C]`` dispatch/combine tensors in float32 (top-1 by
the first maximum, capacity ``C = max(1, ceil(N * capacity_factor /
E))``, overflow tokens fall through the residual); the only
communication is two ``all_to_all``s over the ``ep`` axis; this rank's
``E/ep`` experts run in a loop over their queues.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F

from ._collectives import all_to_all, axis_size


def switch_route(
    x: torch.Tensor,
    gate_w: torch.Tensor,
    num_experts: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 routing: returns (dispatch [N,E,C] one-hot, combine [N,E,C]
    weights, aux load-balancing loss scalar)."""
    logits = torch.einsum("nd,de->ne", x.float(), gate_w)
    probs = torch.softmax(logits, dim=-1)                     # [N, E]
    expert_idx = torch.argmax(probs, dim=-1)                  # [N]
    gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, num_experts).float()
    # position of each token within its expert's queue
    pos = (torch.cumsum(onehot, dim=0) - onehot) * onehot     # [N, E]
    pos_in_expert = pos.sum(dim=-1).to(torch.int64)           # [N]
    keep = pos_in_expert < capacity
    # a position past the capacity has no one-hot row (jax.nn.one_hot)
    pos_onehot = F.one_hot(pos_in_expert.clamp_max(capacity),
                           capacity + 1)[:, :capacity].float()
    dispatch = ((onehot * keep[:, None].float())[..., None]
                * pos_onehot[:, None, :])                     # [N, E, C]
    combine = dispatch * gate[:, None, None]
    # Switch aux loss: E * sum_e fraction_tokens_e * mean_prob_e
    frac = onehot.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = num_experts * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def expert_parallel_moe(
    x: torch.Tensor,
    gate_w: torch.Tensor,
    expert_params: Any,
    expert_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    axis_name: str,
    *,
    num_experts: int,
    capacity_factor: float = 1.25,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-MoE layer over the ``ep`` mesh axis.

    Args:
      x: local tokens ``[N, D]`` (flatten batch x seq before calling).
      gate_w: router weights ``[D, E]`` (replicated).
      expert_params: a tuple of tensors stacked ``[E_local, ...]``: this
        rank's ``E_local = E/ep`` experts' params.
      expert_fn: ``(params_one_expert, tokens [C', D]) -> [C', D]``.
      axis_name: the ep mesh axis.
      num_experts: E, total experts across the ep group.

    Returns:
      (output ``[N, D]``, aux load-balancing loss scalar).
    """
    ep = axis_size(axis_name, mesh=mesh)
    if num_experts % ep != 0:
        raise ValueError(f"E={num_experts} not divisible by ep={ep}")
    e_local = num_experts // ep
    n, d = x.shape
    capacity = max(1, math.ceil(n * capacity_factor / num_experts))

    dispatch, combine, aux = switch_route(x, gate_w, num_experts, capacity)
    # each expert's token queue: [E, C, D]
    sent = torch.einsum("nec,nd->ecd", dispatch, x.float())
    # the ep-th of the E dim goes to each peer; received queues stack
    # along capacity: [E, C, D] -> [E_local, ep*C, D]
    recv = all_to_all(sent, axis_name, 0, 1, tiled=True, mesh=mesh)
    recv = recv.to(x.dtype)
    out = torch.stack([
        expert_fn(tuple(p[e] for p in expert_params), recv[e])
        for e in range(e_local)])                         # [E_local, ep*C, D]
    # return trip and weighted combine back into token order
    back = all_to_all(out.float(), axis_name, 1, 0, tiled=True,
                      mesh=mesh)                          # [E, C, D]
    y = torch.einsum("nec,ecd->nd", combine, back)
    return y.to(x.dtype), aux
