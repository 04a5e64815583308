"""The reference's training steps: what a data-parallel step of the
configuration computes, written out in plain PyTorch.

Per step and rank: the loss (cross entropy of the float32 logits, the
mean over the rank's rows) and its gradients.  The wire: each gradient
times ``1 / gradient_predivide_factor`` in float32, cast to the wire
dtype (``compression`` ``fp16``: float16), summed over the ranks, the
sum rounded to the wire dtype, cast back to float32 and multiplied by
``predivide / ranks``.  Then SGD with momentum in float32 (the buffer
starts as the first gradient; ``buf = m * buf + g``; ``p -= lr * buf``).

Read after the steps: rank 0's loss of each step and its logits of the
first and the last; each leaf's momentum buffer after the first step
(its first gradient; and, where the program's is handed in, the norm of
their difference, which the steps that follow do not blur, as both sides
start from the same weights and batch) and after the last; and each
leaf's change.

``fault`` puts a known fault in the reference's own steps, for the
readings a check has to fail: ``half_batch`` (each rank's loss is the
mean over the first half of its rows), ``no_exchange`` (each rank keeps
its own gradient in place of the sum).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

WIRE = {"fp16": torch.float16, "bf16": torch.bfloat16}


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def bit_digest(t: torch.Tensor) -> int:
    """The sum of a float32 tensor's bit patterns: equal on two ranks
    that hold the same bits (as a comparison of norms need not be)."""
    return int(t.detach().contiguous().view(torch.int32).to(
        torch.int64).sum())


def run_steps(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
              batches: Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
              config: dict, precision: str = "bf16",
              fault: Optional[str] = None,
              against: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """``len(batches)`` steps from ``weights``; ``batches[s][r]`` is rank
    ``r``'s ``(x, y)`` at step ``s``.  Returns the readings the check
    compares: rank 0's loss of each step and its logits of the first
    and the last step, the norm of each leaf's momentum buffer after the
    first step (``grad_norms``) and after the last (``momentum_norms``),
    of each leaf's change over the steps, and, past one rank, each
    rank's bit digest of each leaf after the steps.  ``against``, the
    program's momentum buffers after the first step, adds the norm of
    each leaf's difference from the reference's (``grad_diff_norms``):
    the program's output, read only to judge it.  ``buffers``: the
    reference's own buffers after the first step (rank 0's)."""
    if fault not in (None, "half_batch", "no_exchange"):
        raise ValueError(f"fault {fault!r}")
    opt = config["optimizer"]
    lr, momentum = opt["lr"], opt["momentum"]
    wire = WIRE[config["compression"]]
    predivide = float(config["gradient_predivide_factor"])
    world = len(batches[0])
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n in names:
            params[n].copy_(weights[n])
    pre, post = _f32(1.0 / predivide), _f32(predivide / world)
    # one copy of the parameters a rank only where the ranks can differ
    ranks_apart = fault == "no_exchange"
    state = [{n: weights[n].clone() for n in names}
             for _ in range(world if ranks_apart else 1)]
    bufs: List[Dict[str, torch.Tensor]] = [{} for _ in state]
    losses, grad_norms = [], {}
    for s, step_batches in enumerate(batches):
        sums = None
        own = []
        for r, (x, y) in enumerate(step_batches):
            if fault == "half_batch":
                half = x.shape[0] // 2
                x, y = x[:half], y[:half]
            p_rank = state[r if ranks_apart else 0]
            with torch.no_grad():
                for n in names:
                    params[n].copy_(p_rank[n])
            z = model(x, precision)
            loss = F.cross_entropy(z, y)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            if r == 0:
                losses.append(float(loss.detach()))
                if s == 0:
                    logits = z.detach().float().flatten().tolist()
                if s == len(batches) - 1:
                    logits_last = z.detach().float().flatten().tolist()
            del z
            sent = [(g.float() * pre.to(g.device)).to(wire).float()
                    for g in grads]
            del grads
            if ranks_apart:
                own.append(sent)
            elif sums is None:
                sums = sent
            else:
                for a, b in zip(sums, sent):
                    a.add_(b)
        got = own if ranks_apart else [sums]
        for k, sent in enumerate(got):
            for i, n in enumerate(names):
                g = sent[i].to(wire).float() * post.to(sent[i].device)
                buf = bufs[k].get(n)
                if buf is None:
                    buf = bufs[k][n] = g.clone()
                else:
                    buf.mul_(momentum).add_(g)
                state[k][n].add_(buf, alpha=-lr)
        if s == 0:
            grad_norms = {n: leaf_norm(bufs[0][n]) for n in names}
            first = {n: b.clone() for n, b in bufs[0].items()}
            diff_norms = None
            if against is not None:
                diff_norms = {n: leaf_norm(against[n].to(first[n].device)
                                           - first[n]) for n in names}
        del sums, own, got
    change_norms = {n: leaf_norm(state[0][n] - weights[n]) for n in names}
    momentum_norms = {n: leaf_norm(bufs[0][n]) for n in names}
    digests = None
    if world > 1:
        digests = [[bit_digest(st[n]) for n in names]
                   for st in (state if ranks_apart else state * world)]
    return {"losses": losses, "grad_norms": grad_norms,
            "momentum_norms": momentum_norms,
            "grad_diff_norms": diff_norms,
            "change_norms": change_norms, "digests": digests,
            "logits": logits, "logits_last": logits_last,
            "buffers": first}
