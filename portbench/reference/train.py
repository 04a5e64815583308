"""The reference's training steps: what a data-parallel step of the
configuration computes, written out in plain PyTorch.

Per step and rank: the loss (the task's, ``tasks/``: the mean cross
entropy of the float32 logits over the rank's rows, or over every token
of them) and its gradients.  The wire: each gradient times ``1 /
gradient_predivide_factor`` in float32, cast to the wire dtype
(``compression`` ``fp16``: float16), summed over the ranks, the sum
rounded to the wire dtype, cast back to float32 and multiplied by
``predivide / ranks``.  Then the configuration's optimizer in float32:
SGD with momentum (the buffer starts as the first gradient; ``buf = m *
buf + g``; ``p -= lr * buf``), or AdamW as ``torch.optim.AdamW`` states
it (``p *= 1 - lr wd``; ``m = b1 m + (1 - b1) g``; ``v = b2 v + (1 - b2)
g^2``, both from 0; ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 -
b2^t) + eps)`` at step ``t``).

Read after the steps: rank 0's loss of each step and the task's reading
of its logits at the first and the last; each leaf's first gradient as
step 1's update got it (SGD's buffer after the first step, AdamW's
reduced gradient; and, where the program's is handed in, the norm of
their difference, which the steps that follow do not blur, as both sides
start from the same weights and batch) and its momentum after the last
(SGD's buffer, AdamW's ``m``); and each leaf's change.

``fault`` puts a known fault in the reference's own steps, for the
readings a check has to fail: ``half_batch`` (each rank's loss is the
mean over the first half of its rows), ``no_exchange`` (each rank keeps
its own gradient in place of the sum).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import tasks

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


def _adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
           v: torch.Tensor, step: int, opt: dict) -> None:
    """One AdamW update of ``p`` in place, ``m`` and ``v`` its moments."""
    lr, (b1, b2) = opt["lr"], opt["betas"]
    p.mul_(1.0 - lr * opt["weight_decay"])
    m.mul_(b1).add_(g, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    denom = (v.sqrt() / math.sqrt(1.0 - b2 ** step)).add_(opt["eps"])
    p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** step))


def run_steps(model: torch.nn.Module, weights: Dict[str, torch.Tensor],
              batches: Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]],
              config: dict, traffic: dict, precision: str = "bf16",
              fault: Optional[str] = None,
              against: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """``len(batches)`` steps from ``weights``; ``batches[s][r]`` is rank
    ``r``'s ``(x, y)`` at step ``s``.  Returns the readings the check
    compares: rank 0's loss of each step and its reading of the logits
    at the first and the last step, the norm of each leaf's first
    gradient (``grad_norms``) and of its momentum after the last step
    (``momentum_norms``), of each leaf's change over the steps, and,
    past one rank, each rank's bit digest of each leaf after the steps.
    ``against``, the program's first gradients, adds the norm of each
    leaf's difference from the reference's (``grad_diff_norms``): the
    program's output, read only to judge it.  ``buffers``: the
    reference's own first gradients (rank 0's)."""
    if fault not in (None, "half_batch", "no_exchange"):
        raise ValueError(f"fault {fault!r}")
    step_of = tasks.of(config).reference_step
    opt = config["optimizer"]
    kind = opt["kind"]
    if kind not in ("sgd", "adamw"):
        raise ValueError(f"optimizer {kind!r}")
    lr, momentum = opt["lr"], opt.get("momentum")
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
    # SGD's buffers, or AdamW's m beside its v
    bufs: List[Dict[str, torch.Tensor]] = [{} for _ in state]
    squares: List[Dict[str, torch.Tensor]] = [{} for _ in state]
    losses, grad_norms, first = [], {}, {}
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
            loss, grads, read = step_of(model, x, y,
                                        [params[n] for n in names],
                                        precision)
            if r == 0:
                losses.append(float(loss.detach()))
                if s == 0:
                    logits = read.tolist()
                if s == len(batches) - 1:
                    logits_last = read.tolist()
            del read
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
                if kind == "adamw":
                    if s == 0:
                        bufs[k][n] = torch.zeros_like(g)
                        squares[k][n] = torch.zeros_like(g)
                        if k == 0:
                            first[n] = g.clone()
                    _adamw(state[k][n], g, bufs[k][n], squares[k][n], s + 1,
                           opt)
                    continue
                buf = bufs[k].get(n)
                if buf is None:
                    buf = bufs[k][n] = g.clone()
                else:
                    buf.mul_(momentum).add_(g)
                state[k][n].add_(buf, alpha=-lr)
        if s == 0:
            if kind == "sgd":
                first = {n: b.clone() for n, b in bufs[0].items()}
            grad_norms = {n: leaf_norm(first[n]) for n in names}
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
