"""Ring attention: exact attention over a sequence-sharded mesh axis.

Counterpart of ``horovod_tpu/parallel/ring.py``.  Each rank holds a
``T/S`` slice of the sequence; K/V blocks rotate around the axis by
``ppermute`` while each rank folds every block into an online-softmax
accumulator (float32 scores, a causal mask in global positions, a guard
for fully masked rows).  ``lax.scan`` becomes a Python loop; the
reference's "varying-axis zero" added to the carries (its ``:89-104``)
is JAX type plumbing, numerically zero, and is left out.  The rotation
after the last block, whose result the reference discards, is not made.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._collectives import axis_index, axis_size, ppermute

_NEG_INF = -1e30


def _block_scores(q, k, scale):
    # q: [B, H, Tq, D]  k: [B, H, Tk, D]  -> [B, H, Tq, Tk]
    return torch.einsum("bhqd,bhkd->bhqk", q, k) * scale


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: str,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    mesh=None,
) -> torch.Tensor:
    """Exact attention over a sequence sharded along ``axis_name``.

    Args:
      q, k, v: local shards ``[B, H, T_local, D]`` (sequence dim 2).
      axis_name: mesh axis the sequence is sharded over (ring).
      causal: apply a causal mask in *global* sequence positions.
      scale: score scale; default ``1/sqrt(D)``.

    Returns:
      Local attention output ``[B, H, T_local, D]``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    ring_size = axis_size(axis_name, mesh=mesh)
    my_idx = axis_index(axis_name, mesh=mesh)
    b, h, t_local, d = q.shape
    dev = q.device

    q32 = q.float()
    pos = torch.arange(t_local, device=dev)
    q_gpos = my_idx * t_local + pos           # [Tq] global positions
    perm = [(i, (i + 1) % ring_size) for i in range(ring_size)]

    k_cur, v_cur = k, v
    m = torch.full((b, h, t_local), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t_local, d), dtype=torch.float32, device=dev)
    for s in range(ring_size):
        # after s forward rotations we hold the block of ring position
        # (my_idx - s) mod S
        src = (my_idx - s) % ring_size
        scores = _block_scores(q32, k_cur.float(), scale)
        if causal:
            k_gpos = src * t_local + pos
            mask = q_gpos[:, None] >= k_gpos[None, :]      # [Tq, Tk]
            scores = torch.where(mask, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))      # [B, H, Tq]
        # fully masked rows: keep m finite so exp() stays 0, not nan
        m_safe = torch.clamp_min(m_new, _NEG_INF / 2)
        p = torch.exp(scores - m_safe[..., None])          # [B, H, Tq, Tk]
        correction = torch.exp(m - m_safe)                 # [B, H, Tq]
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if s < ring_size - 1:
            k_cur = ppermute(k_cur, axis_name, perm, mesh=mesh)
            v_cur = ppermute(v_cur, axis_name, perm, mesh=mesh)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)
