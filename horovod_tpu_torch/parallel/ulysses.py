"""Ulysses (DeepSpeed-style) sequence parallelism via all-to-all.

Counterpart of ``horovod_tpu/parallel/ulysses.py``.  Activations arrive
sequence-sharded ``[B, T/S, H, D]``; one all-to-all reshards them to
head-sharded ``[B, T, H/S, D]``, every rank runs full-sequence attention
over its heads, and a second all-to-all reshards back.  The gathered
sequence blocks come in peer order, which is sequence-block order.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ._collectives import all_to_all, axis_size


def seq_to_heads(x: torch.Tensor, axis_name: str, *,
                 mesh=None) -> torch.Tensor:
    """[B, T/S, H, D] -> [B, T, H/S, D]."""
    # split the head axis (2) across the group, concat the sequence
    # axis (1) in peer (= sequence-block) order
    return all_to_all(x, axis_name, 2, 1, tiled=True, mesh=mesh)


def heads_to_seq(x: torch.Tensor, axis_name: str, *,
                 mesh=None) -> torch.Tensor:
    """[B, T, H/S, D] -> [B, T/S, H, D] (inverse of seq_to_heads)."""
    return all_to_all(x, axis_name, 1, 2, tiled=True, mesh=mesh)


def _default_attention(q, k, v, *, causal, scale):
    # q,k,v: [B, T, h, D] -> [B, T, h, D]; float32 softmax
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        t = q.shape[1]
        mask = torch.ones((t, t), dtype=torch.bool,
                          device=q.device).tril()
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: str,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    attn_fn: Optional[Callable] = None,
    mesh=None,
) -> torch.Tensor:
    """Sequence-parallel exact attention via two all-to-alls.

    Args:
      q, k, v: local shards ``[B, T_local, H, D]`` (sequence dim 1, heads
        dim 2).  ``H`` must be divisible by the axis size.
      axis_name: mesh axis carrying the sequence shards.
      attn_fn: optional full-sequence attention
        ``(q, k, v, causal=..., scale=...) -> out`` on ``[B, T, h, D]``;
        defaults to a float32-softmax implementation.

    Returns:
      Local output ``[B, T_local, H, D]``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if attn_fn is None:
        attn_fn = _default_attention
    s = axis_size(axis_name, mesh=mesh)
    if q.shape[2] % s != 0:
        raise ValueError(
            f"num heads {q.shape[2]} not divisible by axis {axis_name!r}"
            f" size {s}"
        )
    qh = seq_to_heads(q, axis_name, mesh=mesh)
    kh = seq_to_heads(k, axis_name, mesh=mesh)
    vh = seq_to_heads(v, axis_name, mesh=mesh)
    out = attn_fn(qh, kh, vh, causal=causal, scale=scale)
    return heads_to_seq(out, axis_name, mesh=mesh)
