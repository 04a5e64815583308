"""Quantized (int8-wire) allreduce (counterpart of
``horovod_tpu/comm/quantized.py``).

The two-phase allreduce the reference expresses in XLA, over a
``torch.distributed`` group:

1. **reduce-scatter phase**: the float32 payload is cut into one chunk
   per rank, each chunk is quantized in 512-element blocks (int8 codes,
   one float32 scale a block), ``all_to_all_single`` sends chunk r to
   rank r, and each rank dequantizes the contributions to its chunk and
   sums them in float32;
2. **allgather phase**: the reduced chunk is quantized again and
   ``all_gather_into_tensor`` gives every rank every chunk, which it
   dequantizes and trims; Average then multiplies by ``f32(1/n)``.

Plain torch ops, as the reference is plain XLA (no Pallas kernel), with
its own ``BLOCK = 512``.  The arithmetic is what XLA compiles the
reference's expressions to, so the result is bitwise the reference's:

* ``absmax / 127.0`` is ``absmax * f32(1/127)`` (XLA's simplifier turns
  a division by a constant into a multiply by its reciprocal; this is
  kernel A2's scale too), while ``blocks / safe`` stays a division;
* the phase-1 dequantize-and-sum is one fused loop, an FMA per rank:
  ``acc = fma(q_r, s_r, acc)`` in rank order, from ``acc = 0``;
* as on the TPU, float32 subnormals count as 0.

Stochastic rounding draws
``u`` from the counter-based generator of ``ops/quantize.py`` under a
key folded from the rank and the payload's bits (the reference's
``_dither_key``), computed on the device, so the same inputs give the
same result on the CPU and on the card.

``HVTPU_QUANTIZED_RING=1`` (read at every call, as the reference reads
it) sends a deterministic call over more than one rank through the
per-hop requantizing ring A6 instead: the group's
``ops.ring.ProcessRing`` (one a group, ``core.state.process_ring``)
with ``quantized=True`` and the caller's ``average``, its kernel on card
tensors and its plain version, the same ring over the group's
point-to-point ops, on CPU tensors.  It returns the input's shape and
dtype.  ``stochastic=True`` keeps the two-phase path (the ring rounds
deterministically, and the reference's unbiased-dither semantics win
over the opt-in), and so does a group of one rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.quantize import (
    INV_127,
    dither_bits,
    flush,
    fma_f32,
    round_codes,
    uniform,
)

BLOCK = 512
_KEY0 = 0x51DE


def _quantize(x: torch.Tensor, key: Optional[torch.Tensor] = None):
    """x: ``(..., k)`` float32 -> int8 codes ``(..., k/B, B)`` and
    float32 scales ``(..., k/B, 1)``, k zero-padded to a multiple of B.
    ``key`` switches to stochastic rounding, ``floor(x/s + u)``."""
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    blocks = flush(x.reshape(x.shape[:-1] + (-1, BLOCK)))
    scale = flush(blocks.abs().amax(dim=-1, keepdim=True) * INV_127)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    scaled = flush(blocks / safe)
    u = None
    if key is not None:
        u = uniform(key, scaled.numel()).reshape(scaled.shape)
    return round_codes(scaled, u), scale


def _dequantize_sum(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``sum_r q[r] * scale[r]`` as an FMA chain in rank order, each step
    rounded once."""
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for r in range(q.shape[0]):
        acc = flush(fma_f32(q[r], scale[r], acc))
    return acc


def _dither_key(flat: torch.Tensor, rank: int) -> torch.Tensor:
    """Key of stochastic rounding: folds the rank (dither independent
    across ranks) and the payload's float32 bits (new dither when the
    payload changes)."""
    payload = flat.view(torch.int32).sum(dtype=torch.int64)
    rank_key = dither_bits(torch.tensor(_KEY0, device=flat.device),
                           torch.tensor(rank, device=flat.device))
    return dither_bits(rank_key, payload)


def quantized_allreduce(tensor: torch.Tensor, *, group=None,
                        average: bool = False,
                        stochastic: bool = False) -> torch.Tensor:
    """int8-wire allreduce of a float tensor over ``group`` (default: the
    default group).  Returns float32 for a float32 input, else the
    input's floating dtype (the caller casts back); on the
    ``HVTPU_QUANTIZED_RING`` route the input's dtype."""
    n_ranks = dist.get_world_size(group)
    if (os.environ.get("HVTPU_QUANTIZED_RING", "0") == "1"
            and n_ranks > 1 and not stochastic):
        from ..core.state import process_ring

        return process_ring(group).allreduce(tensor, average=average,
                                             quantized=True)
    rank = dist.get_rank(group)
    orig_shape, orig_dtype = tensor.shape, tensor.dtype
    flat = tensor.reshape(-1).to(torch.float32)
    n = flat.numel()
    chunk = -(-n // n_ranks)
    pad = chunk * n_ranks - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    key = _dither_key(flat, rank) if stochastic else None

    # phase 1: reduce-scatter with an int8 wire
    q, scale = _quantize(flat.reshape(n_ranks, chunk), key=key)
    q_recv, s_recv = torch.empty_like(q), torch.empty_like(scale)
    dist.all_to_all_single(q_recv, q, group=group)
    dist.all_to_all_single(s_recv, scale, group=group)
    reduced = _dequantize_sum(q_recv, s_recv)

    # phase 2: allgather with an int8 wire
    key2 = None if key is None else dither_bits(key, torch.ones_like(key))
    q2, scale2 = _quantize(reduced.reshape(-1), key=key2)
    q_all = q2.new_empty((n_ranks * q2.shape[0], BLOCK))
    s_all = scale2.new_empty((n_ranks * scale2.shape[0], 1))
    dist.all_gather_into_tensor(q_all, q2, group=group)
    dist.all_gather_into_tensor(s_all, scale2, group=group)
    deq = (q_all.to(torch.float32) * s_all).reshape(n_ranks, -1)
    # trim each chunk's block padding before joining the chunks
    out = deq[:, :chunk].reshape(-1)[:n]
    if average:
        # XLA compiles ``out / n_ranks`` to a multiply by f32(1/n)
        out = flush(out * torch.tensor(1.0 / n_ranks, dtype=torch.float32))
    return out.reshape(orig_shape).to(
        orig_dtype if orig_dtype.is_floating_point else torch.float32)
