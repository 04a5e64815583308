"""Plain PyTorch pieces of the frozen reference: flax-style ``SAME``
padding, the batch norm in training mode, and the precision a layer
computes in.

The reference imports nothing of the program.  It computes the function
the configurations state: float32 parameters, each convolution and
matrix product in the compute dtype (bfloat16), the norm's statistics in
float32.  ``precision="fp8"`` is the control: every input of a
convolution or a matrix product (activations and weights) is rounded
through float8 e4m3 with a per-tensor scale in the forward pass, and the
gradient that flows back into it through float8 e5m2, the usual recipe
of fp8 training, one precision below the stated bfloat16.  Two narrower
controls put one part of a model a step below what the configuration
states: ``fp8_branches``, fp8 in the convolutions of the residual
branches alone (``resnet.py``), and ``bf16_stats``, each norm's mean and
mean of squares in bfloat16 in place of float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax ``SAME`` padding (before, after) of one spatial dim: the total
    ``(out-1)*s + k - size`` split with the larger half after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _round_fp8(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    """``x`` through ``fmt`` with a per-tensor scale that maps its largest
    magnitude onto the format's largest value; back in ``x``'s dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    q = (x.float() * scale).to(fmt)
    return (q.float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An input of a convolution or a matrix product at ``precision``."""
    if precision in ("bf16", "bf16_stats"):
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"precision {precision!r}: bf16, bf16_stats or fp8")


class Conv(nn.Module):
    """A convolution's float32 OIHW ``weight`` (and ``bias``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = False, device=None):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        h0, h1 = same_pads(x.shape[2], self.k, self.stride)
        w0, w1 = same_pads(x.shape[3], self.k, self.stride)
        pad = (h0, w0)
        if (h0, w0) != (h1, w1):
            x = F.pad(x, (w0, w1, h0, h1))
            pad = (0, 0)
        w = operand(self.weight.to(x.dtype), precision)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(operand(x, precision), w, b, stride=self.stride,
                        padding=pad)


class Dense(nn.Module):
    """A dense layer's float32 (out, in) ``weight`` and ``bias``; the
    product in ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def forward(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        dt = self.dtype
        w = operand(self.weight.to(dt), precision)
        return F.linear(operand(x.to(dt), precision), w, self.bias.to(dt))


class Norm(nn.Module):
    """Batch norm in training mode over the channels of an NCHW tensor:
    the batch's mean and mean of squares in float32, the biased variance
    ``max(E[x^2] - E[x]^2, 0)``, then ``x * a + b`` in ``x``'s dtype with
    ``a = scale / sqrt(var + eps)`` and ``b = bias - mean * a``."""

    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor, precision: str = "bf16"
                ) -> torch.Tensor:
        if precision == "bf16_stats":
            mean = x.bfloat16().mean(dim=(0, 2, 3)).float()
            mean_sq = x.bfloat16().square().mean(dim=(0, 2, 3)).float()
        else:
            mean = x.mean(dim=(0, 2, 3), dtype=torch.float32)
            mean_sq = x.float().square().mean(dim=(0, 2, 3))
        var = (mean_sq - mean.square()).clamp_min(0.0)
        a = torch.rsqrt(var + self.eps) * self.scale
        b = self.bias - mean * a
        return x * a.to(x.dtype)[None, :, None, None] + \
            b.to(x.dtype)[None, :, None, None]


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Max pool with flax ``SAME`` padding, padded with -inf."""
    h0, h1 = same_pads(x.shape[2], k, s)
    w0, w1 = same_pads(x.shape[3], k, s)
    if h0 or h1 or w0 or w1:
        x = F.pad(x, (w0, w1, h0, h1), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def nhwc_input(x: torch.Tensor, dtype: torch.dtype,
               channels_last: bool = False) -> torch.Tensor:
    """The NHWC batch as an NCHW tensor of ``dtype``, contiguous, or in
    channels-last memory where asked (the same function through other
    kernels: a witness of how far rounding alone moves the readings)."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=fmt)
