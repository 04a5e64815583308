"""The flax layers the port's CNNs share, as PyTorch modules.

Each computes ``flax.linen``'s function on an NCHW tensor (in channels-last
memory where the model puts it there):

* ``padding="SAME"`` is flax's: along each spatial dim the total padding
  ``(out-1)*s + k - in`` splits as ``(total//2, total - total//2)``, so a
  strided conv on an even size pads more on the far side; PyTorch's
  symmetric padding computes another function, so asymmetric cases pad
  explicitly.  Max pools pad with -inf; :func:`avg_pool_same` counts the
  padded zeros (flax's ``count_include_pad=True``).
* Parameters are float32 and cast to the compute ``dtype`` per call
  (explicit casts, not autocast, so bfloat16 rounds where flax rounds).
* Kernels draw flax's ``lecun_normal`` (a truncated normal at +-2 std,
  rescaled to unit variance) from the model's generator; biases start at
  zero.  A module made on the ``meta`` device draws nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978

Pair = Union[int, Tuple[int, int]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax ``SAME`` padding (before, after) of one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    if w.is_meta:
        return
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    cpu = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    with torch.no_grad():
        w.copy_(cpu)


def _pad_same(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int]):
    """``x`` padded for flax ``SAME``, or the symmetric ``(h, w)`` padding
    a convolution takes itself (then ``x`` is returned unpadded)."""
    h0, h1 = same_pads(x.shape[2], k[0], s[0])
    w0, w1 = same_pads(x.shape[3], k[1], s[1])
    if h0 == h1 and w0 == w1:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1)), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv`` (``padding`` ``"SAME"`` or ``"VALID"``, bias
    optional) with a float32 OIHW weight cast to ``dtype`` per call."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Pair,
                 stride: Pair = 1, dtype: torch.dtype = torch.bfloat16,
                 device=None, padding: str = "SAME",
                 use_bias: bool = False):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME or VALID")
        self.kernel, self.stride = _pair(kernel), _pair(stride)
        self.padding, self.dtype = padding, dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *self.kernel,
                                               **f32))
        self.bias = (nn.Parameter(torch.zeros(out_ch, **f32)) if use_bias
                     else None)

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[1] * self.kernel[0] * self.kernel[1]
        lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None and not self.bias.is_meta:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        pad = (0, 0)
        if self.padding == "SAME":
            x, pad = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, w, b, stride=self.stride, padding=pad)


class Dense(nn.Linear):
    """flax ``nn.Dense``: float32 ``weight`` (out, in) and ``bias``, the
    product in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        self.compute_dtype = dtype
        super().__init__(in_features, out_features, dtype=torch.float32,
                         device=device)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.in_features, generator)
        if not self.bias.is_meta:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def max_pool(x: torch.Tensor, k: Pair, s: Pair,
             padding: str = "VALID") -> torch.Tensor:
    """flax ``nn.max_pool``; ``SAME`` pads with -inf, explicitly, as
    :func:`avg_pool_same` pads."""
    k, s = _pair(k), _pair(s)
    if padding == "SAME":
        h0, h1 = same_pads(x.shape[2], k[0], s[0])
        w0, w1 = same_pads(x.shape[3], k[1], s[1])
        if h0 or h1 or w0 or w1:
            x = F.pad(x, (w0, w1, h0, h1), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def avg_pool_same(x: torch.Tensor, k: int = 3, s: int = 1) -> torch.Tensor:
    """flax ``nn.avg_pool(padding="SAME")``: the padded zeros count.

    The zeros are padded explicitly, never by ``avg_pool2d``'s
    ``padding``: on a channels-last CUDA tensor PyTorch's
    ``avg_pool2d`` backward with ``padding`` returns wrong gradients
    (torch 2.11 on an H100: off by about their own size; ``chip_smoke.py``
    prints the error as ``channels_last_pool_grad``), while the forward
    is right."""
    h0, h1 = same_pads(x.shape[2], k, s)
    w0, w1 = same_pads(x.shape[3], k, s)
    if h0 or h1 or w0 or w1:
        x = F.pad(x, (w0, w1, h0, h1))
    return F.avg_pool2d(x, k, s)


def nhwc_to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The models' NHWC input as an NCHW view in channels-last memory."""
    x = x.to(dtype).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """flax's ``x.reshape(n, -1)`` of an NHWC activation: (h, w, c) order,
    so a Dense kernel carried from flax maps row for row."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def reset_all(model: nn.Module, generator: Optional[torch.Generator]
              ) -> None:
    """Draw every parameter of ``model`` in module order."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
