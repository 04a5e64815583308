"""Inception V3 in PyTorch.

Counterpart of ``horovod_tpu/models/inception.py`` (``InceptionV3``:
stem, 3x Inception-A, B, 4x C, D, 2x E, no auxiliary head), computing the
same function:

* ``ConvBN``: a bias-free conv, ``TpuBatchNorm`` at momentum 0.9 and
  epsilon 1e-3, a ReLU; submodules ``Conv_0`` and ``TpuBatchNorm_0``.
  ``bn_axis_name`` (with ``mesh=``) synchronizes the norms in training.
* flax names the ``ConvBN``s ``ConvBN_0``, ``ConvBN_1``... in the order
  they are CONSTRUCTED: in ``conv(64, (5, 5))(conv(48, (1, 1))(x))``
  Python makes the outer 5x5 before the inner 1x1, so the 5x5 takes the
  lower number though it runs second.  ``__init__`` makes them in that
  order; ``forward`` runs them in data order.
* The (1,7)/(7,1) and (1,3)/(3,1) convs pad flax's ``SAME`` per dim; the
  branch pools are ``avg_pool`` 3x3/1 ``SAME`` counting the padded zeros
  (flax's ``count_include_pad=True``); the max pools are 3x3/2 ``VALID``.
* The head is the spatial mean, then ``Dense_0`` in float32.

The input is NHWC; at least 75x75, the smallest its ``VALID`` stages
take (299 in the benchmark).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from ._layers import (
    Conv,
    Dense,
    avg_pool_same,
    max_pool,
    nhwc_to_nchw,
    reset_all,
)
from .tpu_norm import TpuBatchNorm, norm_relu


class ConvBN(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel, stride=1,
                 padding: str = "SAME", dtype: torch.dtype = torch.bfloat16,
                 device=None, bn_axis_name: Optional[str] = None,
                 mesh=None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, kernel, stride, dtype=dtype,
                           device=device, padding=padding)
        self.TpuBatchNorm_0 = TpuBatchNorm(
            features, dtype=dtype, device=device, momentum=0.9,
            epsilon=1e-3, axis_name=bn_axis_name, mesh=mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_relu(self.TpuBatchNorm_0, self.Conv_0(x))


class InceptionV3(nn.Module):
    """Inception V3 without the auxiliary head; input NHWC, logits
    float32.  ``device="meta"`` makes the shapes alone."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None, *,
                 bn_axis_name: Optional[str] = None, mesh=None):
        super().__init__()
        self.dtype = dtype
        self._n = 0
        kw = dict(dtype=dtype, device=device, bn_axis_name=bn_axis_name,
                  mesh=mesh)

        def conv(in_ch, out, kernel, stride=1, padding="SAME"):
            m = ConvBN(in_ch, out, kernel, stride, padding, **kw)
            self.add_module(f"ConvBN_{self._n}", m)
            self._n += 1
            return m

        # stem (299x299x3 -> 35x35x192)
        self.stem = [conv(3, 32, 3, 2, "VALID"), conv(32, 32, 3, 1, "VALID"),
                     conv(32, 64, 3), conv(64, 80, 1, 1, "VALID"),
                     conv(80, 192, 3, 1, "VALID")]
        # 3x Inception-A; each list in construction order
        self.blocks_a: List[tuple] = []
        c = 192
        for pool_features in (32, 64, 64):
            b1 = conv(c, 64, 1)
            b5 = [conv(48, 64, 5), conv(c, 48, 1)]
            b3 = [conv(96, 96, 3), conv(64, 96, 3), conv(c, 64, 1)]
            bp = conv(c, pool_features, 1)
            self.blocks_a.append((b1, b5, b3, bp))
            c = 64 + 64 + 96 + pool_features
        # Inception-B (35 -> 17)
        self.block_b = (conv(c, 384, 3, 2, "VALID"),
                        [conv(96, 96, 3, 2, "VALID"), conv(64, 96, 3),
                         conv(c, 64, 1)])
        c = 384 + 96 + c
        # 4x Inception-C with factorized 7x7
        self.blocks_c = []
        for c7 in (128, 160, 160, 192):
            b1 = conv(c, 192, 1)
            b7 = [conv(c7, 192, (7, 1)), conv(c7, c7, (1, 7)),
                  conv(c, c7, 1)]
            d0 = conv(c, c7, 1)
            d1 = [conv(c7, c7, (1, 7)), conv(c7, c7, (7, 1))]
            d2 = [conv(c7, 192, (7, 1)), conv(c7, c7, (1, 7))]
            bp = conv(c, 192, 1)
            self.blocks_c.append((b1, b7, d0, d1, d2, bp))
            c = 4 * 192
        # Inception-D (17 -> 8)
        self.block_d = ([conv(192, 320, 3, 2, "VALID"), conv(c, 192, 1)],
                        [conv(192, 192, (1, 7)), conv(c, 192, 1)],
                        [conv(192, 192, 3, 2, "VALID"),
                         conv(192, 192, (7, 1))])
        c = 320 + 192 + c
        # 2x Inception-E
        self.blocks_e = []
        for _ in range(2):
            b1 = conv(c, 320, 1)
            b3 = conv(c, 384, 1)
            b3s = [conv(384, 384, (1, 3)), conv(384, 384, (3, 1))]
            bd = [conv(448, 384, 3), conv(c, 448, 1)]
            bds = [conv(384, 384, (1, 3)), conv(384, 384, (3, 1))]
            bp = conv(c, 192, 1)
            self.blocks_e.append((b1, b3, b3s, bd, bds, bp))
            c = 320 + 768 + 768 + 192
        self.Dense_0 = Dense(c, num_classes, device=device)
        reset_all(self, generator)

    @staticmethod
    def _chain(convs, x):
        """Apply a chain listed in construction order (outermost first)."""
        for m in reversed(convs):
            x = m(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x, self.dtype)
        s = self.stem
        x = s[2](s[1](s[0](x)))
        x = max_pool(x, 3, 2)
        x = s[4](s[3](x))
        x = max_pool(x, 3, 2)

        for b1, b5, b3, bp in self.blocks_a:
            x = torch.cat([b1(x), self._chain(b5, x), self._chain(b3, x),
                           bp(avg_pool_same(x))], dim=1)

        b3, bd = self.block_b
        x = torch.cat([b3(x), self._chain(bd, x), max_pool(x, 3, 2)], dim=1)

        for b1, b7, d0, d1, d2, bp in self.blocks_c:
            dbl = self._chain(d2, self._chain(d1, d0(x)))
            x = torch.cat([b1(x), self._chain(b7, x), dbl,
                           bp(avg_pool_same(x))], dim=1)

        b3, b7a, b7b = self.block_d
        x = torch.cat([self._chain(b3, x),
                       self._chain(b7b, self._chain(b7a, x)),
                       max_pool(x, 3, 2)], dim=1)

        for b1, b3, b3s, bd, bds, bp in self.blocks_e:
            y3 = b3(x)
            yd = self._chain(bd, x)
            x = torch.cat([b1(x), b3s[0](y3), b3s[1](y3), bds[0](yd),
                           bds[1](yd), bp(avg_pool_same(x))], dim=1)

        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return self.Dense_0(x)
