"""ResNet v1.5 in PyTorch.

Counterpart of ``horovod_tpu/models/resnet.py`` (``ResNet`` with
``BasicBlock`` or ``BottleneckBlock``, ResNet-18/34/50/101/152), computing
the same function:

* The public input is NHWC, as in JAX; inside, activations are NCHW views
  in channels-last memory.  Convolutions pad flax's ``SAME``
  (``models/_layers.py``): the 7x7/2 stem on 224 pads (2, 3), a 3x3/2
  conv on an even size (0, 1); the stem's max pool pads with -inf.
* The norm is ``TpuBatchNorm`` (``models/tpu_norm.py``) at momentum 0.9,
  epsilon 1e-5; the last norm scale of each block starts at zero.
  ``bn_axis_name`` (with ``mesh=``) synchronizes its moments over that
  axis in training.
* ``stem="s2d"``: space-to-depth of 2x2 blocks (12 channels), then a
  4x4/1 conv in place of the 7x7/2 one (``_space_to_depth``).
* ``remat=True``: each block runs under ``torch.utils.checkpoint`` with a
  selective policy that saves the convolutions' outputs and recomputes
  everything else (the norms, the ReLUs, the sums) in the backward pass:
  the reference's ``save_only_these_names("conv_out")``.  No convolution
  runs twice; the recomputation leaves the running stats alone; the
  function and its gradients are bitwise those of ``remat=False``.  As
  in flax, whose ``nn.remat`` renames the block class, the blocks are
  then named ``CheckpointBottleneckBlock_k`` / ``CheckpointBasicBlock_k``.
* Parameters are float32 and cast to ``dtype`` per call; the Dense layer
  and the logits are float32.
* Submodule names follow the flax scope names (``conv_init``, ``bn_init``,
  ``BottleneckBlock_3.Conv_1``, ``BasicBlock_0.TpuBatchNorm_1``,
  ``Dense_0``...), so ``weights.params_from_jax`` maps parameters one to
  one.

Convolutions are cuDNN calls, as XLA computed them outside any Pallas
kernel in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ._layers import (  # noqa: F401  (same_pads: the tests' name)
    Conv,
    Dense,
    max_pool,
    nhwc_to_nchw,
    reset_all,
    same_pads as _same_pads,
)
from .tpu_norm import BatchNorm, TpuBatchNorm  # noqa: F401

# the flax ResNet's BatchNorm settings (horovod_tpu/models/resnet.py:135)
BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


def _space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth: (N, H, W, C) -> (N, H/b, W/b, C*b*b), the
    channels in (row in block, column in block, channel) order."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, c * block * block)


class _Block(nn.Module):
    """What both blocks share: the norm factory and the projection."""

    def __init__(self, dtype, device, norm_kw):
        super().__init__()
        self._kw = dict(dtype=dtype, device=device)
        self._norm_kw = norm_kw

    def _norm(self, features: int, zero_init: bool = False) -> TpuBatchNorm:
        return TpuBatchNorm(features, zero_init, **self._kw, **self._norm_kw)

    def _project(self, in_ch: int, out_ch: int, stride: int) -> None:
        if stride != 1 or in_ch != out_ch:
            self.conv_proj = Conv(in_ch, out_ch, 1, stride, **self._kw)
            self.norm_proj = self._norm(out_ch)
        else:
            self.conv_proj = self.norm_proj = None

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_proj is None:
            return x
        return self.norm_proj(self.conv_proj(x))


class BottleneckBlock(_Block):
    """ResNet v1.5 bottleneck (stride on the 3x3, as in torchvision)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 norm_kw: Optional[dict] = None):
        super().__init__(dtype, device, norm_kw or {})
        kw = self._kw
        self.Conv_0 = Conv(in_ch, filters, 1, **kw)
        self.TpuBatchNorm_0 = self._norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, **kw)
        self.TpuBatchNorm_1 = self._norm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1, **kw)
        self.TpuBatchNorm_2 = self._norm(filters * 4, zero_init=True)
        self._project(in_ch, filters * 4, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.TpuBatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.TpuBatchNorm_1(self.Conv_1(y)))
        y = self.TpuBatchNorm_2(self.Conv_2(y))
        return F.relu(self._residual(x) + y)


class BasicBlock(_Block):
    """ResNet basic block: two 3x3 convs (stride on the first)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 norm_kw: Optional[dict] = None):
        super().__init__(dtype, device, norm_kw or {})
        kw = self._kw
        self.Conv_0 = Conv(in_ch, filters, 3, stride, **kw)
        self.TpuBatchNorm_0 = self._norm(filters)
        self.Conv_1 = Conv(filters, filters, 3, **kw)
        self.TpuBatchNorm_1 = self._norm(filters, zero_init=True)
        self._project(in_ch, filters, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.TpuBatchNorm_0(self.Conv_0(x)))
        y = self.TpuBatchNorm_1(self.Conv_1(y))
        return F.relu(self._residual(x) + y)


def _conv_out_policy(ctx, op, *args, **kwargs):
    """Save what a convolution returns, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under the ``conv_out`` policy.  The running stats are
    updated by the first run only: the recomputation in the backward pass
    runs the block again."""
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    norms = [m for m in block.modules() if isinstance(m, TpuBatchNorm)]
    runs = [0]

    def run(inp):
        first = runs[0] == 0
        runs[0] += 1
        for m in norms:
            m.update_running = first
        try:
            return block(inp)
        finally:
            for m in norms:
                m.update_running = True

    return checkpoint(run, x, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _conv_out_policy))


class ResNet(nn.Module):
    """ResNet v1.5; input NHWC, logits float32.

    ``block_cls`` is :class:`BottleneckBlock` (the default) or
    :class:`BasicBlock`; ``stem`` ``"conv7"`` or ``"s2d"``; ``remat``
    recomputes the norm and activation chain from saved conv outputs;
    ``bn_axis_name`` (with ``mesh``) synchronizes BatchNorm over that
    mesh axis in training.  ``device="meta"`` makes the shapes alone.
    """

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None,
                 *, block_cls=BottleneckBlock, stem: str = "conv7",
                 remat: bool = False, bn_axis_name: Optional[str] = None,
                 mesh=None):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"stem {stem!r}: 'conv7' or 's2d'")
        self.dtype, self.stem, self.remat = dtype, stem, remat
        kw = dict(dtype=dtype, device=device)
        norm_kw = dict(momentum=BN_MOMENTUM, epsilon=BN_EPSILON,
                       axis_name=bn_axis_name, mesh=mesh)
        if stem == "s2d":
            self.conv_init = Conv(12, num_filters, 4, 1, **kw)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, **kw)
        self.bn_init = TpuBatchNorm(num_filters, **kw, **norm_kw)
        self.block_names = []
        # flax's nn.remat names its class Checkpoint<Block>, and the
        # blocks' scopes with it
        prefix = "Checkpoint" if remat else ""
        in_ch = num_filters
        for i, block_size in enumerate(stage_sizes):
            filters = num_filters * 2 ** i
            for j in range(block_size):
                stride = 2 if i > 0 and j == 0 else 1
                name = f"{prefix}{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block_cls(in_ch, filters, stride,
                                                norm_kw=norm_kw, **kw))
                self.block_names.append(name)
                in_ch = filters * block_cls.expansion
        self.Dense_0 = Dense(in_ch, num_classes, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_all(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem == "s2d":
            x = _space_to_depth(x, 2)
        x = nhwc_to_nchw(x, self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, 3, 2, "SAME")
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.block_names:
            block = getattr(self, name)
            x = _remat_block(block, x) if remat else block(x)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return self.Dense_0(x)


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=BasicBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BasicBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3])
