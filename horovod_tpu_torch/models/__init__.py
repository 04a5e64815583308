"""Models of the PyTorch port (counterpart of ``horovod_tpu/models``):
every name the reference exports, plus the port's own (``Transformer``,
the blocks, ``TpuBatchNorm`` and its other name ``BatchNorm``)."""

from .inception import InceptionV3
from .mlp import MLP
from .resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from .tpu_norm import BatchNorm, TpuBatchNorm
from .transformer import (
    Transformer,
    TransformerConfig,
    init_params as transformer_init_params,
    make_loss_fn as transformer_loss_fn,
    make_train_step as transformer_train_step,
    param_specs as transformer_param_specs,
)
from .vgg import VGG, VGG16, VGG19

__all__ = [
    "MLP",
    "TransformerConfig",
    "transformer_init_params",
    "transformer_loss_fn",
    "transformer_train_step",
    "transformer_param_specs",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "VGG", "VGG16", "VGG19",
    "InceptionV3",
    "Transformer",
    "BasicBlock", "BottleneckBlock",
    "TpuBatchNorm", "BatchNorm",
]
