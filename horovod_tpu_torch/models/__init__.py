"""Models of the PyTorch port (counterpart of ``horovod_tpu/models``)."""

from .resnet import BatchNorm, BottleneckBlock, ResNet, ResNet50
from .transformer import (
    Transformer,
    TransformerConfig,
    init_params as transformer_init_params,
    make_loss_fn as transformer_loss_fn,
    make_train_step as transformer_train_step,
    param_specs as transformer_param_specs,
)

__all__ = [
    "BatchNorm", "BottleneckBlock", "ResNet", "ResNet50",
    "Transformer",
    "TransformerConfig",
    "transformer_init_params",
    "transformer_loss_fn",
    "transformer_train_step",
    "transformer_param_specs",
]
