"""Models of the PyTorch port (counterpart of ``horovod_tpu/models``)."""

from .resnet import BatchNorm, BottleneckBlock, ResNet, ResNet50

__all__ = ["BatchNorm", "BottleneckBlock", "ResNet", "ResNet50"]
