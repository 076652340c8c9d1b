"""Port models."""

from weather_unet_tpu_torch.models.cunet import (
    AdaINBlock, ConditionalUNet, RDoubleConv)
from weather_unet_tpu_torch.models.resnet import (
    Bottleneck, ResNet, ResNet50, ResNet101)
from weather_unet_tpu_torch.models.sndisc import SNDisc, SNDoubleConv

__all__ = ["AdaINBlock", "Bottleneck", "ConditionalUNet", "RDoubleConv",
           "ResNet", "ResNet50", "ResNet101", "SNDisc", "SNDoubleConv"]
