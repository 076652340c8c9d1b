"""Port models."""

from weather_unet_tpu_torch.models.common import ConditionalNorm
from weather_unet_tpu_torch.models.cunet import (
    AdaINBlock, ConditionalUNet, DoubleConvDown, RDoubleConv, UpsampleBox)
from weather_unet_tpu_torch.models.resnet import (
    Bottleneck, ResNet, ResNet50, ResNet101)
from weather_unet_tpu_torch.models.sndisc import SNDisc, SNDoubleConv

__all__ = ["AdaINBlock", "Bottleneck", "ConditionalNorm", "ConditionalUNet",
           "DoubleConvDown", "RDoubleConv", "ResNet", "ResNet50",
           "ResNet101", "SNDisc", "SNDoubleConv", "UpsampleBox"]
