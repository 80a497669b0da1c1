"""Models: hourglass shape/appearance encoders and the image decoder,
twins of partseg_tpu/models with the same names."""

from partseg_tpu_torch.models.blocks import ConvBlock, ResBlock
from partseg_tpu_torch.models.decoder import Decoder
from partseg_tpu_torch.models.encoders import AppearanceEncoder, ShapeEncoder
from partseg_tpu_torch.models.hourglass import Hourglass
from partseg_tpu_torch.models.partnet import (
    PartNet,
    PartNetConfig,
    PartNetOutputs,
    init_weights,
)

__all__ = [
    "ConvBlock",
    "ResBlock",
    "Hourglass",
    "ShapeEncoder",
    "AppearanceEncoder",
    "Decoder",
    "PartNet",
    "PartNetConfig",
    "PartNetOutputs",
    "init_weights",
]
