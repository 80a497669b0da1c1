"""Losses: VGG perceptual reconstruction and TPS equivariance."""

from partseg_tpu_torch.losses.equivariance import equivariance_loss
from partseg_tpu_torch.losses.perceptual import PerceptualLoss
from partseg_tpu_torch.losses.vgg import VGG19Features, load_vgg19

__all__ = ["PerceptualLoss", "VGG19Features", "equivariance_loss", "load_vgg19"]
