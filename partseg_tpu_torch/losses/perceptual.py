"""Perceptual reconstruction loss, twin of partseg_tpu/losses/perceptual.py:

L_rec = Σ_l λ_l ‖φ_l(x̂) − φ_l(x)‖₁ + λ_pix ‖x̂ − x‖₁

with VGG features φ_l. The target's features carry no gradient and are
computed under ``no_grad``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from partseg_tpu_torch.losses.vgg import VGG19Features


def _pool_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k average pool of an NHWC tensor via reshape-mean."""
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


class PerceptualLoss(nn.Module):
    """(x_hat, x) → scalar f32. Holds the frozen VGG.

    feature_resolution below the image size average-pools both inputs
    before the VGG (in the VGG's dtype); the pixel term compares x_hat
    with x pooled to x_hat's resolution."""

    def __init__(self, vgg: VGG19Features, layer_weights: Sequence[float] | None = None,
                 pixel_weight: float = 1.0, feature_resolution: int | None = None,
                 vgg_mode: str = "unknown"):
        super().__init__()
        self.vgg = vgg.requires_grad_(False)
        self.vgg_mode = vgg_mode
        self.extract = vgg.extract
        self.layer_weights = (tuple(layer_weights) if layer_weights is not None
                              else (1.0,) * len(self.extract))
        self.pixel_weight = pixel_weight
        self.feature_resolution = feature_resolution

    def forward(self, x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        vh, vt = x_hat, x.to(x_hat.dtype)
        r = min(self.feature_resolution or x_hat.shape[1], x_hat.shape[1])
        if x_hat.shape[1] > r:
            vh = _pool_mean(vh.to(self.vgg.dtype), x_hat.shape[1] // r)
        if x.shape[1] > r:
            vt = _pool_mean(vt.to(self.vgg.dtype), x.shape[1] // r)
        feats_hat = self.vgg(vh)
        with torch.no_grad():
            feats_tgt = self.vgg(vt)
        loss = x_hat.new_zeros((), dtype=torch.float32)
        for name, w in zip(self.extract, self.layer_weights):
            # |f1 − f2| in the feature dtype, accumulated in f32.
            loss = loss + w * (feats_hat[name] - feats_tgt[name]).abs().mean(dtype=torch.float32)
        if self.pixel_weight:
            xp = x
            if x.shape[1] > x_hat.shape[1]:   # compare at the recon resolution
                xp = _pool_mean(x.float(), x.shape[1] // x_hat.shape[1])
            loss = loss + self.pixel_weight * (x_hat.float() - xp.float()).abs().mean()
        return loss
