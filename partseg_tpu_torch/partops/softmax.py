"""Part-map normalizations.

  (a) ``part_softmax`` — per-PIXEL softmax across the K parts (plus an
      optional background channel): the dense soft part segmentation.
  (b) ``spatial_softmax`` / ``normalize_maps`` — per-PART normalization
      over the H×W pixels: the spatial distributions whose moments give
      the landmarks.
"""

from __future__ import annotations

import torch


def part_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-pixel softmax across parts. logits: [..., H, W, K] (NHWC)."""
    return torch.softmax(logits, dim=dim)


def spatial_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Per-part softmax over spatial locations, in f32.

    logits: [B, H, W, K] → probabilities whose sum over (H, W) is 1 for
    every (batch, part).
    """
    b, h, w, k = logits.shape
    x = logits.float().reshape(b, h * w, k)
    return torch.softmax(x, dim=1).reshape(b, h, w, k)


def normalize_maps(maps: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-part division by the spatial sum (for nonnegative maps), f32."""
    m = maps.float()
    return m / (m.sum(dim=(1, 2), keepdim=True) + eps)
