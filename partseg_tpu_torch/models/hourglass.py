"""Hourglass module, twin of partseg_tpu/models/hourglass.py: at each
level a skip branch at the current resolution and a 2×2-average-pooled
branch that recurses, then 2× nearest upsample and add."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from partseg_tpu_torch.models.blocks import ResBlock, upsample2x


class Hourglass(nn.Module):
    """[B, C, H, W] → [B, C, H, W] (H, W divisible by 2**depth).

    ``blocks`` holds the 3·depth + 1 ResBlocks in the order the forward
    calls them (depth-first: up, low, recurse, low), which is also the
    order Flax numbers them in.
    """

    def __init__(self, depth: int = 4, features: int = 128, norm: str = "block",
                 act_quant: str = "none", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depth = depth
        self.blocks = nn.ModuleList(
            ResBlock(features, features, norm, act_quant, dtype) for _ in range(3 * depth + 1)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = iter(self.blocks)

        def level(x: torch.Tensor, d: int) -> torch.Tensor:
            up = next(blocks)(x)
            low = next(blocks)(F.avg_pool2d(x, 2))
            low = level(low, d - 1) if d > 1 else next(blocks)(low)
            low = next(blocks)(low)
            return up + upsample2x(low)

        return level(x, self.depth)
