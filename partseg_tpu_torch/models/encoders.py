"""Shape and appearance encoders, twins of partseg_tpu/models/encoders.py.

Both take NHWC images and return NHWC maps at img/stem_stride; inside
they run on NCHW tensors, which on the card are stored channels_last.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from partseg_tpu_torch.models.blocks import ConvBlock, Conv2d, ResBlock, upsample2x
from partseg_tpu_torch.models.hourglass import Hourglass


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view (channels_last storage when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → contiguous NHWC (free for channels_last storage)."""
    return x.permute(0, 2, 3, 1).contiguous()


def run_hourglass(hg: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``hg(x)``; with ``remat`` in training, under activation checkpointing
    (the JAX package's ``nn.remat(Hourglass)``): its activations are not
    kept but recomputed in the backward."""
    if remat and hg.training and torch.is_grad_enabled():
        return checkpoint(hg, x, use_reentrant=False)
    return hg(x)


class _Stem(nn.Module):
    """Space-to-depth stem: [B, H, W, 3] NHWC → [B, F, H/s, W/s] NCHW.

    The s×s space-to-depth puts channels in (sy, sx, c) order, as the
    JAX package does (``F.pixel_unshuffle`` would give (c, sy, sx)).
    """

    def __init__(self, features: int, dtype: torch.dtype, norm: str = "block",
                 stride: int = 2, act_quant: str = "none", in_channels: int = 3):
        super().__init__()
        self.stride = stride
        self.conv = Conv2d(in_channels * stride * stride, features // 2, 3, dtype)
        self.res = ResBlock(features // 2, features, norm, act_quant, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        s = self.stride
        x = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // s, w // s, s * s * c)
        return self.res(self.conv(to_nchw(x)))


class ShapeEncoder(nn.Module):
    """x [B, H, W, 3] → part logits [B, H/s, W/s, K(+1 bg)] f32."""

    def __init__(self, n_parts: int = 10, background: bool = True, depth: int = 4,
                 features: int = 128, n_stacks: int = 1, norm: str = "block",
                 stem_stride: int = 2, head_upsample: bool = False,
                 act_quant: str = "none", remat: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.remat = remat
        self.stem = _Stem(features, dtype, norm, stem_stride, act_quant)
        self.hourglasses = nn.ModuleList(
            Hourglass(depth, features, norm, act_quant, dtype) for _ in range(n_stacks)
        )
        self.head_upsample = head_upsample
        self.head_block = ConvBlock(features, features, kernel=1, dtype=dtype)
        k = n_parts + (1 if background else 0)
        # Logit head in f32: it feeds the softmaxes directly.
        self.head = Conv2d(features, k, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for hg in self.hourglasses:
            x = run_hourglass(hg, x, self.remat)
        if self.head_upsample:
            x = upsample2x(x)
        return to_nhwc(self.head(self.head_block(x)))


class AppearanceEncoder(nn.Module):
    """x [B, H, W, 3] → appearance features [B, H/s, W/s, C] in ``dtype``."""

    def __init__(self, out_features: int = 128, depth: int = 4, features: int = 128,
                 norm: str = "block", stem_stride: int = 2, head_upsample: bool = False,
                 act_quant: str = "none", remat: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.remat = remat
        self.stem = _Stem(features, dtype, norm, stem_stride, act_quant)
        self.hourglass = Hourglass(depth, features, norm, act_quant, dtype)
        self.head_upsample = head_upsample
        self.head_block = ConvBlock(features, features, kernel=1, dtype=dtype)
        self.head = Conv2d(features, out_features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = run_hourglass(self.hourglass, self.stem(x), self.remat)
        if self.head_upsample:
            x = upsample2x(x)
        return to_nhwc(self.head(self.head_block(x)))
