"""Conv building blocks, twins of partseg_tpu/models/blocks.py.

Modules here take and return logical NCHW tensors (stored channels_last
on the card); the encoders and the decoder convert at their NHWC
boundaries. Parameters are f32; each layer computes in its ``dtype``
(bf16 by default), like Flax's ``dtype=bf16, param_dtype=f32``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NORMS = ("block", "group", "none")


class Conv2d(nn.Conv2d):
    """Flax ``nn.Conv`` twin: square kernel, stride 1, "SAME" padding, f32
    parameters, input/kernel/bias cast to ``dtype`` for the product."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dtype: torch.dtype = torch.bfloat16):
        if kernel % 2 != 1:
            raise ValueError(f"SAME padding needs an odd kernel, got {kernel}")
        super().__init__(in_channels, out_channels, kernel, padding=kernel // 2)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), padding=self.padding)


class Linear(nn.Linear):
    """Flax ``nn.Dense`` twin: f32 parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class GroupNorm(nn.GroupNorm):
    """Flax ``nn.GroupNorm`` twin: eps 1e-6 (torch's default is 1e-5) and
    statistics in f32 whatever the input dtype; the output keeps it."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """norm → relu → conv (pre-activation). norm: "group" or "none"."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 groups: int = 8, norm: str = "group",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if norm not in ("group", "none"):
            raise ValueError(f"unknown ConvBlock norm: {norm!r}")
        self.norm = GroupNorm(min(groups, in_channels), in_channels) if norm == "group" else None
        self.conv = Conv2d(in_channels, features, kernel, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        return self.conv(F.relu(x))


def quantize_activation(x: torch.Tensor, act_quant: str) -> torch.Tensor:
    """Activation-storage quantization: "none", or "f8" — a float8_e4m3fn
    round trip of the value (forward only; the straight-through gradient
    of the JAX package's ``f8_store`` comes with the training slice)."""
    if act_quant == "none":
        return x
    if act_quant == "f8":
        return x.to(torch.float8_e4m3fn).to(x.dtype)
    raise ValueError(f"unknown act_quant mode: {act_quant!r}")


class ResBlock(nn.Module):
    """Pre-activation bottleneck residual block: 1×1 (C/2) → 3×3 (C/2) →
    1×1 (C), with a 1×1 projection skip when the channel count changes.

    norm: "block" = one GroupNorm at block entry, whose output is ALSO
    the residual branch's input; "group" = GroupNorm in every ConvBlock;
    "none" = no normalization.
    """

    def __init__(self, in_channels: int, features: int, norm: str = "block",
                 act_quant: str = "none", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown ResBlock norm: {norm!r}")
        half = max(features // 2, 8)
        inner = "group" if norm == "group" else "none"
        self.norm = GroupNorm(min(8, in_channels), in_channels) if norm == "block" else None
        self.convs = nn.ModuleList([
            ConvBlock(in_channels, half, kernel=1, norm=inner, dtype=dtype),
            ConvBlock(half, half, kernel=3, norm=inner, dtype=dtype),
            ConvBlock(half, features, kernel=1, norm=inner, dtype=dtype),
        ])
        self.skip = Conv2d(in_channels, features, 1, dtype) if in_channels != features else None
        self.act_quant = act_quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm is not None:
            x = self.norm(x)
        y = x
        for conv in self.convs:
            y = conv(y)
        if self.skip is not None:
            x = self.skip(x)
        return quantize_activation(x + y, self.act_quant)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsampling of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
