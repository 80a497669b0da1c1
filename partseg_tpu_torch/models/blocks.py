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

from partseg_tpu_torch.partops.kernels import bias_act, group_norm

NORMS = ("block", "group", "none")


class Conv2d(nn.Conv2d):
    """Flax ``nn.Conv`` twin: square kernel, stride 1, "SAME" padding, f32
    parameters, input/kernel/bias cast to ``dtype`` for the product.

    The product runs without the bias (``product``); the op
    ``partseg::bias_act`` (``partops/kernels/bias_act.py``) then adds it in
    one pass together with what consumes the output next: ``relu``, the
    sum with a ``residual``, or the sum with a ``skip`` convolution's
    output, that convolution's bias added in the same pass."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dtype: torch.dtype = torch.bfloat16):
        if kernel % 2 != 1:
            raise ValueError(f"SAME padding needs an odd kernel, got {kernel}")
        super().__init__(in_channels, out_channels, kernel, padding=kernel // 2)
        self.compute_dtype = dtype

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution without its bias, in ``dtype``."""
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, padding=self.padding)

    def forward(self, x: torch.Tensor, *, relu: bool = False,
                residual: torch.Tensor | None = None,
                skip: tuple[Conv2d, torch.Tensor] | None = None) -> torch.Tensor:
        """conv(x) + bias; then its ReLU, or ``residual`` + it, or for
        ``skip`` = (conv_s, x_s), conv_s(x_s) + it."""
        z = self.product(x)
        if skip is None:
            return bias_act(z, self.bias, relu=relu, residual=residual)
        conv, xs = skip
        return bias_act(z, self.bias, skip=conv.product(xs), skip_bias=conv.bias)


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
    statistics in f32 whatever the input dtype; the output keeps it. Runs
    the op ``partseg::group_norm`` (``partops/kernels/group_norm.py``): on
    the card one kernel that reads the channels_last activation once and
    writes the output, its ReLU, or both."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.with_relu(x, keep_y=True, relu=False)[0]

    def with_relu(self, x: torch.Tensor, keep_y: bool = True, relu: bool = True):
        """(GroupNorm(x) or None, relu(GroupNorm(x)) or None), as asked."""
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, y=keep_y,
                          relu=relu)


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

    def forward(self, x: torch.Tensor, *, activated: bool = False, **epilogue) -> torch.Tensor:
        """``activated``: x is already relu(x) (the previous convolution's
        ``relu`` epilogue), for a block without a norm. ``epilogue``: the
        keywords of ``Conv2d.forward``."""
        if self.norm is not None:
            x = self.norm.with_relu(x, keep_y=False)[1]
        elif not activated:
            x = F.relu(x)
        return self.conv(x, **epilogue)


class _F8Store(torch.autograd.Function):
    """float8_e4m3fn round trip of the value with an identity gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def f8_store(x: torch.Tensor) -> torch.Tensor:
    """Storage-only float8 quantization, twin of the JAX ``f8_store``: the
    value rounds through float8_e4m3fn, the gradient passes straight
    through. Without the custom backward, autograd would round the
    cotangent through e4m3 too and flush cotangents below about 2⁻⁹."""
    return _F8Store.apply(x)


def quantize_activation(x: torch.Tensor, act_quant: str) -> torch.Tensor:
    """Activation-storage quantization: "none", or "f8" (``f8_store``)."""
    if act_quant == "none":
        return x
    if act_quant == "f8":
        return f8_store(x)
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
        first, mid, last = self.convs
        # Without inner GroupNorms each inner convolution's output feeds only
        # the next block's ReLU, which its epilogue applies.
        relu = first.norm is None
        if self.norm is not None:
            # One pass gives the residual branch's input and its ReLU, which
            # the first ConvBlock (norm "none": relu → conv) would recompute.
            x, y = self.norm.with_relu(x)
            y = first.conv(y, relu=True)
        else:
            y = first(x, relu=relu)
        y = mid(y, activated=relu, relu=relu)
        if self.skip is None:
            out = last(y, activated=relu, residual=x)
        else:
            out = last(y, activated=relu, skip=(self.skip, x))
        return quantize_activation(out, self.act_quant)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsampling of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
