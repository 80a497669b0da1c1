"""The encoders on row shards, the port's counterpart of
partseg_tpu/parallel/spatial_model.py.

The functions here run the port's own modules (``models/blocks.py``,
``encoders.py``, ``hourglass.py``) on the rows of a space group's rank:
every convolution wider than 1×1 gets its neighbours' rows through the
halo exchange, every GroupNorm takes exact statistics over the group's
rows, pools and upsamples stay row-local. They read the modules'
parameters, so a checkpoint or the weights that ``convert.py`` carries
across serve the sharded and the unsharded forward alike. Each is exact
against the module's own forward (tests/test_torch_spatial.py).

Tensors are NCHW inside (rows on dim 2), as the modules are; the
encoders take and return NHWC.

A strided stem is a space-to-depth rearrangement, which is row-local
when the shard's rows divide by the stride, then a 3×3 convolution on
the coarse grid: its halo of one coarse row is ``stem_stride`` image rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from partseg_tpu_torch.dist.mesh import group_size
from partseg_tpu_torch.models.blocks import Conv2d, ConvBlock, GroupNorm, ResBlock, upsample2x
from partseg_tpu_torch.models.encoders import (
    AppearanceEncoder,
    ShapeEncoder,
    _Stem,
    to_nchw,
    to_nhwc,
)
from partseg_tpu_torch.models.hourglass import Hourglass
from partseg_tpu_torch.parallel.spatial import all_reduce_, halo_exchange


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_(x, group) if group_size(group) > 1 else x


class _ShardedGroupNorm(torch.autograd.Function):
    """GroupNorm of x [B, C, h, W] with statistics over the group's rows.

    Forward: per-(sample, group) sums and sums of squares, summed over the
    group in one all-reduce, as the JAX ``sharded_group_norm`` (f32,
    var = E[x²] − mean²). Backward: the GroupNorm gradient with its two
    per-group sums of the cotangent (Σ g·γ and Σ g·γ·x̂) summed over the
    group the same way, the adjoint of the forward's reduction. Only x,
    the mean and 1/σ are kept for the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, group):
        b, c, h, w = x.shape
        xf = x.float().reshape(b, groups, -1)
        stats = _sum_over(torch.stack([xf.sum(-1), (xf * xf).sum(-1)]), group)
        count = xf.shape[-1] * group_size(group)
        mean = stats[0] / count
        rstd = torch.rsqrt(stats[1] / count - mean * mean + eps)
        xhat = ((xf - mean[..., None]) * rstd[..., None]).reshape(b, c, h, w)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.groups, ctx.group, ctx.count = groups, group, count
        y = xhat * weight[None, :, None, None] + bias[None, :, None, None]
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, rstd = ctx.saved_tensors
        b, c, h, w = x.shape
        g = ctx.groups
        gy = gy.float()
        xhat = (x.float().reshape(b, g, -1) - mean[..., None]) * rstd[..., None]
        xhat = xhat.reshape(b, c, h, w)
        d_weight = (gy * xhat).sum(dim=(0, 2, 3))
        d_bias = gy.sum(dim=(0, 2, 3))
        gx = (gy * weight[None, :, None, None]).reshape(b, g, -1)
        xh = xhat.reshape(b, g, -1)
        sums = _sum_over(torch.stack([gx.sum(-1), (gx * xh).sum(-1)]), ctx.group) / ctx.count
        dx = rstd[..., None] * (gx - sums[0][..., None] - xh * sums[1][..., None])
        return dx.reshape(b, c, h, w).to(x.dtype), d_weight, d_bias, None, None, None


def sharded_group_norm(x: torch.Tensor, gn: GroupNorm, group) -> torch.Tensor:
    """The module ``gn`` (a Flax-style GroupNorm: f32 statistics, eps 1e-6,
    output in x's dtype) on the row shard x [B, C, h, W], with exact
    global statistics."""
    return _ShardedGroupNorm.apply(x, gn.weight, gn.bias, gn.num_groups, gn.eps, group)


def _conv(x: torch.Tensor, conv: Conv2d, group) -> torch.Tensor:
    """The module ``conv`` (SAME over the global image) on a row shard; a
    1×1 convolution needs no halo."""
    dt = conv.compute_dtype
    k = conv.kernel_size[0]
    x = halo_exchange(x.to(dt), k // 2, group, dim=2)
    return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=(0, k // 2))


def _convblock(x: torch.Tensor, block: ConvBlock, group) -> torch.Tensor:
    """models/blocks.py ConvBlock: [GroupNorm] → relu → conv."""
    if block.norm is not None:
        x = sharded_group_norm(x, block.norm, group)
    return _conv(F.relu(x), block.conv, group)


def _resblock(x: torch.Tensor, block: ResBlock, group) -> torch.Tensor:
    """models/blocks.py ResBlock in the norm mode it was built with ("block":
    one GroupNorm at entry; "group": one in every ConvBlock; "none")."""
    if block.act_quant != "none":
        raise ValueError(
            "spatial sharding does not implement activation-storage "
            f"quantization (act_quant={block.act_quant!r}); train spatial "
            "configs with act_quant='none' — a silent numeric mismatch "
            "vs the unsharded forward is worse than this error")
    if block.norm is not None:
        x = sharded_group_norm(x, block.norm, group)
    y = x
    for conv in block.convs:
        y = _convblock(y, conv, group)
    if block.skip is not None:
        x = _conv(x, block.skip, group)
    return x + y


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    if x.shape[2] % 2:
        raise ValueError(f"a row shard of {x.shape[2]} rows cannot be pooled 2×2")
    return F.avg_pool2d(x, 2)


def _hourglass(x: torch.Tensor, hg: Hourglass, group) -> torch.Tensor:
    """models/hourglass.py's recursion, its ResBlocks in call order."""
    blocks = iter(hg.blocks)

    def level(x: torch.Tensor, d: int) -> torch.Tensor:
        up = _resblock(x, next(blocks), group)
        low = _resblock(_avg_pool2(x), next(blocks), group)
        low = level(low, d - 1) if d > 1 else _resblock(low, next(blocks), group)
        low = _resblock(low, next(blocks), group)
        return up + upsample2x(low)

    return level(x, hg.depth)


def _run_hourglass(hg: Hourglass, x: torch.Tensor, remat: bool, group) -> torch.Tensor:
    """``_hourglass``; with ``remat`` in training under activation
    checkpointing, as the module's ``run_hourglass`` (the recomputation
    repeats the collectives, in the same order on every rank)."""
    if remat and hg.training and torch.is_grad_enabled():
        return checkpoint(_hourglass, x, hg, group, use_reentrant=False)
    return _hourglass(x, hg, group)


def _stem(x: torch.Tensor, stem: _Stem, group) -> torch.Tensor:
    """models/encoders.py _Stem on NHWC rows: s×s space-to-depth → 3×3 conv
    → ResBlock, NCHW out."""
    b, h, w, c = x.shape
    s = stem.stride
    x = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, h // s, w // s, s * s * c)
    return _resblock(_conv(to_nchw(x), stem.conv, group), stem.res, group)


def _check_rows(x: torch.Tensor, stride: int, depth: int) -> None:
    need = stride * 2 ** depth
    if x.shape[1] % need:
        raise ValueError(
            f"H_local={x.shape[1]} must be divisible by stem_stride*2^depth="
            f"{need} (stem stride × hourglass pools)")


def sharded_shape_encoder(enc: ShapeEncoder, x: torch.Tensor, group) -> torch.Tensor:
    """``enc`` on the row shard x [B, h, W, 3] → its rows of the part
    logits [B, h/s (·2 with head_upsample), W/s, K(+1)] f32."""
    _check_rows(x, enc.stem.stride, enc.hourglasses[0].depth)
    x = _stem(x, enc.stem, group)
    for hg in enc.hourglasses:
        x = _run_hourglass(hg, x, enc.remat, group)
    if enc.head_upsample:
        x = upsample2x(x)            # row-local: each output row reads one input row
    return to_nhwc(_conv(_convblock(x, enc.head_block, group), enc.head, group))


def sharded_appearance_encoder(enc: AppearanceEncoder, x: torch.Tensor, group) -> torch.Tensor:
    """``enc`` on the row shard x [B, h, W, 3] → its rows of the appearance
    features [B, h/s, W/s, C] in the model dtype."""
    _check_rows(x, enc.stem.stride, enc.hourglass.depth)
    x = _run_hourglass(enc.hourglass, _stem(x, enc.stem, group), enc.remat, group)
    if enc.head_upsample:
        x = upsample2x(x)
    return to_nhwc(_conv(_convblock(x, enc.head_block, group), enc.head, group))
