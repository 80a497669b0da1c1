"""Spatial sharding: feature maps whose image rows are split over the ranks
of a space group, the port's counterpart of partseg_tpu/parallel/spatial.py.

Each rank holds rows [i·h, (i+1)·h) of every map of its data shard (rank
i of the space group); parameters are replicated. The building blocks:

  halo_exchange               neighbour rows for a convolution
  sharded_spatial_conv        SAME conv on row shards == the global conv
  sharded_spatial_softmax     per-part softmax over the GLOBAL H×W
  sharded_soft_argmax_moments raw-moment partials, summed over the group
  sharded_render_gaussians    row-local rendering (no communication)
  sharded_pool_appearance     numerator/denominator partials, summed

Every block is exact: the softmax takes a global max and sum, the
moments and the pooling sum their partials, and a convolution sees its
neighbours' true rows (zero rows at the global edges, which is SAME
padding). The part ops here are plain torch, as the JAX package's are
jnp: the ``softmax_moments`` kernel needs the whole map.

Gradients. Every collective that a gradient crosses is an autograd
Function whose backward is its adjoint: the backward of a sum over the
group is a sum of the cotangents over the group, and the backward of
the halo exchange sends each received row's cotangent back to the rank
that sent it. Each rank's loss is the whole data shard's loss, seeded
with 1, so the backward on a rank gives the gradient of the sum of its
group's n identical losses with respect to that rank's copy of the
parameters, and the sum of the ranks' gradients is n times the true
one: the step averages the gradients over every rank (space and data)
in one all-reduce (parallel/spatial_train.py). JAX's step instead sums
over space and averages over data the gradients that its psum's
transpose leaves; ``torch.distributed.nn``'s all_reduce has the adjoint
backward used here, and summing over space after it would count the
space group's losses n times.

Collectives run on any backend that has all_reduce and all_gather for
the tensors' device (gloo for CPU and CUDA tensors, NCCL for CUDA): the
halo exchange is an all_gather, not send/recv.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from partseg_tpu_torch import tracing
from partseg_tpu_torch.dist.mesh import group_rank, group_size
from partseg_tpu_torch.partops.coords import coord_grid, moment_basis
from partseg_tpu_torch.partops.moments import moments_from_raw, precision_from_cov
from partseg_tpu_torch.partops.render import RENDER_KERNELS

def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor over ``group``: the span
    and counter ``spatial.reduce`` (``tracing``)."""
    tracing.count("spatial.reduce")
    with tracing.span("spatial.reduce"):
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (the same shape on each), in group order: the span
    and counter ``spatial.halo`` (halo rows, and the step's input rows)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(group_size(group))]
    tracing.count("spatial.halo")
    with tracing.span("spatial.halo"):
        dist.all_gather(out, x, group=group)
    return out


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    return all_reduce_(x.reshape(-1).clone(), group, op).view(x.shape)


class _GroupSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents (the adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the space group of ``x`` (the JAX ``psum``), differentiable."""
    if group_size(group) == 1:
        return x
    return _GroupSum.apply(x, group)


def _group_max_nograd(x: torch.Tensor, group) -> torch.Tensor:
    """Max over the group, without a gradient: the softmax's stabiliser,
    a shift that the softmax does not depend on (JAX's ``_pmax_stopgrad``)."""
    x = x.detach()
    if group_size(group) == 1:
        return x
    return _all_reduce(x, group, dist.ReduceOp.MAX)


class _Halo(torch.autograd.Function):
    """x [..., h, ...] (rows on ``dim``) → [..., halo + h + halo, ...]: the
    previous rank's last ``halo`` rows above, the next rank's first below,
    zero rows at the global edges."""

    @staticmethod
    def forward(ctx, x, halo, group, dim):
        ctx.halo, ctx.group, ctx.dim = halo, group, dim
        i, n = group_rank(group), group_size(group)
        edges = all_gather(torch.stack([x.narrow(dim, 0, halo),
                                        x.narrow(dim, x.shape[dim] - halo, halo)]), group)
        zeros = torch.zeros_like(edges[0][0])
        above = edges[i - 1][1] if i > 0 else zeros
        below = edges[i + 1][0] if i < n - 1 else zeros
        if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
                memory_format=torch.channels_last):
            # Keep a channels_last slab channels_last (cat of mixed formats
            # gives a contiguous NCHW result).
            above = above.contiguous(memory_format=torch.channels_last)
            below = below.contiguous(memory_format=torch.channels_last)
        return torch.cat([above, x, below], dim=dim)

    @staticmethod
    def backward(ctx, g):
        halo, group, dim = ctx.halo, ctx.group, ctx.dim
        i, n = group_rank(group), group_size(group)
        h = g.shape[dim] - 2 * halo
        # Send the cotangent of the rows received from each neighbour back
        # to it: the previous rank adds our top halo's to its last rows,
        # the next rank our bottom halo's to its first rows.
        sent = all_gather(torch.stack([g.narrow(dim, 0, halo), g.narrow(dim, halo + h, halo)]),
                          group)
        gx = g.narrow(dim, halo, h).clone()
        if i < n - 1:
            gx.narrow(dim, h - halo, halo).add_(sent[i + 1][0])
        if i > 0:
            gx.narrow(dim, 0, halo).add_(sent[i - 1][1])
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, halo: int, group, dim: int = 1) -> torch.Tensor:
    """Extend a row shard with ``halo`` rows from each neighbour (rows on
    ``dim``: 1 for NHWC, 2 for NCHW). Global-edge ranks get zero rows, so a
    convolution that is VALID over rows on the widened slab equals the
    global SAME convolution."""
    if halo <= 0:
        return x
    if group_size(group) == 1:
        pad = [0, 0] * (x.dim() - 1 - dim) + [halo, halo]
        return torch.nn.functional.pad(x, pad)
    if x.shape[dim] < halo:
        raise ValueError(f"a row shard of {x.shape[dim]} rows cannot give a halo of {halo}")
    return _Halo.apply(x, halo, group, dim)


def sharded_spatial_conv(x: torch.Tensor, weight: torch.Tensor, group) -> torch.Tensor:
    """SAME convolution over the GLOBAL image from a row shard.

    x [B, h, W, Cin] NHWC; weight [Cout, Cin, kh, kw] (OIHW) → [B, h, W, Cout].
    The halo gives the rows' context; columns are padded locally."""
    kh, kw = weight.shape[2], weight.shape[3]
    xc = halo_exchange(x.permute(0, 3, 1, 2), kh // 2, group, dim=2)
    out = torch.nn.functional.conv2d(xc, weight, padding=(0, kw // 2))
    return out.permute(0, 2, 3, 1)


def sharded_spatial_softmax(logits: torch.Tensor, group) -> torch.Tensor:
    """Per-part softmax over the GLOBAL H×W from row shards, f32: a global
    max (no gradient) for stability, then a global sum of the exponentials."""
    x = logits.float()
    m = _group_max_nograd(x.amax(dim=(1, 2), keepdim=True), group)
    e = torch.exp(x - m)
    return e / group_sum(e.sum(dim=(1, 2), keepdim=True), group)


def row_offset(h_local: int, group) -> int:
    """The first GLOBAL row held by this rank."""
    return group_rank(group) * h_local


def sharded_soft_argmax_moments(p: torch.Tensor, h_global: int, group):
    """(μ, Σ) of a globally normalised distribution from its row shards
    p [B, h, W, K]: each rank's [B, K, 5] raw moments against the basis at
    its global rows, summed over the group."""
    b, h, w, k = p.shape
    r0 = row_offset(h, group)
    basis = moment_basis(h_global, w, device=p.device)[r0 * w:(r0 + h) * w]
    raw = torch.einsum("bnk,nm->bkm", p.float().reshape(b, h * w, k), basis)
    return moments_from_raw(group_sum(raw, group))


def sharded_render_gaussians(mu: torch.Tensor, sigma: torch.Tensor | None, h_global: int,
                             w: int, h_local: int, group, kernel: str = "gauss",
                             eps: float = 1e-4,
                             precision: torch.Tensor | None = None) -> torch.Tensor:
    """This rank's rows [B, h_local, W, K] f32 of the global blob maps: (μ, Σ)
    are replicated, the grid rows local, so no communication."""
    if kernel not in RENDER_KERNELS:
        raise ValueError(f"unknown render kernel: {kernel!r}")
    lam = precision_from_cov(sigma, eps) if precision is None else precision.float()
    yy, xx = coord_grid(h_global, w, device=mu.device)
    r0 = row_offset(h_local, group)
    yy, xx = yy[r0:r0 + h_local], xx[r0:r0 + h_local]
    muf = mu.float()
    dy = yy[None, :, :, None] - muf[:, None, None, :, 0]
    dx = xx[None, :, :, None] - muf[:, None, None, :, 1]
    l00 = lam[:, None, None, :, 0, 0]
    l01 = lam[:, None, None, :, 0, 1]
    l11 = lam[:, None, None, :, 1, 1]
    d = torch.clamp(l00 * dy * dy + 2.0 * l01 * dy * dx + l11 * dx * dx, min=0.0)
    return torch.exp(-0.5 * d) if kernel == "gauss" else 1.0 / (1.0 + d)


def sharded_pool_appearance(feats: torch.Tensor, parts: torch.Tensor, group,
                            eps: float = 1e-8) -> torch.Tensor:
    """Part-weighted feature means over the GLOBAL image from row shards,
    [B, K, C] f32: the numerator and denominator partials summed over the
    group in one collective."""
    b, h, w, c = feats.shape
    k = parts.shape[-1]
    f = feats.float().reshape(b, h * w, c)
    p = parts.float().reshape(b, h * w, k)
    num = torch.bmm(p.transpose(1, 2), f)                        # [B, K, C]
    den = p.sum(dim=1).unsqueeze(-1)                             # [B, K, 1]
    both = group_sum(torch.cat([num, den], dim=-1), group)
    return both[..., :c] / (both[..., c:] + eps)
