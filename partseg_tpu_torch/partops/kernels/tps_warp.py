"""Fused TPS flow + border bilinear warp.

Replaces the Pallas TPU kernel ``tps_warp_fused`` of
``partseg_tpu/partops/pallas/bilinear_warp.py`` (``_run_tps_kernel``,
``_kernel_tps``, and ``_kernel_tps_banded`` under ``$PARTSEG_WARP_BAND``).
``tps_warp`` is an autograd Function, as the JAX ``custom_vjp`` is:

- its forward launches ``csrc/tps_warp.cu`` on a CUDA tensor (or raises)
  and runs the plain version (the flow ``basis @ w`` and the gather path of
  ``partops/warp.py``, with the band clamp in band mode) on a CPU tensor;
- its backward, as ``_tps_bwd``: the flow in plain torch, then the
  ``bilinear_sample`` kernel's grads variant and VJP, and
  ``d_weights = basisᵀ @ d_coords``. Band mode does not change the
  backward, as on the TPU.

Band mode follows the TPU kernel exactly: with ``$PARTSEG_WARP_BAND = kh``
rounded up to a multiple of 8, points are grouped in raster order into
tiles of ``default_tile`` points (``$PARTSEG_WARP_TILE`` overrides it),
and per tile the row taps clamp into a kh-row band starting at
``(clip(min floor(fy), 0, H − kh) // 8) · 8``. It applies only where the
TPU kernel applied it (0 < kh < H and tile % W == 0); elsewhere the
warp is unbanded.

``launch_plan`` is the kernel's launch rule (``make_plan`` in the CUDA
source, which the card tests hold it to): a CTA owns a run of points and a
group of images, and in band mode a tile's CTAs form a thread block
cluster. Where a run's basis rows do not fit in shared memory whole, the
wide path stages them in chunks of columns through a ring, beside w for
all M columns, as on the TPU any M up to that: w of one image must fit
(about 24,000 columns). The wide path reads 16-byte basis rows:
``TPSSampler`` passes its basis padded with zero columns to a multiple of
4 (and w with it: the flow is the same), and ``tps_warp`` pads any other
wide basis whose rows are not 16-byte aligned, a copy per call. The
kernel also refuses a band tile whose pixel indices alone overflow shared
memory (a ``$PARTSEG_WARP_TILE`` above about 228000 points); the TPU
kernel would hold such a tile's [tile, M] basis block in VMEM, which has
no room for it either.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.kernels.bilinear_sample import (
    bilinear_sample_vjp,
    sample_with_grads,
)
from partseg_tpu_torch.partops.warp import axis_taps, gather_lerp, gather_sample, pixel_index

MAX_BATCH = 65535                 # gridDim.y at one image per CTA
# The kernel's CTA per mode (csrc/tps_warp.cu, Shape), keyed by band mode:
# (threads, subgroups, images at most). A subgroup's threads take one point
# each and group / subgroups images.
SHAPES = {False: (256, 2, 8), True: (256, 1, 4)}
MAX_CLUSTER = 8                   # CTAs per band tile, at most (the portable cluster)
SMEM_OPT_IN = 232448              # the shared memory a block may opt in to on the H100
SMEM_PER_SM = 233472              # an H100 SM's shared memory; 1 KB of it is kept per CTA
# The wide path's CTA (csrc/tps_warp.cu, Wide), keyed by band mode:
# (points per pass, images at most, basis columns per ring stage). Two CTAs
# to an SM where they fit.
WIDE_SHAPES = {False: (128, 16, 24), True: (256, 8, 16)}
WIDE_STAGES = 3                   # ring stages


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def default_tile(big_ok: bool = False, h: int = 128) -> int:
    """The TPU kernel's point tile (``_default_tile``): 4096 for bf16 images,
    2048 otherwise, scaled by 128/H above 128 px (at least 512);
    ``$PARTSEG_WARP_TILE`` overrides it."""
    dflt = 4096 if big_ok else 2048
    if h > 128:
        dflt = max(512, dflt * 128 // h)
    return int(os.environ.get("PARTSEG_WARP_TILE", str(dflt)))


def band_config(dtype: torch.dtype, h: int, w: int) -> tuple[int, int]:
    """(kh, tile) of the band mode for an image of this dtype and size, from
    ``$PARTSEG_WARP_BAND``; kh = 0 means unbanded."""
    n = h * w
    tile = min(default_tile(big_ok=(dtype == torch.bfloat16), h=h), _round_up(n, 128))
    kh = int(os.environ.get("PARTSEG_WARP_BAND", "0"))
    kh = min(h, _round_up(kh, 8)) if kh else 0
    banded = 0 < kh < h and tile % w == 0 and _round_up(n, tile) == n
    return (kh, tile) if banded else (0, tile)


class Plan(NamedTuple):
    points: int     # points a CTA owns
    group: int      # images a CTA samples
    cluster: int    # CTAs per band tile (1: unbanded)
    grid_x: int
    grid_y: int
    smem: int       # dynamic shared memory, bytes
    chunk: int      # basis columns staged at a time (M: the whole basis at once)


def _row_stride(m: int) -> int:
    """The kernel's shared-memory row stride for M basis values: M rounded
    up to a multiple of 4 that is 4 mod 8 (16-byte rows on distinct banks)."""
    mp = _round_up(m, 4)
    return mp + 4 if mp % 8 == 0 else mp


def _smem_words(mp: int, points: int, group: int, banded: bool) -> int:
    """w [G, MP, 2] and one chunk of basis rows [run, MP] (MP the row stride
    of a chunk, G the mode's most images); the pixel indices [group, points]
    as float2; the per-warp minima [warps, G / subgroups]; the CTA's minima
    and band starts [2, G]."""
    threads, split, most = SHAPES[banded]
    return (2 * most * mp + threads // split * mp + 2 * group * points
            + threads // 32 * (most // split) + 2 * most)


def _wide_w_stride(m: int) -> int:
    """The wide path's w row in floats: 2·MW, MW = M rounded up to even and
    made 2 mod 4 (rows 4 mod 8 float4s apart)."""
    mw = _round_up(m, 2)
    return 2 * (mw + 2 if mw % 4 == 0 else mw)


def _wide_smem_words(m: int, points: int, group: int, banded: bool) -> int:
    """w [group, _wide_w_stride]; the ring [WIDE_STAGES, run, chunk + 4];
    the pixel indices [group, points] as float2; the CTA's minima and band
    starts [2, the mode's most images]."""
    run, most, chunk = WIDE_SHAPES[banded]
    return (group * _wide_w_stride(m) + WIDE_STAGES * run * (chunk + 4)
            + 2 * group * points + 2 * most)


@functools.lru_cache(maxsize=64)
def launch_plan(b: int, h: int, w: int, m: int, kh: int = 0, tile: int = 0) -> Plan:
    """The launch of ``csrc/tps_warp.cu`` for these sizes. Unbanded: runs of
    128 points, 8 images per CTA. Band mode: a tile spread over a cluster of
    min(MAX_CLUSTER, ⌈tile / 256⌉) CTAs, 4 images per CTA. The images per
    CTA halve while the shared memory exceeds the opt-in limit. Where the
    basis rows do not fit whole even at one image, the wide path: unbanded
    runs of 128 points and 16 images (chunks of 24 columns), band mode the
    same points and cluster and 8 images (chunks of 16); the images halve
    while they do not fit in half an SM (two CTAs to it), or, where even
    the most images miss it, in the opt-in limit."""
    banded = kh > 0
    threads, split, most = SHAPES[banded]
    run, n = threads // split, h * w
    if banded:
        cluster = min(MAX_CLUSTER, -(-tile // run))
        points = -(-tile // cluster)
        grid_x = n // tile * cluster
    else:
        cluster, points, grid_x = 1, run, -(-n // run)

    def fits(mp: int, group: int) -> bool:
        return 4 * _smem_words(mp, points, group, banded) <= SMEM_OPT_IN

    group = most
    while group > 1 and not fits(_row_stride(m), group):
        group //= 2
    if fits(_row_stride(m), group):
        return Plan(points, group, cluster, grid_x, -(-b // group),
                    4 * _smem_words(_row_stride(m), points, group, banded), m)
    run, most, chunk = WIDE_SHAPES[banded]
    if not banded:
        points, grid_x = run, -(-n // run)
    budget = SMEM_PER_SM // 2 - 1024
    if 4 * _wide_smem_words(m, points, most, banded) > budget:
        budget = SMEM_OPT_IN
    group = most
    while group > 1 and 4 * _wide_smem_words(m, points, group, banded) > budget:
        group //= 2
    return Plan(points, group, cluster, grid_x, -(-b // group),
                4 * _wide_smem_words(m, points, group, banded), chunk)


def tps_flow(weights: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """basis [N, M] · weights [B, M, 2] → coords [B, N, 2], f32."""
    return torch.einsum("nm,bmk->bnk", basis.float(), weights.float())


def kernel_order_flow(weights: torch.Tensor, basis: torch.Tensor):
    """The flow as the kernel sums it, the reference at wide bases (where
    two f32 orders of the dot differ by more than a sample's tolerance):
    per image and coordinate, fmaf over j = 0..M−1 in order from 0, each
    step an exact f64 product and sum rounded to f32 (an f32 FMA up to a
    double rounding, one ulp in about 2²⁹ steps). Returns the flow
    [B, N, 2] f32 and Σ_j |partial sum_j| [B, N, 2] f64."""
    b64, w64 = basis.double(), weights.double()
    acc = torch.zeros((weights.shape[0], basis.shape[0], 2), device=basis.device)
    path = torch.zeros_like(acc, dtype=torch.float64)
    for j in range(basis.shape[1]):
        acc = (acc.double() + b64[:, j][None, :, None] * w64[:, j][:, None, :]).float()
        path += acc.double().abs()
    return acc, path


def tps_warp_plain(image: torch.Tensor, weights: torch.Tensor, basis: torch.Tensor,
                   kh: int = 0, tile: int = 0) -> torch.Tensor:
    """The plain PyTorch version: [B, H, W, C] in the image dtype."""
    return tps_sample_plain(image, tps_flow(weights, basis), kh, tile)


def tps_sample_plain(image: torch.Tensor, coords: torch.Tensor, kh: int = 0,
                     tile: int = 0) -> torch.Tensor:
    """The sample half of the plain version, at a given flow [B, H·W, 2]."""
    b, h, w, c = image.shape
    if not kh:
        return gather_sample(image, coords).reshape(b, h, w, c)
    fy, fx = pixel_index(coords, h, w)
    y0 = torch.floor(fy).long()
    start = (y0.reshape(b, -1, tile).amin(-1).clamp(0, h - kh) // 8) * 8       # [B, tiles]
    lo = start.repeat_interleave(tile, dim=1)
    hi = lo + kh - 1
    y0c = torch.minimum(torch.maximum(y0, lo), hi)
    y1c = torch.minimum(torch.maximum(y0 + 1, lo), hi)
    out = gather_lerp(image, y0c, y1c, fy - torch.floor(fy), *axis_taps(fx, w))
    return out.reshape(b, h, w, c)


def _check(image, weights, basis) -> tuple[int, int, Plan]:
    """Raise on what the kernel does not take; else the call's (kh, tile,
    launch plan)."""
    if image.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tps_warp takes a float32 or bfloat16 image, got {image.dtype}")
    if weights.dtype != torch.float32 or basis.dtype != torch.float32:
        raise TypeError(f"tps_warp takes float32 weights and basis, got "
                        f"{weights.dtype}, {basis.dtype}")
    if image.dim() != 4 or image.numel() == 0:
        raise ValueError(f"tps_warp takes a non-empty [B, H, W, C] image, got {tuple(image.shape)}")
    b, h, w, _ = image.shape
    if weights.dim() != 3 or weights.shape[0] != b or weights.shape[2] != 2:
        raise ValueError(f"tps_warp takes [B, M, 2] weights for B = {b}, got {tuple(weights.shape)}")
    if tuple(basis.shape) != (h * w, weights.shape[1]):
        raise ValueError(f"tps_warp takes a [H·W, M] = [{h * w}, {weights.shape[1]}] basis, "
                         f"got {tuple(basis.shape)}")
    if not (image.is_contiguous() and weights.is_contiguous() and basis.is_contiguous()):
        raise ValueError("tps_warp takes a contiguous image, weights and basis")
    if not (image.device == weights.device == basis.device):
        raise ValueError("tps_warp inputs lie on different devices")
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tps_warp runs on CPU or CUDA, got {image.device}")
    if b > MAX_BATCH:
        raise ValueError(f"tps_warp takes at most {MAX_BATCH} images, got {b}")
    if h * w * image.shape[3] >= 2 ** 31:
        raise ValueError("tps_warp takes images of fewer than 2³¹ elements each")
    kh, tile = band_config(image.dtype, h, w)
    plan = launch_plan(b, h, w, weights.shape[1], kh, tile)
    if plan.smem > SMEM_OPT_IN:
        raise ValueError(f"tps_warp: {plan.points} points per CTA and M = {weights.shape[1]} "
                         f"need {plan.smem} bytes of shared memory, above {SMEM_OPT_IN}; "
                         "lower $PARTSEG_WARP_TILE or the TPS grid")
    return kh, tile, plan


def pad_columns(weights: torch.Tensor, basis: torch.Tensor, multiple: int = 4):
    """weights [B, M, 2] and basis [N, M] with zero columns appended up to a
    multiple of ``multiple`` (a new basis, 16-byte aligned): the flow
    basis @ weights is the same, each added term 0·0."""
    pad = -basis.shape[1] % multiple
    return (F.pad(weights, (0, 0, 0, pad)),
            F.pad(basis, (0, pad)) if pad else basis.clone(memory_format=torch.contiguous_format))


def _launch(image, weights, basis, kh: int, tile: int) -> torch.Tensor:
    b, h, w, c = image.shape
    out = torch.empty_like(image)
    _build.launch("partseg_tps_warp", image.device,
                  image.data_ptr(), int(image.dtype == torch.bfloat16), weights.data_ptr(),
                  basis.data_ptr(), out.data_ptr(), b, h, w, c, weights.shape[1], tile, kh)
    tps_warp.launches += 1
    return out


class _TPSWarp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, image, weights, basis, kh, tile):
        if image.device.type == "cpu":
            out = tps_warp_plain(image, weights, basis, kh, tile)
        else:
            out = _launch(image, weights, basis, kh, tile)
        ctx.save_for_backward(image, weights, basis)
        return out

    @staticmethod
    def backward(ctx, g):
        image, weights, basis = ctx.saved_tensors
        b, h, w, c = image.shape
        need_image, need_weights = ctx.needs_input_grad[:2]
        coords = tps_flow(weights, basis).contiguous()
        _, d_fy, d_fx = sample_with_grads(image, coords)
        d_image, d_coords = bilinear_sample_vjp(
            tuple(image.shape), image.dtype, coords, d_fy, d_fx, g.reshape(b, h * w, c),
            need_image, need_weights)
        d_weights = torch.einsum("nm,bnk->bmk", basis, d_coords) if need_weights else None
        return d_image, d_weights, None, None, None


def tps_warp(image: torch.Tensor, weights: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Warp image [B, H, W, C] (f32 or bf16) with TPS spline weights
    [B, M, 2] f32 over the static pixel basis [H·W, M] f32
    (``TPSSampler.flow_basis``) → [B, H, W, C] in the image dtype.
    Differentiable in the image and the weights."""
    kh, tile, plan = _check(image, weights, basis)
    m = weights.shape[1]
    if image.is_cuda and plan.chunk < m and (m % 4 or basis.data_ptr() % 16):
        weights, basis = pad_columns(weights, basis)   # the wide path reads 16-byte rows
    return _TPSWarp.apply(image, weights, basis, kh, tile)


tps_warp.launches = 0
