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
"""

from __future__ import annotations

import os

import torch

from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.kernels.bilinear_sample import (
    bilinear_sample_vjp,
    sample_with_grads,
)
from partseg_tpu_torch.partops.warp import axis_taps, gather_lerp, gather_sample, pixel_index

MAX_BATCH = 65535                 # gridDim.y
SMEM_LIMIT = 48 * 1024            # the kernel's [M, 2] f32 weights in shared memory


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


def tps_flow(weights: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """basis [N, M] · weights [B, M, 2] → coords [B, N, 2], f32."""
    return torch.einsum("nm,bmk->bnk", basis.float(), weights.float())


def tps_warp_plain(image: torch.Tensor, weights: torch.Tensor, basis: torch.Tensor,
                   kh: int = 0, tile: int = 0) -> torch.Tensor:
    """The plain PyTorch version: [B, H, W, C] in the image dtype."""
    b, h, w, c = image.shape
    coords = tps_flow(weights, basis)
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


def _check(image, weights, basis) -> None:
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
    if 2 * weights.shape[1] * 4 > SMEM_LIMIT:
        raise ValueError(f"tps_warp: M = {weights.shape[1]} exceeds the kernel's shared memory")


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
    def forward(ctx, image, weights, basis):
        kh, tile = band_config(image.dtype, image.shape[1], image.shape[2])
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
        return d_image, d_weights, None


def tps_warp(image: torch.Tensor, weights: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Warp image [B, H, W, C] (f32 or bf16) with TPS spline weights
    [B, M, 2] f32 over the static pixel basis [H·W, M] f32
    (``TPSSampler.flow_basis``) → [B, H, W, C] in the image dtype.
    Differentiable in the image and the weights."""
    _check(image, weights, basis)
    return _TPSWarp.apply(image, weights, basis)


tps_warp.launches = 0
