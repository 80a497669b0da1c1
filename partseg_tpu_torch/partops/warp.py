"""Bilinear image resampling, twin of partseg_tpu/partops/warp.py.

The backward warp is a flat gather of the four neighbour pixels and a
lerp (the "gather" path, which is also the plain version of the
``bilinear_sample`` CUDA kernel); ``impl="fused"`` goes through that
kernel's wrapper. Gradients reach both the image and the coordinates.

Coordinates follow coords.py: (y, x) pixel-centre normalised to [-1, 1],
align_corners=False. Out-of-range samples clamp to the border
(padding_mode="border") or fade to zero ("zeros").
"""

from __future__ import annotations

import torch


def pixel_index(coords: torch.Tensor, h: int, w: int):
    """Normalised coords [..., 2] → continuous pixel indices (fy, fx), f32."""
    cf = coords.float()
    return (cf[..., 0] + 1.0) * (0.5 * h) - 0.5, (cf[..., 1] + 1.0) * (0.5 * w) - 0.5


def axis_taps(f: torch.Tensor, n: int):
    """Border-clamped taps (i0, i1) (int64) of pixel indices f along an
    axis of n pixels, and the lerp weight f − floor(f)."""
    f0 = torch.floor(f)
    i = f0.long()
    return i.clamp(0, n - 1), (i + 1).clamp(0, n - 1), f - f0


def gather_sample(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The gather path, border padding: [B, N, C] in the image dtype, the
    lerp in the image dtype as the JAX gather path does it."""
    _, h, w, _ = image.shape
    fy, fx = pixel_index(coords, h, w)
    return gather_lerp(image, *axis_taps(fy, h), *axis_taps(fx, w))


def gather_lerp(image, y0, y1, wy, x0, x1, wx) -> torch.Tensor:
    """Lerp of the taps (y0|y1, x0|x1) [B, N] with weights wy, wx [B, N]."""
    b, h, w, c = image.shape
    flat = image.reshape(b, h * w, c)

    def take(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi)[..., None].expand(-1, -1, c))

    v00, v01, v10, v11 = take(y0, x0), take(y0, x1), take(y1, x0), take(y1, x1)
    wyf = wy[..., None].to(flat.dtype)
    wxf = wx[..., None].to(flat.dtype)
    top = v00 + (v01 - v00) * wxf
    bot = v10 + (v11 - v10) * wxf
    return top + (bot - top) * wyf


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor,
                    padding_mode: str = "border", impl: str = "auto") -> torch.Tensor:
    """Sample ``image`` [B, H, W, C] at normalised ``coords`` [B, N, 2] (y, x)
    → [B, N, C] in the image dtype.

    impl: "auto" (the kernel on a CUDA tensor, the gather path elsewhere),
    "fused" (the kernel's wrapper, which runs the gather path on a CPU
    tensor), or "gather"."""
    if impl == "auto":
        impl = "fused" if image.device.type == "cuda" else "gather"
    if impl == "fused":
        from partseg_tpu_torch.partops.kernels.bilinear_sample import bilinear_sample_fused

        out = bilinear_sample_fused(image, coords)
    elif impl == "gather":
        out = gather_sample(image, coords)
    else:
        raise ValueError(f"unknown bilinear_sample impl: {impl!r}")
    if padding_mode == "zeros":
        out = out * _zeros_fade(image.shape, coords).to(out.dtype)
    elif padding_mode != "border":
        raise ValueError(f"unknown padding_mode: {padding_mode!r}")
    return out


def _zeros_fade(image_shape, coords: torch.Tensor) -> torch.Tensor:
    """[B, N, 1] multiplier implementing padding_mode="zeros": linear fade
    to 0 at the image border (a function of the coords only, shared by the
    gather and fused paths)."""
    _, h, w, _ = image_shape
    fy, fx = pixel_index(coords, h, w)
    inside = (fy >= -1.0) & (fy <= h + 0.0) & (fx >= -1.0) & (fx <= w + 0.0)
    iy = torch.clamp(torch.minimum(fy + 1.0, h - fy), 0.0, 1.0)
    ix = torch.clamp(torch.minimum(fx + 1.0, w - fx), 0.0, 1.0)
    return (inside.float() * iy * ix)[..., None]


def warp_image(image: torch.Tensor, flow_coords: torch.Tensor,
               padding_mode: str = "border", impl: str = "auto") -> torch.Tensor:
    """Backward-warp ``image`` [B, H, W, C] with a dense coordinate field
    ``flow_coords`` [B, Ho, Wo, 2] → [B, Ho, Wo, C]."""
    b, ho, wo, _ = flow_coords.shape
    out = bilinear_sample(image, flow_coords.reshape(b, ho * wo, 2).contiguous(),
                          padding_mode, impl)
    return out.reshape(b, ho, wo, image.shape[-1])
