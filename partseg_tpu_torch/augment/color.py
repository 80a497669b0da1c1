"""On-device colour jitter (brightness, contrast, saturation, hue), twin
of partseg_tpu/augment/color.py. Hue rotates the IQ chroma plane of YIQ
space (one 3×3 linear map per sample)."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from partseg_tpu_torch.partops.coords import as_device_tensor

# RGB <-> YIQ (NTSC) matrices; the exact inverse, so hue = 0 is the identity.
_RGB2YIQ = np.asarray(
    [[0.299, 0.587, 0.114], [0.5959, -0.2746, -0.3213], [0.2115, -0.5227, 0.3112]],
    np.float32,
)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The colour matrices on ``device``, copied there once."""
    return tuple(as_device_tensor(a, device) for a in (_RGB2YIQ, _YIQ2RGB, _LUMA))


@dataclasses.dataclass(frozen=True)
class ColorParams:
    brightness: torch.Tensor  # [...]: additive shift
    contrast: torch.Tensor    # [...]: multiplicative around the mean
    saturation: torch.Tensor  # [...]: lerp factor against grayscale
    hue: torch.Tensor         # [...]: rotation angle (radians)


def color_from_uniforms(u: torch.Tensor, brightness: float = 0.1, contrast: float = 0.3,
                        saturation: float = 0.3, hue: float = 0.3) -> ColorParams:
    """The jitter parameters of uniforms u [..., 4] in [0, 1)."""
    def scaled(i, lo, hi):
        return u[..., i] * (hi - lo) + lo

    return ColorParams(
        brightness=scaled(0, -brightness, brightness),
        contrast=scaled(1, 1.0 - contrast, 1.0 + contrast),
        saturation=scaled(2, 1.0 - saturation, 1.0 + saturation),
        hue=scaled(3, -hue, hue),
    )


def color_jitter(image: torch.Tensor, params: ColorParams) -> torch.Tensor:
    """image [B, H, W, 3] in [0, 1]; params with leading dims [B]. Computed
    in f32, returned in the image dtype."""
    rgb2yiq, yiq2rgb, luma = _consts(image.device)
    x = image.float()
    b = params.brightness[..., None, None, None]
    c = params.contrast[..., None, None, None]
    s = params.saturation[..., None, None, None]

    # Hue: rotate the IQ chroma plane by the sampled angle.
    cos, sin = torch.cos(params.hue), torch.sin(params.hue)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    rot = torch.stack([
        torch.stack([ones, zeros, zeros], -1),
        torch.stack([zeros, cos, -sin], -1),
        torch.stack([zeros, sin, cos], -1),
    ], -2)                                                       # [..., 3, 3]
    hue_mat = yiq2rgb @ rot @ rgb2yiq
    x = torch.einsum("...hwc,...dc->...hwd", x, hue_mat)

    # Saturation: lerp toward per-pixel luma.
    gray = torch.einsum("...hwc,c->...hw", x, luma)[..., None]
    x = gray + (x - gray) * s
    # Contrast: scale around the per-image mean luma.
    mean = gray.mean(dim=(-3, -2, -1), keepdim=True)
    x = mean + (x - mean) * c
    # Brightness.
    x = x + b
    return torch.clamp(x, 0.0, 1.0).to(image.dtype)
