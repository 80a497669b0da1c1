"""Fused per-part spatial softmax + soft-argmax moments.

Replaces the Pallas TPU kernel ``partseg_tpu/partops/pallas/softmax_moments.py``
(``softmax_moments``). The CUDA kernel (``csrc/softmax_moments.cu``) reads
the f32 logits once per pass and writes the part distributions and the
raw moments (E[y], E[x], E[y²], E[yx], E[x²]) per (b, k); μ and Σ are
formed here with the same raw-moment formula as ``moments_from_raw``.

On a CPU tensor the wrapper runs the plain version
(``spatial_softmax`` + ``soft_argmax_moments``); on a CUDA tensor it
launches the kernel or raises. Forward only: the backward comes with the
training slice.
"""

from __future__ import annotations

import ctypes

import torch

from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.moments import moments_from_raw, soft_argmax_moments
from partseg_tpu_torch.partops.softmax import spatial_softmax

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def softmax_moments_plain(logits: torch.Tensor):
    """The plain PyTorch version: (parts, mu, sigma), all f32."""
    parts = spatial_softmax(logits)
    mu, sigma = soft_argmax_moments(parts)
    return parts, mu, sigma


def _check(logits: torch.Tensor) -> int:
    """Validate what the kernel takes; return the pixel stride ``ld``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"softmax_moments takes float32 logits, got {logits.dtype}")
    if logits.dim() != 4 or logits.numel() == 0:
        raise ValueError(
            f"softmax_moments takes non-empty [B, H, W, K] logits, got {tuple(logits.shape)}"
        )
    b, h, w, k = logits.shape
    ld = logits.stride(2)
    # Pixels may be strided (the foreground slice of [B, H, W, K+1] logits),
    # but the K parts of a pixel are adjacent and pixels are evenly spaced.
    if logits.stride(3) != 1 or ld < k or logits.stride(1) != w * ld or (
        b > 1 and logits.stride(0) != h * w * ld
    ):
        raise ValueError(
            "softmax_moments takes logits laid out as [B, H, W, ld] with the parts "
            f"first in each pixel; got shape {tuple(logits.shape)}, strides {logits.stride()}"
        )
    return ld


def softmax_moments(logits: torch.Tensor):
    """logits [B, H, W, K] f32 → (parts [B, H, W, K] f32, mu [B, K, 2] f32,
    sigma [B, K, 2, 2] f32); the same numbers as spatial_softmax +
    soft_argmax_moments up to the order of the f32 sums."""
    ld = _check(logits)
    if logits.device.type == "cpu":
        return softmax_moments_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"softmax_moments runs on CPU or CUDA, got {logits.device}")
    b, h, w, k = logits.shape
    parts = torch.empty((b, h, w, k), device=logits.device, dtype=torch.float32)
    raw = torch.empty((b, k, 5), device=logits.device, dtype=torch.float32)
    fn = _build.library().partseg_softmax_moments_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(logits.device):
        err = fn(logits.data_ptr(), parts.data_ptr(), raw.data_ptr(), b, h, w, k, ld,
                 _build.stream_handle(logits.device))
    _build.check_launch(err, "softmax_moments")
    softmax_moments.launches += 1
    mu, sigma = moments_from_raw(raw)
    return parts, mu, sigma


softmax_moments.launches = 0
