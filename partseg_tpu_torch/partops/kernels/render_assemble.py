"""Fused Gaussian render + decoder-input assembly.

Replaces the Pallas TPU kernel ``partseg_tpu/partops/pallas/render_assemble.py``
(``render_assemble``). The CUDA kernel (``csrc/render_assemble.cu``)
computes out[b, u, c] = Σ_k φ_k(u)·a[b, k, c] without writing the
[B, H, W, K] blob tensor, summing in f32 whatever the appearance dtype.

On a CPU tensor the wrapper runs the plain version
(``render_gaussians(..., precision=lam)`` + ``assemble_decoder_input`` in
f32); on a CUDA tensor it launches the kernel or raises. Forward only:
the backward comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from partseg_tpu_torch.partops.assembly import assemble_decoder_input
from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.render import RENDER_KERNELS, render_gaussians

MAX_PARTS = 32           # kMaxParts in csrc/render_assemble.cu
TILE = 64                # kTile: output pixels per block
SMEM_LIMIT = 48 * 1024   # shared memory a block gets without an opt-in attribute
STATIC_SMEM = 5 * MAX_PARTS * 4   # the kernel's static per-part parameters
MAX_BATCH = 65535        # gridDim.y

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def render_assemble_plain(mu, lam, app, h: int, w: int, kernel: str = "gauss"):
    """The plain PyTorch version, [B, h, w, C] f32."""
    blobs = render_gaussians(mu, None, h, w, kernel=kernel, precision=lam)
    return assemble_decoder_input(blobs, app.float())


def _check(mu, lam, app, h, w, kernel) -> None:
    if kernel not in RENDER_KERNELS:
        raise ValueError(f"unknown render kernel: {kernel!r}")
    if mu.dtype != torch.float32 or lam.dtype != torch.float32:
        raise TypeError(f"render_assemble takes float32 mu and lam, got {mu.dtype}, {lam.dtype}")
    if app.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"render_assemble takes float32 or bfloat16 appearance, got {app.dtype}")
    if app.dim() != 3 or app.numel() == 0 or h <= 0 or w <= 0:
        raise ValueError(f"render_assemble takes non-empty [B, K, C] appearance, got {tuple(app.shape)}")
    b, k, c = app.shape
    if tuple(mu.shape) != (b, k, 2) or tuple(lam.shape) != (b, k, 2, 2):
        raise ValueError(
            f"render_assemble shapes disagree: mu {tuple(mu.shape)}, lam {tuple(lam.shape)}, "
            f"app {tuple(app.shape)}"
        )
    if not (mu.is_contiguous() and lam.is_contiguous() and app.is_contiguous()):
        raise ValueError("render_assemble takes contiguous mu, lam and appearance")
    if not (mu.device == lam.device == app.device):
        raise ValueError("render_assemble inputs lie on different devices")
    if k > MAX_PARTS:
        raise ValueError(f"render_assemble takes at most {MAX_PARTS} parts, got {k}")
    if (k * c + TILE * k) * 4 + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"render_assemble: K·C = {k}·{c} exceeds the kernel's shared memory")
    if b > MAX_BATCH:
        raise ValueError(f"render_assemble takes at most {MAX_BATCH} images, got {b}")


def render_assemble(mu: torch.Tensor, lam: torch.Tensor, app: torch.Tensor,
                    h: int, w: int, kernel: str = "gauss") -> torch.Tensor:
    """mu [B, K, 2] f32, lam [B, K, 2, 2] f32 (precision Σ⁻¹), app [B, K, C]
    f32 or bf16 → [B, h, w, C] f32."""
    _check(mu, lam, app, h, w, kernel)
    if app.device.type == "cpu":
        return render_assemble_plain(mu, lam, app, h, w, kernel)
    if app.device.type != "cuda":
        raise ValueError(f"render_assemble runs on CPU or CUDA, got {app.device}")
    b, k, c = app.shape
    out = torch.empty((b, h, w, c), device=app.device, dtype=torch.float32)
    fn = _build.library().partseg_render_assemble
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(app.device):
        err = fn(mu.data_ptr(), lam.data_ptr(), app.data_ptr(),
                 int(app.dtype == torch.bfloat16), out.data_ptr(), b, k, c, h, w,
                 int(kernel == "gauss"), _build.stream_handle(app.device))
    _build.check_launch(err, "render_assemble")
    render_assemble.launches += 1
    return out


render_assemble.launches = 0
