"""Fused Gaussian render + decoder-input assembly.

Replaces the Pallas TPU kernel ``partseg_tpu/partops/pallas/render_assemble.py``
(``render_assemble``). The CUDA kernel (``csrc/render_assemble.cu``)
computes out[b, u, c] = Σ_k φ_k(u)·a[b, k, c] without writing the
[B, H, W, K] blob tensor, summing in f32 whatever the appearance dtype.

``render_assemble`` is an autograd Function. Its forward launches the
kernel on a CUDA tensor (or raises) and runs the plain version
(``render_gaussians(..., precision=lam)`` + ``assemble_decoder_input`` in
f32) on a CPU tensor. Its backward is the JAX ``custom_vjp``'s (``_bwd``)
in plain PyTorch, the same code on both devices: it recomputes φ, and
puts the whole off-diagonal Λ cotangent on ``[..., 0, 1]`` because the
forward reads only that entry (doubled).
"""

from __future__ import annotations

import ctypes

import torch

from partseg_tpu_torch.partops.assembly import assemble_decoder_input
from partseg_tpu_torch.partops.coords import coord_grid
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


def _launch(mu, lam, app, h, w, kernel):
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


def render_assemble_vjp(mu, lam, app, h: int, w: int, kernel: str, g):
    """(d_mu, d_lam, d_app) from the output cotangent g [B, h, w, C]."""
    b, k, c = app.shape
    gf = g.reshape(b, h * w, c).float()
    yy, xx = coord_grid(h, w, device=mu.device)
    u = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1)           # [HW, 2]
    diff = u[None, :, None, :] - mu[:, None, :, :].float()              # [B, HW, K, 2]
    lamf = lam.float()
    d = torch.clamp(torch.einsum("bnki,bkij,bnkj->bnk", diff, lamf, diff), min=0.0)
    if kernel == "gauss":
        phi = torch.exp(-0.5 * d)
        dphi_dd = -0.5 * phi
    else:
        phi = 1.0 / (1.0 + d)
        dphi_dd = -(phi * phi)
    d_app = torch.einsum("bnk,bnc->bkc", phi, gf)
    g_d = torch.einsum("bnc,bkc->bnk", gf, app.float()) * dphi_dd
    # d = diffᵀ Λ diff:  ∂d/∂μ = −2 Λ diff;  ∂d/∂Λ = diff diffᵀ.
    d_mu = torch.einsum("bnk,bkij,bnkj->bki", g_d, -2.0 * lamf, diff)
    d_sym = torch.einsum("bnk,bnki,bnkj->bkij", g_d, diff, diff)
    zero = torch.zeros_like(d_sym[..., 0, 0])
    d_lam = torch.stack([
        torch.stack([d_sym[..., 0, 0], d_sym[..., 0, 1] + d_sym[..., 1, 0]], dim=-1),
        torch.stack([zero, d_sym[..., 1, 1]], dim=-1),
    ], dim=-2)
    return d_mu.to(mu.dtype), d_lam.to(lam.dtype), d_app.to(app.dtype)


class _RenderAssemble(torch.autograd.Function):

    @staticmethod
    def forward(ctx, mu, lam, app, h, w, kernel):
        if app.device.type == "cpu":
            out = render_assemble_plain(mu, lam, app, h, w, kernel)
        else:
            out = _launch(mu, lam, app, h, w, kernel)
        ctx.save_for_backward(mu, lam, app)
        ctx.shape = (h, w, kernel)
        return out

    @staticmethod
    def backward(ctx, g):
        mu, lam, app = ctx.saved_tensors
        return (*render_assemble_vjp(mu, lam, app, *ctx.shape, g), None, None, None)


def render_assemble(mu: torch.Tensor, lam: torch.Tensor, app: torch.Tensor,
                    h: int, w: int, kernel: str = "gauss") -> torch.Tensor:
    """mu [B, K, 2] f32, lam [B, K, 2, 2] f32 (precision Σ⁻¹), app [B, K, C]
    f32 or bf16 → [B, h, w, C] f32. Differentiable in mu, lam and app."""
    _check(mu, lam, app, h, w, kernel)
    if app.device.type not in ("cpu", "cuda"):
        raise ValueError(f"render_assemble runs on CPU or CUDA, got {app.device}")
    return _RenderAssemble.apply(mu, lam, app, h, w, kernel)


render_assemble.launches = 0
