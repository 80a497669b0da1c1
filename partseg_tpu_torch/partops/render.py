"""Gaussian part rendering: (μ, Σ) → blob maps on an H×W grid.

    d_k(u) = (u − μ_k)ᵀ Λ_k (u − μ_k),  Λ = (Σ + eps I)⁻¹
    φ_k(u) = exp(−½ d_k(u))     kernel="gauss"
    φ_k(u) = 1 / (1 + d_k(u))   kernel="heavy_tail"

with the quadratic form expanded as d = Λ00·dy² + 2Λ01·dy·dx + Λ11·dx².
"""

from __future__ import annotations

import torch

from partseg_tpu_torch.partops.coords import coord_grid
from partseg_tpu_torch.partops.moments import precision_from_cov

RENDER_KERNELS = ("gauss", "heavy_tail")


def render_gaussians(
    mu: torch.Tensor,
    sigma: torch.Tensor | None,
    h: int,
    w: int,
    kernel: str = "gauss",
    eps: float = 1e-4,
    precision: torch.Tensor | None = None,
) -> torch.Tensor:
    """mu [B, K, 2], sigma [B, K, 2, 2] (ignored if ``precision`` is given)
    → [B, H, W, K] f32 blob maps in [0, 1].

    The JAX function's ``dtype`` argument is left out: the port renders
    in f32 everywhere, as the JAX ``render_assemble`` kernel does."""
    if kernel not in RENDER_KERNELS:
        raise ValueError(f"unknown render kernel: {kernel!r}")
    lam = precision_from_cov(sigma, eps) if precision is None else precision.float()
    yy, xx = coord_grid(h, w, device=mu.device)                  # [H, W]
    muf = mu.float()
    dy = yy[None, :, :, None] - muf[:, None, None, :, 0]          # [B, H, W, K]
    dx = xx[None, :, :, None] - muf[:, None, None, :, 1]
    l00 = lam[:, None, None, :, 0, 0]
    l01 = lam[:, None, None, :, 0, 1]
    l11 = lam[:, None, None, :, 1, 1]
    # d ≥ 0 for SPD Λ; the clamp guards numerically indefinite Λ
    # (exp(−½·negative) would explode).
    d = torch.clamp(l00 * dy * dy + 2.0 * l01 * dy * dx + l11 * dx * dx, min=0.0)
    phi = torch.exp(-0.5 * d) if kernel == "gauss" else 1.0 / (1.0 + d)
    return phi
