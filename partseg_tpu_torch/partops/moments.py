"""Soft-argmax μ/Σ extraction from normalized part maps, all in f32.

    μ_k = Σ_u u · p_k(u)                       (u = (y, x) ∈ [-1, 1]²)
    Σ_k = Σ_u p_k(u) (u − μ_k)(u − μ_k)ᵀ = E[uuᵀ] − μμᵀ

One product against the [H*W, 5] monomial basis gives all raw moments.
Covariance inversion in bf16 is numerically unsafe, so nothing here
leaves f32.
"""

from __future__ import annotations

import torch

from partseg_tpu_torch.partops.coords import moment_basis


def soft_argmax_moments(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """p [B, H, W, K] per-part spatial distributions →
    (mu [B, K, 2] f32 (y, x), sigma [B, K, 2, 2] f32)."""
    if p.dim() != 4:
        raise ValueError(f"expected [B, H, W, K] part maps, got {tuple(p.shape)}")
    b, h, w, k = p.shape
    basis = moment_basis(h, w, device=p.device)                  # [HW, 5]
    pf = p.float().reshape(b, h * w, k)
    raw = torch.einsum("bnk,nm->bkm", pf, basis)                 # [B, K, 5]
    return moments_from_raw(raw)


def moments_from_raw(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(μ, Σ) from raw moments [..., 5] = (E[y], E[x], E[y²], E[yx], E[x²])."""
    ey, ex, eyy, eyx, exx = raw.unbind(-1)
    mu = torch.stack([ey, ex], dim=-1)
    cyy = eyy - ey * ey
    cyx = eyx - ey * ex
    cxx = exx - ex * ex
    sigma = torch.stack(
        [torch.stack([cyy, cyx], dim=-1), torch.stack([cyx, cxx], dim=-1)], dim=-2
    )
    return mu, sigma


def precision_from_cov(sigma: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Closed-form 2×2 inverse of Σ + eps·I, [..., 2, 2] f32.

    eps floors the blob std at 0.01; the det floor eps² keeps a
    numerically indefinite Σ from flipping the precision's sign.
    """
    s = sigma.float()
    a = s[..., 0, 0] + eps
    bq = s[..., 0, 1]
    d = s[..., 1, 1] + eps
    det = torch.clamp(a * d - bq * bq, min=eps * eps)
    inv_det = 1.0 / det
    row0 = torch.stack([d * inv_det, -bq * inv_det], dim=-1)
    row1 = torch.stack([-bq * inv_det, a * inv_det], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def chol2x2(sigma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Closed-form lower Cholesky factor of Σ + eps·I, [..., 2, 2] f32."""
    s = sigma.float()
    a = s[..., 0, 0] + eps
    bq = s[..., 0, 1]
    d = s[..., 1, 1] + eps
    l00 = torch.sqrt(a)
    l10 = bq / l00
    l11 = torch.sqrt(torch.clamp(d - l10 * l10, min=eps))
    zero = torch.zeros_like(l00)
    row0 = torch.stack([l00, zero], dim=-1)
    row1 = torch.stack([l10, l11], dim=-1)
    return torch.stack([row0, row1], dim=-2)
