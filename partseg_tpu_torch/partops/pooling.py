"""Per-part appearance pooling: a_k = Σ_u p_k(u)·f(u) / Σ_u p_k(u)."""

from __future__ import annotations

import torch


def pool_appearance(feats: torch.Tensor, parts: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """feats [B, H, W, C], parts [B, H, W, K] nonnegative → [B, K, C] f32."""
    if feats.dim() != 4 or parts.dim() != 4 or feats.shape[:3] != parts.shape[:3]:
        raise ValueError(
            f"expected [B, H, W, C] feats and [B, H, W, K] parts with the same "
            f"B, H, W; got {tuple(feats.shape)} and {tuple(parts.shape)}"
        )
    b, h, w, c = feats.shape
    k = parts.shape[-1]
    f = feats.float().reshape(b, h * w, c)
    p = parts.float().reshape(b, h * w, k)
    num = torch.bmm(p.transpose(1, 2), f)                        # [B, K, C]
    den = p.sum(dim=1).unsqueeze(-1)                             # [B, K, 1]
    return num / (den + eps)
