"""Decoder input assembly: Σ_k φ_k(u) ⊗ a_k, one batched [B,HW,K] @ [B,K,C]
product (no [B, H, W, K, C] tensor)."""

from __future__ import annotations

import torch


def assemble_decoder_input(blobs: torch.Tensor, appearance: torch.Tensor) -> torch.Tensor:
    """blobs [B, H, W, K], appearance [B, K, C] → [B, H, W, C].

    The product runs in the blobs' dtype; the result takes the
    appearance's dtype, as in the JAX package.
    """
    b, h, w, k = blobs.shape
    c = appearance.shape[-1]
    out = torch.bmm(blobs.reshape(b, h * w, k), appearance.to(blobs.dtype))
    return out.reshape(b, h, w, c).to(appearance.dtype)
