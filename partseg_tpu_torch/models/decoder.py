"""Image decoder, twin of partseg_tpu/models/decoder.py: (μ, Σ, appearance
vectors) → RGB reconstruction through a progressive 2×-upsampling CNN,
with the part blobs re-rendered and assembled at every scale.

Every scale goes through the ``render_assemble`` kernel wrapper, which
sums Σ_k φ_k ⊗ a_k in f32 — the JAX package's ``use_pallas=True``
numerics. (Its ``use_pallas=False`` path rounds the blobs to the compute
dtype before the sum; at bf16 the two differ by that rounding.)
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from partseg_tpu_torch.models.blocks import Conv2d, Linear, ResBlock, upsample2x
from partseg_tpu_torch.models.encoders import to_nchw, to_nhwc
from partseg_tpu_torch.partops.kernels import render_assemble
from partseg_tpu_torch.partops.moments import precision_from_cov


class Decoder(nn.Module):
    """Decode at ``out_size`` from ``n_scales`` progressively rendered scales.

    Scale i runs at out_size / 2**(n_scales-1-i) with width
    ``features[i]`` (an int means the same width everywhere).
    """

    def __init__(self, app_features: int, out_size: int = 128, n_scales: int = 4,
                 features: int | Sequence[int] = (256, 128, 64, 32),
                 render_kernel: str = "gauss", norm: str = "block",
                 act_quant: str = "none", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_size = out_size
        self.n_scales = n_scales
        self.render_kernel = render_kernel
        self.dtype = dtype
        widths = [self._feat(features, i) for i in range(n_scales)]
        self.widths = widths
        # Each scale projects the appearance vectors to its own width
        # before the assembly (the JAX Decoder's app_proj, which its
        # PartNet always leaves on).
        self.app_proj = nn.ModuleList(Linear(app_features, f, dtype) for f in widths)
        blocks = []
        prev = 0
        for i, f in enumerate(widths):
            cin = f if i == 0 else prev + f
            blocks += [ResBlock(cin, f, norm, act_quant, dtype),
                       ResBlock(f, f, norm, act_quant, dtype)]
            prev = f
        self.blocks = nn.ModuleList(blocks)
        self.to_rgb = Conv2d(widths[-1], 3, 1, dtype=torch.float32)

    @staticmethod
    def _feat(features, i: int) -> int:
        if isinstance(features, int):
            return features
        return features[min(i, len(features) - 1)]

    def forward(self, mu: torch.Tensor, sigma: torch.Tensor,
                appearance: torch.Tensor) -> torch.Tensor:
        """mu [B,K,2], sigma [B,K,2,2], appearance [B,K,C] → [B,S,S,3] in [0,1]."""
        lam = precision_from_cov(sigma).contiguous()
        mu = mu.float().contiguous()
        app = appearance.to(self.dtype)
        x = None
        for i in range(self.n_scales):
            res = self.out_size // (2 ** (self.n_scales - 1 - i))
            a_i = self.app_proj[i](app)
            feat = render_assemble(mu, lam, a_i.contiguous(), res, res, self.render_kernel)
            feat = to_nchw(feat.to(self.dtype))
            x = feat if x is None else torch.cat([upsample2x(x), feat], dim=1)
            x = self.blocks[2 * i + 1](self.blocks[2 * i](x))
        rgb = self.to_rgb(x)
        return to_nhwc(torch.sigmoid(rgb))
