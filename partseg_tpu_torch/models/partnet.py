"""PartNet, twin of partseg_tpu/models/partnet.py: the full disentangling
model.

  shape stream on x_a: logits_a → spatial part distributions → (μ_a, Σ_a)
  shape stream on x_s: part masks for pooling
  appearance stream on x_s: features f; a_k = pool(f, masks_s)
  reconstruction: Decoder(render(μ_a, Σ_a) ⊗ a) ≈ x

Serving uses the components (``encode_shape``, ``shape_stats``,
``segmentation``, ``encode_appearance``, ``decode``); ``forward`` is the
whole training-time forward. Each call of an encoder or the decoder runs
in its span (``partnet.shape_encoder``, ``partnet.appearance_encoder``,
``partnet.decoder``; ``tracing``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from partseg_tpu_torch.device import default_device
from partseg_tpu_torch.models.decoder import Decoder
from partseg_tpu_torch.models.encoders import AppearanceEncoder, ShapeEncoder
from partseg_tpu_torch.partops.kernels import softmax_moments
from partseg_tpu_torch.partops.moments import soft_argmax_moments
from partseg_tpu_torch.partops.pooling import pool_appearance
from partseg_tpu_torch.partops.softmax import normalize_maps, part_softmax
from partseg_tpu_torch.tracing import span


@dataclasses.dataclass(frozen=True)
class PartNetConfig:
    """Static model hyperparameters; the same fields and defaults as the
    JAX package's ``PartNetConfig`` (``dtype`` is a torch dtype here)."""

    n_parts: int = 10
    img_size: int = 128
    background: bool = True          # extra background channel in part softmax
    features: int = 128              # hourglass width
    depth: int = 4                   # hourglass depth (map_size / 2**depth ≥ 1)
    n_stacks: int = 1                # stacked hourglasses in the shape encoder
    app_features: int = 128          # appearance vector dim C
    stem_stride: int = 2             # space-to-depth factor of the stem
    head_upsample: bool = False      # 2× upsample before both encoders' heads
    decoder_scales: int = 4
    decoder_features: Any = (256, 128, 64, 32)  # channel pyramid coarse→fine
    decoder_out_size: Any = None     # reconstruction size; None = img_size
    render_kernel: str = "gauss"     # "gauss" | "heavy_tail"
    spatial_norm: str = "softmax"    # "softmax" | "divide"
    pool_masks: str = "pixel"        # "pixel" | "spatial"
    # Kept for parity with the JAX config. Both JAX settings compute the
    # same function; the port always goes through its kernel wrappers.
    use_pallas: bool = False
    remat: bool = False              # recompute the hourglasses in the backward (training memory)
    norm: str = "block"              # ResBlock norm: "block" | "group" | "none"
    act_quant: str = "none"          # "none" | "f8" ResBlock output rounding
    dtype: Any = torch.bfloat16

    @property
    def map_size(self) -> int:
        s = self.img_size // self.stem_stride
        return s * 2 if self.head_upsample else s


@dataclasses.dataclass
class PartNetOutputs:
    recon: torch.Tensor        # [B, S, S, 3] reconstruction of x
    logits_a: torch.Tensor     # [B, S/2, S/2, K(+1)] shape logits on x_a
    logits_s: torch.Tensor     # same, on x_s
    parts_a: torch.Tensor      # [B, S/2, S/2, K] spatial distributions (x_a)
    parts_s: torch.Tensor      # [B, S/2, S/2, K] spatial distributions (x_s)
    seg_a: torch.Tensor        # [B, S/2, S/2, K(+1)] per-pixel part softmax (x_a)
    mu_a: torch.Tensor         # [B, K, 2]
    sigma_a: torch.Tensor      # [B, K, 2, 2]
    mu_s: torch.Tensor         # [B, K, 2]
    sigma_s: torch.Tensor      # [B, K, 2, 2]
    appearance: torch.Tensor   # [B, K, C] pooled from x_s


class PartNet(nn.Module):
    """The model, built on ``device`` (the CUDA card unless given; see
    ``default_device``). Images and maps are NHWC at every method."""

    def __init__(self, cfg: PartNetConfig, device: str | torch.device | None = None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.shape_enc = ShapeEncoder(
            n_parts=c.n_parts, background=c.background, depth=c.depth,
            features=c.features, n_stacks=c.n_stacks, norm=c.norm,
            stem_stride=c.stem_stride, head_upsample=c.head_upsample,
            act_quant=c.act_quant, remat=c.remat, dtype=c.dtype,
        )
        self.app_enc = AppearanceEncoder(
            out_features=c.app_features, depth=c.depth, features=c.features,
            norm=c.norm, stem_stride=c.stem_stride, head_upsample=c.head_upsample,
            act_quant=c.act_quant, remat=c.remat, dtype=c.dtype,
        )
        self.decoder = Decoder(
            app_features=c.app_features, out_size=c.decoder_out_size or c.img_size,
            n_scales=c.decoder_scales, features=c.decoder_features,
            render_kernel=c.render_kernel, norm=c.norm, act_quant=c.act_quant,
            dtype=c.dtype,
        )
        self.to(default_device(device))

    # ------------------------------------------------------------- components

    def encode_shape(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,S,S,3] → part logits [B,S/2,S/2,K(+1)] f32."""
        with span("partnet.shape_encoder"):
            return self.shape_enc(x)

    def shape_stats(self, logits: torch.Tensor):
        """logits → (spatial part distributions [B,h,w,K], μ, Σ), all f32.

        The background channel takes part in the per-pixel softmax but not
        in the moments; its slice is passed to the kernel without a copy.
        """
        fg = logits[..., : self.cfg.n_parts]
        if self.cfg.spatial_norm == "softmax":
            return softmax_moments(fg)
        parts = normalize_maps(F.softplus(fg.float()))
        mu, sigma = soft_argmax_moments(parts)
        return parts, mu, sigma

    def encode_appearance(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,S,S,3] → appearance features [B,S/2,S/2,C]."""
        with span("partnet.appearance_encoder"):
            return self.app_enc(x)

    def segmentation(self, logits: torch.Tensor) -> torch.Tensor:
        """Per-pixel part softmax over the K(+bg) channels."""
        return part_softmax(logits)

    def decode(self, mu, sigma, appearance) -> torch.Tensor:
        with span("partnet.decoder"):
            return self.decoder(mu, sigma, appearance)

    # ------------------------------------------------------------ full forward

    def forward(self, x_s: torch.Tensor, x_a: torch.Tensor) -> PartNetOutputs:
        b = x_s.shape[0]
        # One shape-encoder pass over [x_a; x_s], as the JAX package runs it.
        logits_both = self.encode_shape(torch.cat([x_a, x_s], dim=0))
        logits_a, logits_s = logits_both[:b], logits_both[b:]
        parts_a, mu_a, sigma_a = self.shape_stats(logits_a)
        parts_s, mu_s, sigma_s = self.shape_stats(logits_s)

        feats_s = self.encode_appearance(x_s)
        if self.cfg.pool_masks == "pixel":
            masks_s = self.segmentation(logits_s)[..., : self.cfg.n_parts]
        else:
            masks_s = parts_s
        appearance = pool_appearance(feats_s, masks_s)

        recon = self.decode(mu_a, sigma_a, appearance)
        return PartNetOutputs(
            recon=recon,
            logits_a=logits_a, logits_s=logits_s,
            parts_a=parts_a, parts_s=parts_s,
            seg_a=self.segmentation(logits_a),
            mu_a=mu_a, sigma_a=sigma_a, mu_s=mu_s, sigma_s=sigma_s,
            appearance=appearance,
        )


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights in the JAX package's init scheme: conv and
    dense kernels LeCun-normal (truncated at 2σ, fan-in), biases 0,
    GroupNorm scale 1 and bias 0. For runs without a trained checkpoint."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel()
                # Flax's truncated normal: std corrected for the truncation.
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                t = torch.empty(w.shape).normal_(generator=gen)
                while (bad := t.abs() > 2.0).any():
                    t[bad] = torch.empty(int(bad.sum())).normal_(generator=gen)
                w.copy_(t * std)
                m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model
