"""Paired augmentation, twin of partseg_tpu/augment/pair.py: from one set
of draws, the two coupled views

  x_s = TPS-warp(x)      spatial view: geometry changed, appearance kept
  x_a = jitter(x)        appearance view: appearance changed, geometry kept

plus the TPS transform itself, which the equivariance loss needs.

Sampling is split from application: ``sample_pair_draws`` makes the
draws from a ``torch.Generator``, ``make_pair`` applies given draws (the
tests inject the JAX package's). The JAX package also keys draws per
sample (``aug_id``) so that data parallelism cannot change them; that
matters only once the port runs data parallel, and comes with it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from partseg_tpu_torch.augment.color import ColorParams, color_jitter, sample_color_params
from partseg_tpu_torch.augment.tps import TPSParams, TPSSampler


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Static augmentation hyperparameters; the JAX ``AugmentConfig``'s
    fields and defaults."""

    tps_grid: int = 5
    tps_scale_sd: float = 0.08
    tps_rot_sd: float = 0.08
    tps_trans_sd: float = 0.08
    tps_ctrl_sd: float = 0.08
    brightness: float = 0.1
    contrast: float = 0.3
    saturation: float = 0.3
    hue: float = 0.3
    # Also TPS-warp the appearance view, with an independent warp.
    warp_appearance_view: bool = False
    # Warp only on every N-th step; off-steps use x_s = x and the exact
    # identity transform (train/step.make_train_period).
    warp_every: int = 1
    # Warp only the first ceil(B·f) samples; the rest pass through with
    # the exact identity transform.
    warp_fraction: float = 1.0
    padding_mode: str = "border"
    # Kept for parity with the JAX config: the port always warps through
    # its kernels on the card (TPSSampler.warp).
    warp_impl: str = "auto"

    def make_sampler(self) -> TPSSampler:
        return TPSSampler(grid_size=self.tps_grid, scale_sd=self.tps_scale_sd,
                          rot_sd=self.tps_rot_sd, trans_sd=self.tps_trans_sd,
                          ctrl_sd=self.tps_ctrl_sd)


class PairDraws(NamedTuple):
    """The random draws of one paired augmentation."""

    tps: TPSParams
    color: ColorParams
    tps2: TPSParams | None = None     # the appearance view's warp, if any


def sample_pair_draws(gen: torch.Generator, b: int, sampler: TPSSampler,
                      cfg: AugmentConfig) -> PairDraws:
    """Draw the TPS warps and colour jitter of a batch of b images."""
    tps = sampler.sample(gen, b)
    col = sample_color_params(gen, b, cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue)
    tps2 = sampler.sample(gen, b) if cfg.warp_appearance_view else None
    return PairDraws(tps, col, tps2)


def make_pair(x: torch.Tensor, tps: TPSParams, color: ColorParams, sampler: TPSSampler,
              cfg: AugmentConfig, warp_on: bool = True,
              tps2: TPSParams | None = None) -> dict:
    """The coupled views of x [B, H, W, 3] in [0, 1] under the given draws.

    warp_on=False builds the off-step: no warp, x_s is the input and the
    returned transform is the exact identity. Returns a dict with x_s,
    x_a, tps (the warp applied to x_s: T maps x_s-frame points to x-frame
    points) and color.
    """
    b = x.shape[0]
    frac = float(cfg.warp_fraction)
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"warp_fraction must be in (0, 1], got {frac}")
    if cfg.warp_appearance_view and tps2 is None:
        raise ValueError("warp_appearance_view needs the draws' tps2")

    def warp(params: TPSParams, img: torch.Tensor) -> torch.Tensor:
        return sampler.warp(params, img, padding_mode=cfg.padding_mode)

    dt = tps.weights.dtype
    if warp_on and frac < 1.0:
        # Warp the head; the tail passes through with the exact identity.
        nw = min(b, max(1, math.ceil(b * frac)))
        head = TPSParams(tps.weights[:nw])
        x_s = torch.cat([warp(head, x[:nw]), x[nw:]], dim=0)
        ident = sampler.identity(b - nw, device=x.device).weights.to(dt)
        tps = TPSParams(torch.cat([head.weights, ident], dim=0))
    elif warp_on:
        x_s = warp(tps, x)
    else:
        tps = TPSParams(sampler.identity(b, device=x.device).weights.to(dt))
        x_s = x
    x_a = color_jitter(x, color)
    if cfg.warp_appearance_view and warp_on:
        x_a = warp(tps2, x_a)
    return {"x_s": x_s, "x_a": x_a, "tps": tps, "color": color}
