"""Paired augmentation, twin of partseg_tpu/augment/pair.py: from one set
of draws, the two coupled views

  x_s = TPS-warp(x)      spatial view: geometry changed, appearance kept
  x_a = jitter(x)        appearance view: appearance changed, geometry kept

plus the TPS transform itself, which the equivariance loss needs.

Sampling is split from application: ``keyed_pair_draws`` makes the
draws of each sample from (seed, step, aug_id), as the JAX package keys
them per sample so that the split of a batch cannot change them;
``make_pair`` applies given draws (the parity tests inject the JAX
package's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from partseg_tpu_torch.augment import keys
from partseg_tpu_torch.augment.color import (
    ColorParams,
    color_from_uniforms,
    color_jitter,
)
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


def keyed_pair_draws(seed: int, step: int, aug_id, sampler: TPSSampler, cfg: AugmentConfig,
                     device: torch.device | str = "cpu") -> PairDraws:
    """The draws of samples ``aug_id`` [B] (host integers: numpy or a CPU
    tensor) at ``step``, on ``device``. Each sample's draws are one counter
    range of its key: the jitter's 4 uniforms, then the warp's normals and,
    with ``warp_appearance_view``, the appearance view's. They are hashed
    on the host (augment/keys.py) and sent to the device in one copy."""
    if torch.is_tensor(aug_id):
        aug_id = aug_id.cpu().numpy()
    n = sampler.n_normals
    per_warp = n + n % 2                # Box-Muller makes normals in pairs
    warps = 2 if cfg.warp_appearance_view else 1
    u = keys.uniforms(keys.sample_keys(seed, step, aug_id), 4 + warps * per_warp)
    z = np.concatenate(
        [u[:, :4]] + [keys.box_muller(u[:, 4 + i * per_warp:4 + (i + 1) * per_warp])[:, :n]
                      for i in range(warps)], axis=1).astype(np.float32)
    z = torch.from_numpy(z)
    if torch.device(device).type == "cuda":
        z = z.pin_memory().to(device, non_blocking=True)
    col = color_from_uniforms(z[:, :4], cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue)
    tps = sampler.from_normals(z[:, 4:4 + n])
    tps2 = sampler.from_normals(z[:, 4 + n:]) if warps == 2 else None
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
