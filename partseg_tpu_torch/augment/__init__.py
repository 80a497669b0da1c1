"""Paired augmentation: TPS warps, colour jitter and the pair driver."""

from partseg_tpu_torch.augment.color import ColorParams, color_jitter, sample_color_params
from partseg_tpu_torch.augment.pair import (
    AugmentConfig,
    PairDraws,
    make_pair,
    sample_pair_draws,
)
from partseg_tpu_torch.augment.tps import TPSParams, TPSSampler

__all__ = [
    "AugmentConfig",
    "ColorParams",
    "PairDraws",
    "TPSParams",
    "TPSSampler",
    "color_jitter",
    "make_pair",
    "sample_color_params",
    "sample_pair_draws",
]
