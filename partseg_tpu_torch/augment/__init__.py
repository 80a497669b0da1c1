"""Paired augmentation: TPS warps, colour jitter and the pair driver."""

from partseg_tpu_torch.augment.color import ColorParams, color_jitter
from partseg_tpu_torch.augment.pair import (
    AugmentConfig,
    PairDraws,
    keyed_pair_draws,
    make_pair,
)
from partseg_tpu_torch.augment.tps import TPSParams, TPSSampler

__all__ = [
    "AugmentConfig",
    "ColorParams",
    "PairDraws",
    "TPSParams",
    "TPSSampler",
    "color_jitter",
    "keyed_pair_draws",
    "make_pair",
]
