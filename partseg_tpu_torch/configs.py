"""Presets: the port's copies of the JAX package's ``configs/*.py``
(which import partseg_tpu, so the port keeps its own)."""

from __future__ import annotations

import dataclasses

from partseg_tpu_torch.augment.pair import AugmentConfig
from partseg_tpu_torch.models.partnet import PartNetConfig
from partseg_tpu_torch.train.config import (
    LossConfig,
    OptimConfig,
    TrainConfig,
    apply_overrides,
)

PRESETS = {
    # configs/celeba.py: CelebA 128 px, K = 10 parts.
    "celeba": PartNetConfig(n_parts=10, img_size=128),
}

TRAIN_PRESETS = {
    # configs/speed128.py: the 128 px throughput recipe that bench.py runs.
    "speed128": TrainConfig(
        model=PartNetConfig(
            n_parts=10, img_size=128, features=48, app_features=48,
            depth=3, decoder_scales=3, decoder_features=(96, 48, 24),
            decoder_out_size=32, stem_stride=4,
        ),
        augment=AugmentConfig(warp_every=2, warp_fraction=0.25),
        loss=LossConfig(
            vgg_layers=("relu1_2",),
            vgg_trim_blocks=1,
            vgg_resolution=32,
        ),
        optim=OptimConfig(lr=1e-3, decay_steps=200_000),
        dataset="celeba",
        global_batch=1024,
        steps=200_000,
        scan_groups=8,
        ckpt_every=1600,
        ckpt_dir="logs/speed128",
    ),
}


def model_config(name: str, **overrides) -> PartNetConfig:
    """The preset ``name`` with ``overrides`` applied, e.g.
    ``model_config("celeba", use_pallas=True, dtype=torch.float32)``."""
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; known: {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name], **overrides)


def train_config(name: str, overrides=()) -> TrainConfig:
    """The training preset ``name`` with dot-path ``KEY=VAL`` overrides,
    e.g. ``train_config("speed128", ["optim.lr=3e-4"])``."""
    if name not in TRAIN_PRESETS:
        raise KeyError(f"unknown train preset {name!r}; known: {sorted(TRAIN_PRESETS)}")
    return apply_overrides(TRAIN_PRESETS[name], overrides)
