"""Presets: the port's copies of the JAX package's ``configs/*.py``
(which import partseg_tpu, so the port keeps its own). Each train preset
is that file's ``get_config()`` as a port ``TrainConfig``, field for field,
the JAX dtypes as torch dtypes; ``train.config.load_config`` resolves a
``configs/<name>.py`` path to the preset ``<name>``.
"""

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

_HEAVY_TPS = dict(tps_ctrl_sd=0.12, tps_rot_sd=0.12)   # the video datasets' warps

TRAIN_PRESETS = {
    # configs/celeba.py: CelebA 128 px, K = 10 parts, appearance swap.
    "celeba": TrainConfig(
        model=PartNetConfig(n_parts=10, img_size=128),
        loss=LossConfig(swap_weight=0.5),
        optim=OptimConfig(lr=1e-3, decay_steps=200_000),
        dataset="celeba", global_batch=256, steps=200_000, ckpt_dir="logs/celeba",
    ),
    # configs/celeba_wild.py: CelebA in the wild, stronger warps.
    "celeba_wild": TrainConfig(
        model=PartNetConfig(n_parts=10, img_size=128),
        augment=AugmentConfig(tps_scale_sd=0.12, tps_rot_sd=0.12, tps_trans_sd=0.12,
                              tps_ctrl_sd=0.10),
        optim=OptimConfig(lr=1e-3, decay_steps=200_000),
        dataset="celeba_wild", global_batch=256, steps=200_000, ckpt_dir="logs/celeba_wild",
    ),
    # configs/celeba256_spatial.py: 256 px with image rows sharded over
    # two ranks (space_shards = 2; parallel/spatial_train.py): train it under
    # torchrun with an even number of ranks.
    "celeba256_spatial": TrainConfig(
        model=PartNetConfig(n_parts=10, img_size=256, features=128, depth=4,
                            app_features=128, decoder_scales=4),
        loss=LossConfig(vgg_resolution=128, swap_weight=0.5),
        optim=OptimConfig(lr=1e-3, decay_steps=200_000),
        dataset="celeba", dataset_kwargs=(("size", 256),), global_batch=128,
        space_shards=2, steps=200_000, ckpt_dir="logs/celeba256",
    ),
    # configs/cub.py: CUB-200 birds, heavier warps.
    "cub": TrainConfig(
        model=PartNetConfig(n_parts=10, img_size=128, background=True),
        augment=AugmentConfig(tps_ctrl_sd=0.14, tps_scale_sd=0.12, tps_rot_sd=0.15,
                              tps_trans_sd=0.12),
        optim=OptimConfig(lr=1e-3, decay_steps=150_000),
        dataset="cub", global_batch=256, steps=150_000, ckpt_dir="logs/cub",
    ),
    # configs/deepfashion.py: DeepFashion, K = 16, appearance transfer.
    "deepfashion": TrainConfig(
        model=PartNetConfig(n_parts=16, img_size=128),
        augment=AugmentConfig(tps_ctrl_sd=0.12),
        loss=LossConfig(swap_weight=1.0),
        optim=OptimConfig(lr=1e-3, decay_steps=200_000),
        dataset="deepfashion", global_batch=256, steps=200_000, ckpt_dir="logs/deepfashion",
    ),
    # configs/human36m.py and configs/penn_action.py: video frames, K = 16.
    "human36m": TrainConfig(
        model=PartNetConfig(n_parts=16, img_size=128),
        augment=AugmentConfig(**_HEAVY_TPS),
        optim=OptimConfig(lr=1.5e-3, decay_steps=300_000),
        dataset="human36m", global_batch=512, steps=300_000, ckpt_dir="logs/human36m",
    ),
    "penn_action": TrainConfig(
        model=PartNetConfig(n_parts=16, img_size=128),
        augment=AugmentConfig(**_HEAVY_TPS),
        optim=OptimConfig(lr=1.5e-3, decay_steps=300_000),
        dataset="penn_action", global_batch=512, steps=300_000, ckpt_dir="logs/penn_action",
    ),
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
    # configs/synthetic.py: the synthetic-blobs smoke config.
    "synthetic": TrainConfig(
        model=PartNetConfig(n_parts=5, img_size=64, features=64, depth=3,
                            app_features=64, decoder_scales=3),
        loss=LossConfig(vgg_trim_blocks=3, vgg_layers=("relu1_2", "relu2_2", "relu3_2")),
        optim=OptimConfig(lr=1e-3, warmup_steps=100, decay_steps=5_000),
        dataset="synthetic", dataset_kwargs=(("size", 64), ("n_blobs", 5)),
        global_batch=32, steps=2_000, ckpt_dir="logs/synthetic",
    ),
    # configs/throughput128.py: VGG at 64², depth 3, a 3-scale decoder.
    "throughput128": TrainConfig(
        model=PartNetConfig(n_parts=10, img_size=128, depth=3, decoder_scales=3,
                            decoder_features=(128, 64, 32)),
        loss=LossConfig(vgg_layers=("relu1_2", "relu2_2", "relu3_2"), vgg_trim_blocks=3,
                        vgg_resolution=64),
        optim=OptimConfig(lr=1e-3, decay_steps=200_000),
        dataset="celeba", global_batch=1024, steps=200_000, ckpt_dir="logs/throughput128",
    ),
}

PRESETS = {
    # configs/celeba.py's model: CelebA 128 px, K = 10 parts.
    "celeba": TRAIN_PRESETS["celeba"].model,
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
