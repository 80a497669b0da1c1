"""Training configuration: the port's copies of the JAX package's
``LossConfig``, ``OptimConfig`` and ``TrainConfig``
(partseg_tpu/train/config.py), with the same fields and defaults, its
dot-path ``KEY=VAL`` overrides and ``load_config``. The training step reads
``model``, ``augment``, ``loss``, ``optim`` and ``seed``; the loop
(``train/loop.py``) the rest.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import pathlib
from typing import Any

from partseg_tpu_torch.augment.pair import AugmentConfig
from partseg_tpu_torch.models.partnet import PartNetConfig


@dataclasses.dataclass(frozen=True)
class LossConfig:
    rec_weight: float = 1.0
    equiv_weight: float = 1.0
    equiv_sigma_weight: float = 1.0
    pixel_weight: float = 1.0
    vgg_layers: tuple = ("relu1_2", "relu2_2", "relu3_2", "relu4_2")
    vgg_layer_weights: tuple | None = None
    vgg_trim_blocks: int = 4          # drop conv5
    vgg_npz: str | None = None        # pretrained weights path (or $VGG19_NPZ)
    vgg_resolution: int | None = None # downsample inputs to the VGG
    # Appearance-swap consistency: decode with batch-rolled appearance
    # vectors; the re-encoded part locations must stay put. 0 disables.
    swap_weight: float = 0.0
    # Dense-segmentation consistency: cross-entropy between the per-pixel
    # part softmax and the no-grad occupancy of the rendered Gaussians.
    seg_weight: float = 0.3


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-3
    warmup_steps: int = 500
    decay_steps: int = 100_000
    end_lr_factor: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.0
    grad_clip: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: PartNetConfig = PartNetConfig()
    augment: AugmentConfig = AugmentConfig()
    loss: LossConfig = LossConfig()
    optim: OptimConfig = OptimConfig()

    dataset: str = "synthetic"
    dataset_kwargs: tuple = ()
    loader_backend: str = "grain"
    global_batch: int = 64
    steps: int = 10_000
    space_shards: int = 1
    data_echo: int = 1
    scan_groups: int = 1
    device_data: bool = False
    device_data_u8: bool = False
    seed: int = 0

    log_every: int = 50
    image_log_every: int = 1000
    ckpt_every: int = 1000
    ckpt_dir: str = "logs/run"
    ckpt_keep: int = 3
    profile_steps: tuple | None = None
    fault_injection_step: int | None = None

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def load_config(name_or_path: str) -> TrainConfig:
    """A train preset by name (``"speed128"``), or ``get_config()`` of a
    Python file that builds a port ``TrainConfig``. A path
    ``configs/<name>.py`` names the port's preset ``<name>`` and is not
    executed (those files build the JAX package's configs), so the JAX
    CLI's ``--config configs/synthetic.py`` works unchanged."""
    from partseg_tpu_torch.configs import TRAIN_PRESETS

    if name_or_path in TRAIN_PRESETS:
        return TRAIN_PRESETS[name_or_path]
    p = pathlib.Path(name_or_path)
    if p.suffix == ".py" and p.parent.name == "configs":
        if p.stem not in TRAIN_PRESETS:
            raise KeyError(f"{name_or_path}: no port preset {p.stem!r}; known: "
                           f"{sorted(TRAIN_PRESETS)}")
        return TRAIN_PRESETS[p.stem]
    if p.suffix != ".py" or not p.is_file():
        raise KeyError(f"unknown config {name_or_path!r}: neither a preset "
                       f"({sorted(TRAIN_PRESETS)}) nor a Python file")
    spec = importlib.util.spec_from_file_location(p.stem, p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config()


def apply_overrides(cfg: Any, overrides) -> Any:
    """Apply dot-path overrides like ``optim.lr=3e-4`` to nested frozen
    dataclasses; values are Python literals, else strings."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        cfg = _set_nested(cfg, key.strip().split("."), value)
    return cfg


def _set_nested(obj: Any, parts: list[str], value: Any) -> Any:
    if len(parts) == 1:
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _set_nested(child, parts[1:], value)})
