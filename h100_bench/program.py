"""What the benchmark takes from the program under test (partseg_tpu_torch):
its configuration types, built from a configuration file, and its model with
the benchmark's weights. Also the inputs, made on the device from the seed.
"""

from __future__ import annotations

import time

import torch

from h100_bench import weights
from h100_bench.reference import model as ref
from h100_bench.reference import train as ref_train

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def train_config(cfg: dict, variant: str):
    """The program's TrainConfig of a configuration file; the ``control``
    variant turns on the program's float8 activation storage."""
    from partseg_tpu_torch.augment.pair import AugmentConfig
    from partseg_tpu_torch.models.partnet import PartNetConfig
    from partseg_tpu_torch.train.config import LossConfig, OptimConfig, TrainConfig

    m = dict(cfg["model"], dtype=DTYPES[cfg["model"]["dtype"]],
             decoder_features=tuple(cfg["model"]["decoder_features"]))
    if variant == "control":
        m["act_quant"] = "f8"
    loss = dict(cfg["loss"], vgg_layers=tuple(cfg["loss"]["vgg_layers"]))
    return TrainConfig(model=PartNetConfig(**m), augment=AugmentConfig(**cfg["augment"]),
                       loss=LossConfig(**loss), optim=OptimConfig(**cfg["optim"]),
                       global_batch=cfg["global_batch"])


def model_weights(cfg: dict, seed: int, device) -> dict:
    """The PartNet's weights, made from the seed on the device."""
    with torch.device("meta"):
        shapes = weights.shapes_of(ref.PartNet(cfg["model"]))
    return weights.make(shapes, seed, device, purpose=1)


def vgg_weights(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes = weights.shapes_of(ref_train.VGG19(cfg["loss"]["vgg_layers"],
                                                   cfg["loss"]["vgg_trim_blocks"]))
    return weights.make(shapes, seed, device, purpose=2)


def build_model(tc, w: dict, device):
    """The program's PartNet, built on the device, holding the weights ``w``."""
    from partseg_tpu_torch.models.partnet import PartNet

    with torch.device(device):
        model = PartNet(tc.model, device=device)
    weights.load(model, w)
    return model


def image_pool(n: int, batch: int, size: int, seed: int, device,
               contrast: tuple = (1.0, 1.0)) -> torch.Tensor:
    """[n, batch, size, size, 3] f32 images in [0, 1) from the seed: uniform
    noise about 0.5, row i of each batch at the contrast ``lo + (hi − lo) ·
    i / (batch − 1)`` of ``contrast = (lo, hi)`` (1 is uniform in [0, 1))."""
    gen = torch.Generator(device=device).manual_seed(weights.stream(seed, 3))
    u = torch.rand((n, batch, size, size, 3), generator=gen, device=device)
    lo, hi = contrast
    if lo == hi == 1.0:
        return u
    c = torch.linspace(lo, hi, batch, device=device).view(1, batch, 1, 1, 1)
    return 0.5 + c * (u - 0.5)


class Parts:
    """Seconds of each part of a set-up, stamped as it goes."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def stamp(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
