"""VGG19 feature extractor for the perceptual loss, twin of
partseg_tpu/losses/vgg.py.

There is no network, so ``load_vgg19`` reads user-provided weights
(``vgg19.npz`` with keys ``conv{block}_{idx}/kernel`` [3, 3, Cin, Cout] HWIO
and ``conv{block}_{idx}/bias`` [Cout], the JAX package's format) and
otherwise keeps the port's own seeded random init. That init is not the
JAX package's (Flax's seed-1742 init cannot be reproduced in torch), so
it reports ``vgg_mode="random-torch"``, never ``"random"``.
"""

from __future__ import annotations

import os
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from partseg_tpu_torch.models.blocks import Conv2d
from partseg_tpu_torch.models.encoders import to_nchw

# VGG19: (block, n_convs, channels)
_VGG19_BLOCKS = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))

# ImageNet normalization (the pretrained weights' input convention).
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)

RANDOM_SEED = 1742


class VGG19Features(nn.Module):
    """x [B, H, W, 3] NHWC → dict of post-ReLU feature maps named like
    "relu3_2", each [B, C, h, w] (NCHW, channels_last on the card).

    Computes only up to the deepest requested activation, and never past
    ``trim_blocks``; only those convolutions exist (``conv{b}_{i}``), as in
    the Flax module. Parameters are f32, convolutions run in ``dtype``."""

    def __init__(self, extract: Sequence[str] = ("relu1_2", "relu2_2", "relu3_2", "relu4_2"),
                 trim_blocks: int = 5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.extract = tuple(extract)
        self.dtype = dtype
        wanted = set(self.extract)
        self.deepest = max((b, i) for b, n, _ in _VGG19_BLOCKS for i in range(1, n + 1)
                           if f"relu{b}_{i}" in wanted)
        self.layers: list[tuple[int, int]] = []
        cin = 3
        for block, n_convs, ch in _VGG19_BLOCKS[:trim_blocks]:
            for i in range(1, n_convs + 1):
                if (block, i) > self.deepest:
                    break
                self.add_module(f"conv{block}_{i}", Conv2d(cin, ch, 3, dtype))
                self.layers.append((block, i))
                cin = ch
        self.register_buffer("mean", torch.from_numpy(_MEAN), persistent=False)
        self.register_buffer("std", torch.from_numpy(_STD), persistent=False)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h = to_nchw((x - self.mean.to(x.dtype)) / self.std.to(x.dtype))
        feats: dict[str, torch.Tensor] = {}
        for block, i in self.layers:
            if i == 1 and block > 1:
                h = F.max_pool2d(h, 2, 2)
            h = getattr(self, f"conv{block}_{i}")(h, relu=True)
            if f"relu{block}_{i}" in self.extract:
                feats[f"relu{block}_{i}"] = h
        return feats


def load_vgg19(model: VGG19Features, path: str | None = None) -> str:
    """Fill ``model`` from the first npz found at ``path``, ``$VGG19_NPZ``
    or ./vgg19.npz, after a seeded random init (leaves the file lacks keep
    it). Returns the mode, "pretrained:<path>" or "random-torch"; callers
    surface it, since a run trained against random VGG features is not
    comparable to the reference."""
    from partseg_tpu_torch.models.partnet import init_weights

    init_weights(model, seed=RANDOM_SEED)
    candidates = [path, os.environ.get("VGG19_NPZ"), "vgg19.npz"]
    npz_path = next((p for p in candidates if p and os.path.exists(p)), None)
    if npz_path is None:
        warnings.warn(
            "VGG19 pretrained weights not found (looked at the given path, $VGG19_NPZ, "
            "./vgg19.npz): using the port's seeded random init (vgg_mode random-torch). "
            "Perceptual quality is below the reference's in this mode.",
            stacklevel=2,
        )
        return "random-torch"
    with np.load(npz_path) as data, torch.no_grad():
        for block, i in model.layers:
            conv = getattr(model, f"conv{block}_{i}")
            if f"conv{block}_{i}/kernel" in data:
                conv.weight.copy_(torch.from_numpy(
                    data[f"conv{block}_{i}/kernel"].transpose(3, 2, 0, 1).copy()))
            if f"conv{block}_{i}/bias" in data:
                conv.bias.copy_(torch.from_numpy(data[f"conv{block}_{i}/bias"]))
    return f"pretrained:{npz_path}"
