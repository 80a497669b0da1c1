"""Model presets: the port's copies of the model part of the JAX
package's ``configs/*.py`` (which import partseg_tpu, so the port keeps
its own)."""

from __future__ import annotations

import dataclasses

from partseg_tpu_torch.models.partnet import PartNetConfig

PRESETS = {
    # configs/celeba.py: CelebA 128 px, K = 10 parts.
    "celeba": PartNetConfig(n_parts=10, img_size=128),
}


def model_config(name: str, **overrides) -> PartNetConfig:
    """The preset ``name`` with ``overrides`` applied, e.g.
    ``model_config("celeba", use_pallas=True, dtype=torch.float32)``."""
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; known: {sorted(PRESETS)}")
    return dataclasses.replace(PRESETS[name], **overrides)
