"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Builds a JAX PartNet and its port from one tiny config: the JAX side is
initialised by its own ``init`` and its params are carried across by
``partseg_tpu_torch.convert``; inputs come from a numpy seed and pass
between the frameworks as numpy arrays. Everything runs on the CPU in
float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from partseg_tpu.models.partnet import PartNet as JaxPartNet
from partseg_tpu.models.partnet import PartNetConfig as JaxConfig
from partseg_tpu_torch.convert import load_flax_params
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig

# features 16, depth 2, 32 px, K = 4, two decoder scales, f32 throughout.
TINY = dict(n_parts=4, img_size=32, features=16, depth=2, app_features=8,
            decoder_scales=2, decoder_features=(16, 8))


def images(seed: int, b: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (b, size, size, 3)).astype(np.float32)


def jax_partnet(use_pallas: bool = True, **overrides):
    """(model, params) of the JAX PartNet at the tiny f32 config."""
    cfg = JaxConfig(**{**TINY, **overrides}, use_pallas=use_pallas, dtype=jnp.float32)
    model = JaxPartNet(cfg)
    x = jnp.zeros((1, cfg.img_size, cfg.img_size, 3))
    return model, model.init(jax.random.key(0), x, x)


def torch_partnet(jax_params, **overrides) -> PartNet:
    """The port's PartNet on the CPU, with the JAX params carried across."""
    cfg = PartNetConfig(**{**TINY, **overrides}, use_pallas=True, dtype=torch.float32)
    model = PartNet(cfg, device="cpu")
    return load_flax_params(model, jax.tree_util.tree_map(np.asarray, jax_params)).eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).copy())


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
