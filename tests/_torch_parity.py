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
from partseg_tpu_torch import convert
from partseg_tpu_torch.convert import load_flax_params
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig

# features 16, depth 2, 32 px, K = 4, two decoder scales, f32 throughout.
TINY = dict(n_parts=4, img_size=32, features=16, depth=2, app_features=8,
            decoder_scales=2, decoder_features=(16, 8))

# A config file (``load_config`` runs its get_config()) for CLI tests: the
# synthetic preset at 16 px, f32, two steps, trained at decoder_out_size 8.
TINY_TRAIN_CONFIG = '''\
import dataclasses

import torch

from partseg_tpu_torch.train.config import apply_overrides, load_config


def get_config():
    cfg = apply_overrides(load_config("synthetic"), [
        "model.img_size=16", "model.features=16", "model.depth=1", "model.app_features=8",
        "model.decoder_scales=2", "model.decoder_features=(16, 8)", "model.decoder_out_size=8",
        "loss.vgg_layers=('relu1_2',)", "loss.vgg_trim_blocks=1", "global_batch=8",
        "dataset_kwargs=(('size', 16), ('n_blobs', 3), ('n_examples', 20))", "steps=2",
        "log_every=1", "image_log_every=0"])
    return cfg.replace(model=dataclasses.replace(cfg.model, dtype=torch.float32))
'''


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


def flax_params_from_port(init_fn, state_dict, *init_args, root: str = "partnet"):
    """Flax params for a module whose ``init_fn`` (``module.init``) would make
    them, filled from a port ``state_dict``: the inverse of
    ``convert.flax_to_state_dict``. Only the tree's shapes are traced
    (``jax.eval_shape``), so nothing is compiled."""
    shapes = jax.eval_shape(init_fn, jax.random.key(0), *init_args)

    def leaf(path, spec):
        name = "/".join(p.key for p in path if p.key != "params")
        key, _ = convert._torch_key(name, root)
        value = state_dict[key].detach().cpu().numpy()
        if value.ndim == 4:                      # conv OIHW → HWIO
            value = value.transpose(2, 3, 1, 0)
        elif value.ndim == 2:                    # Linear [out, in] → Dense [in, out]
            value = value.T
        assert value.shape == spec.shape, name
        return jnp.asarray(value, spec.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).copy())


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
