"""JAX-side helpers of the port's multi-process tests (test_torch_dist.py,
test_torch_spatial.py): the JAX package's state, perceptual loss and
per-sample draws for a config, the port's config and weights to hand to
the ranks (tests/_torch_dist_child.py), and the comparison of a rank's
step with JAX's. Imports JAX: the ranks must not import this file."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from partseg_tpu.augment.color import sample_color_params as jax_sample_color
from partseg_tpu.losses.perceptual import PerceptualLoss as JPerceptual
from partseg_tpu.losses.vgg import VGG19Features as JVGG
from partseg_tpu.losses.vgg import random_vgg19_params
from partseg_tpu.models.partnet import PartNet as JPartNet
from partseg_tpu.train.state import TrainState as JTrainState
from partseg_tpu.train.state import make_optimizer as jax_make_optimizer
from partseg_tpu_torch import convert
from partseg_tpu_torch.augment import AugmentConfig
from partseg_tpu_torch.losses import VGG19Features
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from partseg_tpu_torch.train import LossConfig, OptimConfig, TrainConfig
from _torch_dist_child import config_to_json
from _torch_parity import flax_params_from_port

KEY = 7


def port_config(jcfg) -> TrainConfig:
    """The port's TrainConfig with every field of a JAX one (f32 model)."""
    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    top = {k: v for k, v in fields(jcfg).items() if k not in ("model", "augment", "loss", "optim")}
    return TrainConfig(model=PartNetConfig(**{**fields(jcfg.model), "dtype": torch.float32}),
                       augment=AugmentConfig(**fields(jcfg.augment)),
                       loss=LossConfig(**fields(jcfg.loss)), optim=OptimConfig(**fields(jcfg.optim)),
                       **top)


def jax_keyed_draws(jcfg, sampler, step: int, aug_id) -> dict:
    """The JAX step's per-sample draws (train/step.py: fold_in(key, step),
    then fold_in(·, aug_id) per sample; augment/pair.py's per-key split)."""
    key = jax.random.fold_in(jax.random.key(KEY), step)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.asarray(aug_id, jnp.int32))
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    tps = sampler.sample_per_key(ks[:, 0])
    a = jcfg.augment
    col = jax.vmap(lambda k: jax_sample_color(k, (), a.brightness, a.contrast, a.saturation,
                                              a.hue))(ks[:, 1])
    return {"tps": np.asarray(tps.weights), "brightness": np.asarray(col.brightness),
            "contrast": np.asarray(col.contrast), "saturation": np.asarray(col.saturation),
            "hue": np.asarray(col.hue)}


def jax_setup(jcfg, start: int):
    """(JAX model, state at ``start``, perceptual, sampler, port weights, port
    VGG weights): the port's seeded init carried into Flax's tree, JAX's
    random VGG carried into the port."""
    pcfg = port_config(jcfg)
    weights = init_weights(PartNet(pcfg.model, device="cpu"), seed=0).state_dict()
    jm = JPartNet(jcfg.model)
    x0 = jnp.zeros((1, jcfg.model.img_size, jcfg.model.img_size, 3))
    params = flax_params_from_port(jm.init, weights, x0, x0)
    def count():                 # one buffer each: the step donates its state
        return jnp.array(start, jnp.int32)

    clip, (adam, sched) = jax_make_optimizer(jcfg.optim).init(params)
    jstate = JTrainState(step=count(), params=params, opt_state=(
        clip, (adam._replace(count=count()), sched._replace(count=count()))))
    lw = jcfg.loss
    jvgg = JVGG(extract=lw.vgg_layers, trim_blocks=lw.vgg_trim_blocks, dtype=jnp.float32)
    vgg_params = random_vgg19_params(jvgg, jcfg.model.img_size)
    jperc = JPerceptual(vgg_params, extract=lw.vgg_layers, trim_blocks=lw.vgg_trim_blocks,
                        feature_resolution=lw.vgg_resolution, dtype=jnp.float32)
    pvgg = VGG19Features(lw.vgg_layers, lw.vgg_trim_blocks, dtype=torch.float32)
    convert.load_flax_params(pvgg, jax.tree_util.tree_map(np.asarray, vgg_params), root="vgg")
    return dict(jm=jm, jstate=jstate, jperc=jperc, jsampler=jcfg.augment.make_sampler(),
                pcfg=pcfg, weights=weights, vgg=pvgg.state_dict())


def inputs_npz(setup, tag: str = "") -> dict:
    out = {f"{tag}config": np.asarray(config_to_json(setup["pcfg"]))}
    out.update({f"{tag}w/{k}": v.numpy() for k, v in setup["weights"].items()})
    out.update({f"{tag}vgg/{k}": v.numpy() for k, v in setup["vgg"].items()})
    return out


def jax_moments(jstate) -> dict:
    _, (adam, _) = jstate.opt_state
    return convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, adam.mu))


def compare_step(got: dict, prefix: str, jmetrics, jstate, lr: float, rtol: float = 1e-4,
                 grad_tol: float = 1e-4, param_tol: float = 1e-4) -> None:
    """A rank's metrics, first moments and updated parameters against JAX's."""
    for k, v in jmetrics.items():
        np.testing.assert_allclose(got[f"{prefix}metric/{k}"], np.asarray(v), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    mu = jax_moments(jstate)
    scale = max(v.abs().max().item() for v in mu.values())
    for k, want in mu.items():
        np.testing.assert_allclose(got[f"{prefix}mu/{k}"], want.numpy(), rtol=0,
                                   atol=grad_tol * scale, err_msg=f"mu {k}")
    params = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, want in params.items():
        err = np.abs(got[f"{prefix}param/{k}"] - want.numpy())
        big = np.abs(mu[k].numpy()) > 1e-4 * scale
        assert (err <= 2 * lr + 1e-7).all(), k
        assert (err[big] <= param_tol * max(want.abs().max().item(), lr)).all(), k
