"""Port parity: the training step and period, against the JAX package's
``make_train_step`` / ``make_train_period``, at float32 on the CPU.

Both sides start from the same params (the port's seeded init carried
into Flax's tree, so no JAX init is compiled), the same VGG (the JAX
init, carried across by ``partseg_tpu_torch.convert``), the same images
and the same draws: the test rebuilds the JAX step's draws by its own key path
(``fold_in(key, step)`` → ``split(·, 3)`` → ``sampler.sample`` and
``sample_color_params``) and injects them into the port. The state starts
at a step whose lr > 0 (step 0's update is 0 under the 0-init warmup),
with zero Adam moments, so the moments are sums of (1 − b1)·g and
(1 − b2)·g² over the clipped gradients g: comparing them compares the
gradients. The JAX period is compiled once per swap weight and serves
both the step and the period comparison.

Tolerances: the loss and every metric rtol 1e-4 (f32 sums over tens of
layers in another order). The moments 1e-3 of their largest entry: step
1's gradients agree to about 1e-6 of it, but Adam turns the rounding
noise of near-zero gradients into full-size steps of either sign, so the
two sides enter step 2 with params that differ by up to 2·3.5·lr there,
and step 2's gradients then differ by a few 1e-4 of the largest. The
updated params as ``_compare_params`` says.
"""

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from configs.speed128 import get_config as jax_speed128
from partseg_tpu.augment.color import sample_color_params as jax_sample_color
from partseg_tpu.augment.pair import AugmentConfig as JAugment
from partseg_tpu.losses.perceptual import PerceptualLoss as JPerceptual
from partseg_tpu.losses.vgg import VGG19Features as JVGG
from partseg_tpu.losses.vgg import random_vgg19_params
from partseg_tpu.models.partnet import PartNet as JPartNet
from partseg_tpu.models.partnet import PartNetConfig as JModel
from partseg_tpu.train import config as jconfig
from partseg_tpu.train.state import TrainState as JTrainState
from partseg_tpu.train.state import make_optimizer as jax_make_optimizer
from partseg_tpu.train.step import make_train_period as jax_make_period
from partseg_tpu_torch import configs, convert
from partseg_tpu_torch.augment import (
    AugmentConfig,
    ColorParams,
    PairDraws,
    TPSParams,
    keyed_pair_draws,
)
from partseg_tpu_torch.losses import PerceptualLoss, VGG19Features
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from partseg_tpu_torch.train.config import load_config
from partseg_tpu_torch.train import (
    LossConfig,
    OptimConfig,
    TrainConfig,
    create_state,
    make_loss_fn,
    make_train_period,
    make_train_step,
)
from _torch_parity import flax_params_from_port, images, n, t

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
B = 4
START = 5          # lr = 1e-3 · 5/10 under the 10-step warmup
KEY = 7


def jax_tiny(swap_weight: float) -> jconfig.TrainConfig:
    """tests/test_train.py's TINY, with speed128's structure: decoding below
    the image size, VGG at the recon resolution, a warp_every = 2 period
    warping half the batch."""
    return jconfig.TrainConfig(
        model=JModel(n_parts=3, img_size=16, features=16, depth=1, app_features=8,
                     decoder_scales=2, decoder_out_size=8, dtype=jnp.float32),
        augment=JAugment(tps_grid=3, warp_every=2, warp_fraction=0.5),
        loss=jconfig.LossConfig(vgg_layers=("relu1_2",), vgg_trim_blocks=1,
                                vgg_resolution=8, seg_weight=0.3, swap_weight=swap_weight),
        optim=jconfig.OptimConfig(lr=1e-3, warmup_steps=10, decay_steps=100),
        global_batch=B,
    )


def port_config(jcfg) -> TrainConfig:
    """The port's TrainConfig with every field of a JAX one (f32 model)."""
    def fields(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    model = {**fields(jcfg.model), "dtype": torch.float32}
    top = {k: v for k, v in fields(jcfg).items()
           if k not in ("model", "augment", "loss", "optim")}
    return TrainConfig(model=PartNetConfig(**model), augment=AugmentConfig(**fields(jcfg.augment)),
                       loss=LossConfig(**fields(jcfg.loss)), optim=OptimConfig(**fields(jcfg.optim)),
                       **top)


def jax_draws(jcfg, sampler, step: int) -> PairDraws:
    """The JAX step's draws at ``step``, as the port's PairDraws."""
    k_tps, k_col, _ = jax.random.split(jax.random.fold_in(jax.random.key(KEY), step), 3)
    a = jcfg.augment
    tps = sampler.sample(k_tps, B)
    col = jax_sample_color(k_col, B, a.brightness, a.contrast, a.saturation, a.hue)
    return PairDraws(TPSParams(t(tps.weights)),
                     ColorParams(t(col.brightness), t(col.contrast), t(col.saturation), t(col.hue)))


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["swap0", "swap0.5"])
def pair(request):
    """One swap weight: the JAX period run once from START (one compile),
    and what the port needs to run the same period."""
    jcfg = jax_tiny(request.param)
    pcfg = port_config(jcfg)
    # Seeded port weights carried into Flax's tree (no JAX init to compile).
    weights = init_weights(PartNet(pcfg.model, device="cpu"), seed=0).state_dict()
    jm = JPartNet(jcfg.model)
    x0 = jnp.zeros((1, 16, 16, 3))
    params = flax_params_from_port(jm.init, weights, x0, x0)
    count = jnp.asarray(START, jnp.int32)
    clip, (adam, sched) = jax_make_optimizer(jcfg.optim).init(params)
    jstate = JTrainState(step=count, params=params, opt_state=(
        clip, (adam._replace(count=count), sched._replace(count=count))))

    lw = jcfg.loss
    jvgg = JVGG(extract=lw.vgg_layers, trim_blocks=lw.vgg_trim_blocks, dtype=jnp.float32)
    vgg_params = random_vgg19_params(jvgg, jcfg.model.img_size)
    jperc = JPerceptual(vgg_params, extract=lw.vgg_layers, trim_blocks=lw.vgg_trim_blocks,
                        feature_resolution=lw.vgg_resolution, dtype=jnp.float32)
    pvgg = VGG19Features(lw.vgg_layers, lw.vgg_trim_blocks, dtype=torch.float32)
    convert.load_flax_params(pvgg, jax.tree_util.tree_map(np.asarray, vgg_params), root="vgg")

    jsampler = jcfg.augment.make_sampler()
    x = (images(20, B, 16), images(21, B, 16))
    jperiod = jax.jit(jax_make_period(jcfg, jm, jsampler, jperc))
    jnew, jmetrics = jperiod(jstate, tuple({"image": jnp.asarray(v)} for v in x),
                             jax.random.key(KEY))

    def port_state():
        model = PartNet(pcfg.model, device="cpu")
        model.load_state_dict(weights)
        return create_state(pcfg, model, step=START)

    return dict(pcfg=pcfg, pperc=PerceptualLoss(pvgg, feature_resolution=lw.vgg_resolution),
                psampler=pcfg.augment.make_sampler(), port_state=port_state, weights=weights,
                x=x, draws=tuple(jax_draws(jcfg, jsampler, START + i) for i in range(2)),
                jstate=jnew, jmetrics=jmetrics)


def _compare(jmetrics, jstate, pmetrics, pstate):
    """Metrics and Adam moments; returns the JAX first moments (port layout)."""
    for k, v in jmetrics.items():
        np.testing.assert_allclose(n(pmetrics[k]), np.asarray(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert set(pmetrics) == set(jmetrics)
    _, (adam, _) = jstate.opt_state
    moments = {}
    for name in ("mu", "nu"):
        want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, getattr(adam, name)))
        got = getattr(pstate.opt_state, name)
        scale = max(v.abs().max().item() for v in want.values())
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-3 * scale,
                                       msg=f"{name} {k}")
        moments[name] = want
    assert pstate.step == int(jstate.step) and pstate.opt_state.count == int(adam.count)
    return moments["mu"]


def _compare_params(jstate, pstate, start_params, mu, lr_max):
    """Updated params, Δ = −Σ lr·u over the steps with |u| = |m̂/(√v̂+ε)| ≤ 3.5
    (one or two steps from zero moments). Where the first moment stands
    above its rounding noise (|m| > 1e-4 of the largest), u errs by about
    the moments' relative errors: rel = 1e-3 plus 3× the first moment's
    checked tolerance (1e-3 of the largest) over |m|; so |ΔΔ| ≤ 2·3.5·lr·rel,
    plus 4 ulp of the parameter. (Bounding by |Δ| instead fails where the
    two steps' updates cancel.) Elsewhere (gradients that are 0 but for
    rounding, like a conv bias ahead of a GroupNorm) Adam turns noise into
    a full-size step of either sign, so |ΔΔ| ≤ 2·3.5·lr."""
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = pstate.model.state_dict()
    scale = max(v.abs().max().item() for v in mu.values())
    for k, w in want.items():
        delta_w = w - start_params[k]
        err = (got[k] - start_params[k] - delta_w).abs()
        assert err.max().item() <= 2 * 3.5 * lr_max, k
        big = mu[k].abs() > 1e-4 * scale
        ulps = 4 * torch.finfo(torch.float32).eps * w.abs()      # rounding of p + Δ itself
        rel = 1e-3 + 3e-3 * scale / mu[k].abs().clamp_min(1e-30)
        assert (err <= 2 * 3.5 * lr_max * rel + ulps)[big].all(), k


def test_train_step_matches_jax(pair):
    """make_train_step, warp on then off, against the JAX period's two
    sub-steps (which are the JAX make_train_step's)."""
    p = pair
    state = p["port_state"]()
    ms = []
    for i, warp_on in enumerate((True, False)):
        step = make_train_step(p["pcfg"], state.model, p["psampler"], p["pperc"], warp_on)
        state, m = step(state, {"image": t(p["x"][i])}, draws=p["draws"][i])
        ms.append(m)
    jm = dict(p["jmetrics"])
    for k, want in (("loss_warp_on", ms[0]["loss"]), ("loss_warp_off", ms[1]["loss"])):
        np.testing.assert_allclose(n(want), np.asarray(jm.pop(k)), rtol=1e-4, err_msg=k)
    mean = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
    mu = _compare(jm, p["jstate"], mean, state)
    _compare_params(p["jstate"], state, p["weights"], mu, lr_max=1e-3 * (START + 1) / 10)


def test_train_period_matches_jax(pair):
    p = pair
    state = p["port_state"]()
    period = make_train_period(p["pcfg"], state.model, p["psampler"], p["pperc"])
    state, pm = period(state, tuple({"image": t(x)} for x in p["x"]), draws=p["draws"])
    assert {"loss_warp_on", "loss_warp_off", "grad_norm"} <= set(pm)
    mu = _compare(p["jmetrics"], p["jstate"], pm, state)
    _compare_params(p["jstate"], state, p["weights"], mu, lr_max=1e-3 * (START + 1) / 10)


def test_train_configs_have_the_jax_fields_and_defaults():
    for jcls, pcls in ((jconfig.LossConfig, LossConfig), (jconfig.OptimConfig, OptimConfig),
                       (JAugment, AugmentConfig)):
        want = {(f.name, repr(f.default)) for f in dataclasses.fields(jcls)}
        assert {(f.name, repr(f.default)) for f in dataclasses.fields(pcls)} == want
    top = {f.name for f in dataclasses.fields(jconfig.TrainConfig)}
    assert {f.name for f in dataclasses.fields(TrainConfig)} == top


def _assert_same_config(got: TrainConfig, want: jconfig.TrainConfig) -> None:
    """A port TrainConfig equals a JAX one field for field, the model's
    dtype as the torch dtype of the same name."""
    for section in ("augment", "loss", "optim"):
        assert dataclasses.asdict(getattr(got, section)) == dataclasses.asdict(getattr(want, section))
    for f in dataclasses.fields(JModel):
        a, b = getattr(got.model, f.name), getattr(want.model, f.name)
        if f.name == "dtype":
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        else:
            assert a == b, f.name
    for f in dataclasses.fields(jconfig.TrainConfig):
        if f.name not in ("model", "augment", "loss", "optim"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


PRESET_NAMES = sorted(p.stem for p in (REPO / "configs").glob("*.py") if p.stem != "__init__")


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_train_preset_equals_jax_config(name):
    """Every file of configs/ has its port preset, equal to its
    get_config() field for field; load_config resolves the file's path to
    it without running the file."""
    want = importlib.import_module(f"configs.{name}").get_config()
    got = load_config(f"configs/{name}.py")
    assert got is configs.TRAIN_PRESETS[name] is load_config(name)
    _assert_same_config(got, want)


def test_load_config_runs_a_port_config_file(tmp_path):
    path = tmp_path / "mine.py"
    path.write_text("from partseg_tpu_torch.configs import train_config\n"
                    "def get_config():\n"
                    "    return train_config('synthetic', ['steps=7'])\n")
    assert load_config(str(path)).steps == 7
    assert set(configs.TRAIN_PRESETS) == set(PRESET_NAMES)
    with pytest.raises(KeyError, match="no port preset"):
        load_config("configs/imagenet.py")
    with pytest.raises(KeyError, match="unknown config"):
        load_config("imagenet")


def test_speed128_preset_equals_jax_config():
    want = jax_speed128()
    got = configs.train_config("speed128")
    _assert_same_config(got, want)
    over = configs.train_config("speed128", ["optim.lr=3e-4", "augment.warp_every=1"])
    assert over.optim.lr == 3e-4 and over.augment.warp_every == 1
    assert over.model == got.model
    with pytest.raises(KeyError):
        configs.train_config("imagenet")


def test_uint8_images_train_as_their_float_values():
    """A uint8 batch is normalised by 1/255 on the device, as the JAX step
    does: the loss equals that of the same images given as f32."""
    pcfg = port_config(jax_tiny(0.0))
    model = init_weights(PartNet(pcfg.model, device="cpu"), seed=1)
    vgg = VGG19Features(pcfg.loss.vgg_layers, pcfg.loss.vgg_trim_blocks, torch.float32)
    perc = PerceptualLoss(init_weights(vgg, seed=2), feature_resolution=pcfg.loss.vgg_resolution)
    sampler = pcfg.augment.make_sampler()
    draws = keyed_pair_draws(3, 0, np.arange(B), sampler, pcfg.augment)
    u8 = torch.from_numpy((images(22, B, 16) * 255).round().astype(np.uint8))
    loss_fn = make_loss_fn(pcfg, model, sampler, perc)
    with torch.no_grad():
        got, _ = loss_fn({"image": u8}, draws)
        want, _ = loss_fn({"image": u8.float() * (1.0 / 255.0)}, draws)
    assert torch.equal(got, want)
