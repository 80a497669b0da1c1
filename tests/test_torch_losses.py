"""Port parity: the losses (VGG features, perceptual, equivariance) and
the optimizer, against the JAX package's and optax, at float32 on the CPU.

Tolerances: VGG features and losses 1e-5 relative to their scale (f32
convolutions and means in another sum order); their gradients 1e-5 of
the largest entry; the optimizer's params and moments 1e-6 relative (the
same f32 arithmetic, grouped differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from partseg_tpu.augment.tps import TPSSampler as JSampler
from partseg_tpu.losses.equivariance import equivariance_loss as jax_equivariance
from partseg_tpu.losses.perceptual import PerceptualLoss as JPerceptual
from partseg_tpu.losses.vgg import VGG19Features as JVGG
from partseg_tpu.losses.vgg import random_vgg19_params
from partseg_tpu.train.config import OptimConfig as JOptim
from partseg_tpu.train.state import make_optimizer as jax_make_optimizer
from partseg_tpu_torch import convert
from partseg_tpu_torch.augment import TPSParams, TPSSampler
from partseg_tpu_torch.losses import PerceptualLoss, VGG19Features, equivariance_loss, load_vgg19
from partseg_tpu_torch.train import OptimConfig, make_optimizer
from partseg_tpu_torch.train.state import warmup_cosine
from _torch_parity import images, n, t

torch.set_num_threads(1)

EXTRACT = ("relu1_2", "relu2_1")


@pytest.fixture(scope="module")
def vgg_pair():
    jm = JVGG(extract=EXTRACT, trim_blocks=2, dtype=jnp.float32)
    params = random_vgg19_params(jm, 16)
    pm = VGG19Features(EXTRACT, trim_blocks=2, dtype=torch.float32)
    convert.load_flax_params(pm, jax.tree_util.tree_map(np.asarray, params), root="vgg")
    return jm, params, pm


def test_vgg_features_match(vgg_pair):
    jm, params, pm = vgg_pair
    assert pm.layers == [(1, 1), (1, 2), (2, 1)]              # stops at the deepest asked
    x = images(0, 2, 16)
    want = jm.apply(params, x)
    got = pm(t(x))
    assert set(got) == set(want) == set(EXTRACT)
    for k in EXTRACT:
        w = np.asarray(want[k])
        np.testing.assert_allclose(n(got[k].permute(0, 2, 3, 1)), w, atol=1e-5 * np.abs(w).max())


def test_load_vgg19_reads_npz_or_reports_random_torch(vgg_pair, tmp_path, monkeypatch):
    _, params, pm = vgg_pair
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("VGG19_NPZ", raising=False)
    a, b = (VGG19Features(EXTRACT, 2, torch.float32) for _ in range(2))
    with pytest.warns(UserWarning, match="random-torch"):
        assert load_vgg19(a) == "random-torch"
    with pytest.warns(UserWarning):
        load_vgg19(b)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)     # seeded
    flat = convert.flatten_params(jax.tree_util.tree_map(np.asarray, params))
    np.savez(tmp_path / "vgg19.npz", **flat)                  # HWIO, the JAX package's format
    c = VGG19Features(EXTRACT, 2, torch.float32)
    assert load_vgg19(c) == f"pretrained:vgg19.npz"
    for k, v in pm.state_dict().items():
        torch.testing.assert_close(c.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("res", [None, 8])
def test_perceptual_loss_and_grad_match(vgg_pair, res):
    _, params, pm = vgg_pair
    jl = JPerceptual(params, extract=EXTRACT, layer_weights=(1.0, 0.5), pixel_weight=0.7,
                     trim_blocks=2, feature_resolution=res, dtype=jnp.float32)
    pl = PerceptualLoss(pm, layer_weights=(1.0, 0.5), pixel_weight=0.7, feature_resolution=res)
    x_hat, x = images(1, 2, 16 if res is None else 8), images(2, 2, 16)
    want, w_grad = jax.value_and_grad(jl)(jnp.asarray(x_hat), jnp.asarray(x))
    xh = t(x_hat).requires_grad_()
    got = pl(xh, t(x))
    (g_grad,) = torch.autograd.grad(got, xh)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(n(g_grad), np.asarray(w_grad), atol=1e-5 * np.abs(w_grad).max())
    assert all(not p.requires_grad for p in pl.parameters())


def test_equivariance_loss_and_grads_match():
    js = JSampler(grid_size=3)
    w = np.asarray(js.sample(jax.random.key(3), 2).weights)
    rng = np.random.default_rng(4)
    mu_s, mu_a = (rng.uniform(-0.8, 0.8, (2, 5, 2)).astype(np.float32) for _ in range(2))
    a = 0.1 * rng.standard_normal((2, 2, 5, 2, 2)).astype(np.float32)
    sig_s, sig_a = (np.einsum("...ij,...kj->...ik", m, m) + 0.01 * np.eye(2, dtype=np.float32)
                    for m in a)

    def jf(ms, ss):
        loss, m = jax_equivariance(js, type(js.identity(1))(weights=w), ms, ss, mu_a, sig_a, 0.7)
        return loss, m

    (want, wm), (g_mu, g_sig) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(mu_s, sig_s)
    ms, ss = t(mu_s).requires_grad_(), t(sig_s).requires_grad_()
    got, gm = equivariance_loss(TPSSampler(grid_size=3), TPSParams(t(w)), ms, ss, t(mu_a),
                                t(sig_a), 0.7)
    d_mu, d_sig = torch.autograd.grad(got, (ms, ss))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5)
    for k in ("equiv_mu", "equiv_sigma"):
        np.testing.assert_allclose(n(gm[k]), np.asarray(wm[k]), rtol=1e-5)
    np.testing.assert_allclose(n(d_mu), np.asarray(g_mu), atol=1e-5 * np.abs(g_mu).max())
    np.testing.assert_allclose(n(d_sig), np.asarray(g_sig), atol=1e-5 * np.abs(g_sig).max())


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_matches_optax_across_the_clip_threshold(weight_decay):
    """Six updates whose gradient norms alternate above and below
    grad_clip = 1, through the warmup (3 steps) into the cosine decay."""
    cfg = dict(lr=1e-2, warmup_steps=3, decay_steps=8, end_lr_factor=0.1, b1=0.9, b2=0.999,
               weight_decay=weight_decay, grad_clip=1.0)
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    jopt = jax_make_optimizer(JOptim(**cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jparams)
    model = torch.nn.Module()
    for k, v in p0.items():
        model.register_parameter(k, torch.nn.Parameter(t(v)))
    popt = make_optimizer(OptimConfig(**cfg))
    pstate = popt.init(model)
    norms = []
    for i in range(6):
        scale = 3.0 if i % 2 == 0 else 0.05
        g = {k: (scale * rng.standard_normal(v.shape) / 4).astype(np.float32) for k, v in p0.items()}
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = popt.update(model, [t(g["a"]), t(g["b"])], pstate)
        norms.append(float(norm))
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for k in p0:
            np.testing.assert_allclose(n(getattr(model, k)), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(n(pstate.mu[k]), np.asarray(jstate[1][0].mu[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(n(pstate.nu[k]), np.asarray(jstate[1][0].nu[k]),
                                       rtol=1e-6, atol=1e-12)
    assert max(norms) > 1.0 > min(norms)
    assert pstate.count == 6


def test_schedule_matches_optax():
    cfg = OptimConfig(lr=1e-3, warmup_steps=500, decay_steps=200_000)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 500, 200_000, 1e-4)
    mine = warmup_cosine(cfg)
    for count in (0, 1, 250, 499, 500, 501, 50_000, 199_999, 200_000, 300_000):
        np.testing.assert_allclose(mine(count), float(sched(count)), rtol=1e-6, atol=1e-12)
    assert mine(0) == 0.0
