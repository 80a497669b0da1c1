"""Port parity: partseg_tpu_torch.augment (TPS sampler, colour jitter,
paired augmentation) against the JAX package's, at float32 on the CPU.
Evaluation and application take the same draws (made in JAX, passed as
numpy); sampling is compared by its distribution only, since
``torch.Generator`` cannot reproduce ``jax.random``.

Tolerances: 1e-6 for tables computed by the same numpy code or the same
f32 expression; 1e-5 for evaluations whose f32 sums run in another order
(flow, points, colour matrices); 1e-4 for the Jacobian (log terms near
the control points) and for TPS-warped images (the flow's ulps move the
taps, JAX's own bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partseg_tpu.augment.color import color_jitter as jax_color_jitter
from partseg_tpu.augment.color import sample_color_params as jax_sample_color
from partseg_tpu.augment.pair import AugmentConfig as JAugment
from partseg_tpu.augment.pair import make_pair as jax_make_pair
from partseg_tpu.augment.tps import TPSParams as JTPSParams
from partseg_tpu.augment.tps import TPSSampler as JSampler
from partseg_tpu_torch.augment import (
    AugmentConfig,
    ColorParams,
    TPSParams,
    TPSSampler,
    color_jitter,
    make_pair,
    sample_color_params,
    sample_pair_draws,
)
from _torch_parity import images, n, t

torch.set_num_threads(1)


def _samplers(grid=5, sd=0.1):
    return JSampler(grid, sd, sd, sd, sd), TPSSampler(grid, sd, sd, sd, sd)


def test_tps_tables_match():
    js, ps = _samplers()
    np.testing.assert_array_equal(n(ps.flow_basis(16, 24)), np.asarray(js.flow_basis(16, 24)))
    np.testing.assert_allclose(n(ps.identity(3).weights), np.asarray(js.identity(3).weights),
                               atol=1e-6)
    assert ps.n_ctrl == js.n_ctrl == 25


def test_tps_evaluation_matches_on_the_same_weights():
    js, ps = _samplers(grid=4)
    w = np.asarray(js.sample(jax.random.key(0), 3).weights)
    jp_, pp = JTPSParams(weights=w), TPSParams(t(w))
    np.testing.assert_allclose(n(ps.flow_field(pp, 12, 20)), np.asarray(js.flow_field(jp_, 12, 20)),
                               atol=1e-5)
    pts = np.random.default_rng(1).uniform(-1, 1, (3, 7, 2)).astype(np.float32)
    pts[0, 0] = [-1.0 / 3.0, 1.0]                    # on a control point: U'(0) branch
    np.testing.assert_allclose(n(ps.transform_points(pp, t(pts))),
                               np.asarray(js.transform_points(jp_, pts)), atol=1e-5)
    np.testing.assert_allclose(n(ps.jacobian(pp, t(pts))), np.asarray(js.jacobian(jp_, pts)),
                               atol=1e-4)
    # The identity warp maps points to themselves with J = I.
    ident = ps.identity(3)
    np.testing.assert_allclose(n(ps.transform_points(ident, t(pts))), pts, atol=1e-5)
    np.testing.assert_allclose(n(ps.jacobian(ident, t(pts))),
                               np.broadcast_to(np.eye(2), (3, 7, 2, 2)), atol=1e-4)


def test_tps_sample_has_the_jax_distribution():
    """T interpolates its targets, so T(c) − c over the control points c is
    the similarity's displacement plus the control noise. Compare its mean
    and std per control point over 4000 draws from each framework."""
    js, ps = _samplers(grid=3, sd=0.1)
    b = 4000
    ctrl = np.asarray(js._ctrl)
    pts = np.broadcast_to(ctrl, (b,) + ctrl.shape)
    jw = js.sample(jax.random.key(2), b)
    pw = ps.sample(torch.Generator().manual_seed(2), b)
    jd = np.asarray(js.transform_points(jw, pts)) - ctrl
    pd = n(ps.transform_points(pw, t(pts))) - ctrl
    # Standard error of a mean over 4000 draws of sd ≤ 0.2: ≤ 0.0032.
    np.testing.assert_allclose(pd.mean(0), jd.mean(0), atol=0.015)
    np.testing.assert_allclose(pd.std(0), jd.std(0), rtol=0.08)
    assert pw.weights.shape == (b, 12, 2) and pw.weights.dtype == torch.float32


def test_color_jitter_matches_on_the_same_params():
    img = images(3, 4, 8)
    col = jax_sample_color(jax.random.key(4), 4, 0.1, 0.3, 0.3, 0.3)
    pc = ColorParams(*(t(getattr(col, f.name)) for f in dataclasses.fields(ColorParams)))
    np.testing.assert_allclose(n(color_jitter(t(img), pc)), np.asarray(jax_color_jitter(img, col)),
                               atol=1e-5)
    ident = ColorParams(torch.zeros(4), torch.ones(4), torch.ones(4), torch.zeros(4))
    np.testing.assert_allclose(n(color_jitter(t(img), ident)), img, atol=1e-5)
    out = color_jitter(t(img).to(torch.bfloat16), pc)
    assert out.dtype == torch.bfloat16


def test_sample_color_params_ranges():
    p = sample_color_params(torch.Generator().manual_seed(5), 2000, 0.1, 0.3, 0.2, 0.4)
    for v, lo, hi in ((p.brightness, -0.1, 0.1), (p.contrast, 0.7, 1.3),
                      (p.saturation, 0.8, 1.2), (p.hue, -0.4, 0.4)):
        assert v.shape == (2000,) and lo <= v.min().item() and v.max().item() <= hi
        assert abs(v.mean().item() - (lo + hi) / 2) < 0.05 * (hi - lo)


@pytest.mark.parametrize("warp_on", [True, False])
def test_make_pair_matches_jax_on_the_same_draws(warp_on):
    jcfg = JAugment(tps_grid=3, warp_fraction=0.5)
    pcfg = AugmentConfig(**dataclasses.asdict(jcfg))
    js, ps = jcfg.make_sampler(), pcfg.make_sampler()
    x = images(6, 4, 16)
    key = jax.random.key(7)
    want = jax_make_pair(jnp.asarray(x), key, js, jcfg, warp_on=warp_on)
    k_tps, k_col, _ = jax.random.split(key, 3)
    tps = TPSParams(t(js.sample(k_tps, 4).weights))
    c = jax_sample_color(k_col, 4, jcfg.brightness, jcfg.contrast, jcfg.saturation, jcfg.hue)
    col = ColorParams(*(t(getattr(c, f.name)) for f in dataclasses.fields(ColorParams)))
    got = make_pair(t(x), tps, col, ps, pcfg, warp_on=warp_on)
    np.testing.assert_allclose(n(got["x_s"]), np.asarray(want["x_s"]), atol=1e-4)
    np.testing.assert_allclose(n(got["x_a"]), np.asarray(want["x_a"]), atol=1e-5)
    np.testing.assert_allclose(n(got["tps"].weights), np.asarray(want["tps"].weights), atol=1e-6)
    # The tail (and the whole batch when off) passes through unwarped.
    tail = slice(2, None) if warp_on else slice(None)
    np.testing.assert_array_equal(n(got["x_s"][tail]), x[tail])
    if warp_on:
        assert np.abs(n(got["x_s"][:2]) - x[:2]).max() > 1e-3


def test_make_pair_options():
    cfg = AugmentConfig(tps_grid=3, warp_appearance_view=True)
    s = cfg.make_sampler()
    x = t(images(8, 2, 16))
    draws = sample_pair_draws(torch.Generator().manual_seed(9), 2, s, cfg)
    assert draws.tps2 is not None
    out = make_pair(x, draws.tps, draws.color, s, cfg, tps2=draws.tps2)
    jittered = color_jitter(x, draws.color)
    assert np.abs(n(out["x_a"]) - n(jittered)).max() > 1e-3            # x_a warped too
    with pytest.raises(ValueError):
        make_pair(x, draws.tps, draws.color, s, cfg)                     # tps2 missing
    with pytest.raises(ValueError):
        make_pair(x, draws.tps, draws.color, s,
                  dataclasses.replace(cfg, warp_fraction=0.0, warp_appearance_view=False))
