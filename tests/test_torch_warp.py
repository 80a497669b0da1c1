"""Port parity: the warp ops and their kernel wrappers (``bilinear_sample``
and ``tps_warp``, band mode too), against the JAX package's
``partops.warp`` and its Pallas kernels ``bilinear_sample_fused`` and
``tps_warp_fused`` (interpret mode, as the JAX package's own tests run
them), at float32 on the CPU. On the CPU each wrapper runs its plain
version; the CUDA kernels are held against those on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: outputs 1e-5 absolute (images in [0, 1]; the Pallas kernel
folds the lerp into selector matmuls, another order of f32 products);
the TPS warps 1e-4 (JAX's own bound between its fused and flow paths:
the flow is a 28-term f32 dot whose ulps move the taps); image
cotangents 1e-5; coordinate cotangents 1e-4 (scaled by H/2 and W/2);
TPS weight cotangents 1e-3 of their largest (sums over H·W pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import partseg_tpu.partops as jp
from partseg_tpu.augment.tps import TPSSampler as JSampler
from partseg_tpu.partops.pallas import tps_warp_fused as jax_tps_warp
from partseg_tpu_torch.partops import bilinear_sample, warp_image
from partseg_tpu_torch.partops.kernels import (
    bilinear_sample_fused,
    tps_warp,
    tps_warp_plain,
)
from partseg_tpu_torch.partops.kernels.tps_warp import band_config
from _torch_parity import n, t

torch.set_num_threads(1)


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _coords(seed, b, k, lo=-1.2, hi=1.2):
    return np.random.default_rng(seed).uniform(lo, hi, (b, k, 2)).astype(np.float32)


# ------------------------------------------------------------ bilinear_sample

@pytest.mark.parametrize("mode,span", [("border", 1.2), ("zeros", 2.0)])
def test_bilinear_sample_matches_jax(mode, span):
    img, crd = _img(0, (2, 16, 24, 3)), _coords(1, 2, 100, -span, span)
    want = [np.asarray(jp.bilinear_sample(img, crd, mode, impl=impl)) for impl in ("fused", "gather")]
    for impl in ("fused", "gather", "auto"):
        got = bilinear_sample(t(img), t(crd), mode, impl=impl)
        assert got.shape == (2, 100, 3) and got.dtype == torch.float32
        for w in want:
            np.testing.assert_allclose(n(got), w, atol=1e-5)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_bilinear_sample_vjp_matches_jax(mode):
    img, crd = _img(2, (2, 8, 12, 3)), _coords(3, 2, 60)
    g = np.random.default_rng(4).standard_normal((2, 60, 3)).astype(np.float32)
    wants = []
    for impl in ("fused", "gather"):
        _, vjp = jax.vjp(lambda im, cr: jp.bilinear_sample(im, cr, mode, impl=impl), img, crd)
        wants.append([np.asarray(v) for v in vjp(jnp.asarray(g))])
    for impl in ("fused", "gather"):
        im, cr = t(img).requires_grad_(), t(crd).requires_grad_()
        out = bilinear_sample(im, cr, mode, impl=impl)
        d_im, d_cr = torch.autograd.grad(out, (im, cr), t(g))
        for w_im, w_cr in wants:
            np.testing.assert_allclose(n(d_im), w_im, atol=1e-5)
            np.testing.assert_allclose(n(d_cr), w_cr, atol=1e-4)


def test_fused_wrapper_forward_under_grad_carries_the_function():
    im, cr = t(_img(5, (1, 6, 7, 2))).requires_grad_(), t(_coords(6, 1, 9))
    out = bilinear_sample_fused(im, cr)
    assert type(out.grad_fn).__name__ == "_BilinearSampleBackward"
    with torch.no_grad():
        assert bilinear_sample_fused(im, cr).grad_fn is None


def test_grid_sample_cross_check_needs_the_xy_flip():
    """F.grid_sample (align_corners=False, border) samples the same points
    only with the coords flipped to (x, y)."""
    img, crd = _img(7, (2, 10, 14, 3)), _coords(8, 2, 40)
    want = n(bilinear_sample(t(img), t(crd), "border", impl="gather"))

    def grid_sample(c):
        out = F.grid_sample(t(img).permute(0, 3, 1, 2), c[:, None], mode="bilinear",
                            padding_mode="border", align_corners=False)
        return n(out[:, :, 0].permute(0, 2, 1))

    np.testing.assert_allclose(grid_sample(t(crd).flip(-1)), want, atol=1e-5)
    assert np.abs(grid_sample(t(crd)) - want).max() > 1e-2


def test_warp_image_identity_and_shape():
    img = _img(9, (2, 8, 8, 3))
    yy, xx = jp.coord_grid(8, 8)
    flow = np.broadcast_to(np.stack([yy, xx], -1)[None], (2, 8, 8, 2)).astype(np.float32)
    np.testing.assert_allclose(n(warp_image(t(img), t(flow), impl="fused")), img, atol=1e-6)
    want = np.asarray(jp.warp_image(img, flow * 1.1, padding_mode="zeros", impl="gather"))
    np.testing.assert_allclose(n(warp_image(t(img), t(flow * 1.1), "zeros")), want, atol=1e-5)


def test_bilinear_wrapper_rejects_what_the_kernel_does_not_take():
    im, cr = t(_img(10, (2, 6, 6, 3))), t(_coords(11, 2, 5))
    with pytest.raises(TypeError):
        bilinear_sample_fused(im.half(), cr)
    with pytest.raises(TypeError):
        bilinear_sample_fused(im, cr.double())
    with pytest.raises(ValueError):
        bilinear_sample_fused(im, cr[:1])                      # batch disagrees
    with pytest.raises(ValueError):
        bilinear_sample_fused(im.transpose(1, 2), cr)          # not contiguous
    with pytest.raises(ValueError):
        bilinear_sample(im, cr, "reflect")
    with pytest.raises(ValueError):
        bilinear_sample(im, cr, impl="pallas")


# ------------------------------------------------------------------ tps_warp

def _tps(grid, b, h, w, seed, sd=None):
    sampler = JSampler(grid_size=grid) if sd is None else JSampler(grid, sd, sd, sd, sd)
    weights = np.asarray(sampler.sample(jax.random.key(seed), b).weights)
    return weights, np.asarray(sampler.flow_basis(h, w)), sampler


def test_tps_warp_matches_jax():
    img = _img(12, (2, 16, 24, 3))
    weights, basis, sampler = _tps(4, 2, 16, 24, 7)
    got = tps_warp(t(img), t(weights), t(basis))
    want_fused = np.asarray(jax_tps_warp(img, weights, basis))
    want_flow = np.asarray(sampler.warp(type(sampler.identity(1))(weights=weights), img,
                                        impl="gather"))
    for want in (want_fused, want_flow):
        np.testing.assert_allclose(n(got), want, atol=1e-4)


def test_tps_warp_vjp_matches_jax():
    img = _img(13, (2, 12, 12, 2))
    weights, basis, _ = _tps(3, 2, 12, 12, 9)
    g = np.random.default_rng(14).standard_normal(img.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda im, wt: jax_tps_warp(im, wt, basis), img, weights)
    w_im, w_wt = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    im, wt = t(img).requires_grad_(), t(weights).requires_grad_()
    d_im, d_wt = torch.autograd.grad(tps_warp(im, wt, t(basis)), (im, wt), t(g))
    np.testing.assert_allclose(n(d_im), w_im, atol=1e-5)
    np.testing.assert_allclose(n(d_wt), w_wt, atol=1e-3 * np.abs(w_wt).max())
    # The same as autograd through the plain version (flow + gather).
    im2, wt2 = t(img).requires_grad_(), t(weights).requires_grad_()
    p_im, p_wt = torch.autograd.grad(tps_warp_plain(im2, wt2, t(basis)), (im2, wt2), t(g))
    np.testing.assert_allclose(n(d_im), n(p_im), atol=1e-5)
    np.testing.assert_allclose(n(d_wt), n(p_wt), atol=1e-3 * np.abs(w_wt).max())


@pytest.mark.parametrize("kh,sd", [(24, None), (8, 0.5)], ids=["typical", "extreme"])
def test_tps_warp_band_mode_matches_the_banded_pallas_kernel(monkeypatch, kh, sd):
    """32×32 images in tiles of 256 points (8 rows): four bands per image.
    The extreme draw (every sd 0.5) with an 8-row band makes the clamp
    bite hard: the banded warp differs from the unbanded one."""
    monkeypatch.setenv("PARTSEG_WARP_TILE", "256")
    monkeypatch.setenv("PARTSEG_WARP_BAND", str(kh))
    img = _img(15, (2, 32, 32, 3))
    weights, basis, _ = _tps(4, 2, 32, 32, 11, sd)
    assert band_config(torch.float32, 32, 32) == (kh, 256)
    got = n(tps_warp(t(img), t(weights), t(basis)))
    want = np.asarray(jax_tps_warp(img, weights, basis))
    np.testing.assert_allclose(got, want, atol=1e-4)
    if sd is not None:
        unbanded = n(tps_warp_plain(t(img), t(weights), t(basis)))
        assert np.abs(unbanded - got).max() > 1e-2


def test_band_config_follows_the_tpu_kernel(monkeypatch):
    monkeypatch.delenv("PARTSEG_WARP_TILE", raising=False)
    monkeypatch.setenv("PARTSEG_WARP_BAND", "0")
    assert band_config(torch.bfloat16, 128, 128) == (0, 4096)
    monkeypatch.setenv("PARTSEG_WARP_BAND", "50")
    assert band_config(torch.bfloat16, 128, 128) == (56, 4096)   # rounded up to 8
    assert band_config(torch.float32, 128, 128) == (56, 2048)
    assert band_config(torch.float32, 256, 256) == (56, 1024)    # tile scales by 128/H
    assert band_config(torch.float32, 48, 48)[0] == 0           # tile % W != 0
    monkeypatch.setenv("PARTSEG_WARP_BAND", "200")
    assert band_config(torch.float32, 128, 128)[0] == 0         # kh ≥ H


def test_tps_wrapper_rejects_what_the_kernel_does_not_take():
    img = t(_img(16, (2, 8, 8, 3)))
    weights, basis, _ = _tps(3, 2, 8, 8, 12)
    w, bs = t(weights), t(basis)
    with pytest.raises(TypeError):
        tps_warp(img.half(), w, bs)
    with pytest.raises(TypeError):
        tps_warp(img, w.double(), bs)
    with pytest.raises(ValueError):
        tps_warp(img, w, bs[:10])                   # basis rows ≠ H·W
    with pytest.raises(ValueError):
        tps_warp(img, w[:1], bs)                    # batch disagrees
    with pytest.raises(ValueError):
        tps_warp(img.transpose(1, 2), w, bs)        # not contiguous
