"""Port parity: the kernel wrappers softmax_moments and render_assemble.

On the CPU each wrapper runs its plain PyTorch version; that is held
against the JAX package's Pallas kernel (interpret mode, as the JAX
package's own tests run it) and against the JAX plain path
(``use_pallas=False``), at float32. The CUDA kernels themselves run only
on a card: tests/test_torch_cuda.py holds them against these plain
versions there (and chip_smoke.py at the serving shapes).

Tolerances: 1e-5 absolute for μ, Σ and the render output (f32 sums of
H·W or K terms in another order); parts rtol 1e-5 (one exp and one
division per element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import partseg_tpu.partops as jp
from partseg_tpu.partops.pallas import render_assemble as jax_render_assemble
from partseg_tpu.partops.pallas import softmax_moments as jax_softmax_moments
from partseg_tpu_torch.partops import precision_from_cov
from partseg_tpu_torch.partops.kernels import (
    _build,
    render_assemble,
    softmax_moments,
)
from _torch_parity import n, t

torch.set_num_threads(1)


def _logits(seed, b=2, h=16, w=16, k=4, delta=False):
    x = 3.0 * np.random.default_rng(seed).standard_normal((b, h, w, k + 1)).astype(np.float32)
    if delta:
        x[:, 4, 9, :k] = 80.0        # one-hot part maps: a singular Σ
    return x


def _render_inputs(seed, b=2, k=5, c=7, singular=False):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-0.7, 0.7, (b, k, 2)).astype(np.float32)
    a = (0.1 * rng.standard_normal((b, k, 2, 2))).astype(np.float32)
    sigma = (np.einsum("...ij,...kj->...ik", a, a) + 0.01 * np.eye(2)).astype(np.float32)
    if singular:
        sigma[:, 0] = 0.0
    lam = np.asarray(jp.precision_from_cov(sigma))
    app = rng.standard_normal((b, k, c)).astype(np.float32)
    return mu, sigma, lam, app


# ------------------------------------------------------------ softmax_moments

@pytest.mark.parametrize("delta", [False, True])
def test_softmax_moments_matches_jax(delta):
    x = _logits(0, delta=delta)
    k = x.shape[-1] - 1
    fg = t(x)[..., :k]                       # strided slice, as PartNet passes it
    assert not fg.is_contiguous()
    parts, mu, sigma = softmax_moments(fg)
    for want in (jax_softmax_moments(jnp.asarray(x[..., :k])),
                 (lambda p: (p, *jp.soft_argmax_moments(p)))(jp.spatial_softmax(x[..., :k]))):
        np.testing.assert_allclose(n(parts), np.asarray(want[0]), rtol=1e-5, atol=1e-30)
        np.testing.assert_allclose(n(mu), np.asarray(want[1]), atol=1e-5)
        np.testing.assert_allclose(n(sigma), np.asarray(want[2]), atol=1e-5)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in (parts, mu, sigma))
    lam = precision_from_cov(sigma)
    assert torch.isfinite(lam).all()


def test_softmax_moments_rejects_what_the_kernel_does_not_take():
    x = t(_logits(1))
    with pytest.raises(TypeError):
        softmax_moments(x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        softmax_moments(x[0])                         # rank 3
    with pytest.raises(ValueError):
        softmax_moments(x[:, ::2])                    # rows skipped: pixels unevenly spaced
    with pytest.raises(ValueError):
        softmax_moments(x.permute(0, 3, 1, 2))        # parts not adjacent
    with pytest.raises(ValueError):
        softmax_moments(x[:0])                        # empty


# ------------------------------------------------------------ render_assemble

@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
@pytest.mark.parametrize("singular", [False, True])
def test_render_assemble_matches_jax(kernel, singular):
    mu, sigma, lam, app = _render_inputs(2, singular=singular)
    h, w = 16, 32
    got = render_assemble(t(mu), t(lam), t(app), h, w, kernel)
    pallas = jax_render_assemble(mu, lam, app, h, w, kernel)
    plain = jp.assemble_decoder_input(
        jp.render_gaussians(mu, sigma, h, w, kernel=kernel, precision=lam), app)
    for want in (pallas, plain):
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()


def test_render_assemble_takes_bf16_appearance_summed_in_f32():
    mu, _, lam, app = _render_inputs(3)
    app_bf16 = torch.from_numpy(app).to(torch.bfloat16)
    got = render_assemble(t(mu), t(lam), app_bf16, 8, 8)
    want = jax_render_assemble(mu, lam, jnp.asarray(app, jnp.bfloat16), 8, 8, "gauss")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def test_render_assemble_rejects_what_the_kernel_does_not_take():
    mu, _, lam, app = (t(v) for v in _render_inputs(4))
    with pytest.raises(ValueError):
        render_assemble(mu, lam, app, 8, 8, "box")
    with pytest.raises(TypeError):
        render_assemble(mu.double(), lam, app, 8, 8)
    with pytest.raises(TypeError):
        render_assemble(mu, lam, app.half(), 8, 8)
    with pytest.raises(ValueError):
        render_assemble(mu[:, :3], lam, app, 8, 8)              # K disagrees
    with pytest.raises(ValueError):
        render_assemble(mu, lam, app.transpose(1, 2).contiguous().transpose(1, 2), 8, 8)
    big = torch.zeros((1, 33, 4))
    with pytest.raises(ValueError):                             # K > 32
        render_assemble(torch.zeros((1, 33, 2)), torch.zeros((1, 33, 2, 2)), big, 8, 8)
    with pytest.raises(ValueError):                             # K·C beyond shared memory
        render_assemble(torch.zeros((1, 16, 2)), torch.zeros((1, 16, 2, 2)),
                        torch.zeros((1, 16, 1024)), 8, 8)


def test_kernel_modules_import_and_run_on_cpu_without_building():
    """Importing the wrappers and running them on CPU tensors needs no
    nvcc, no triton and no GPU: nothing is built or loaded."""
    mu, _, lam, app = (t(v) for v in _render_inputs(5))
    before = (softmax_moments.launches, render_assemble.launches)
    softmax_moments(t(_logits(5)))
    render_assemble(mu, lam, app, 8, 8)
    assert (softmax_moments.launches, render_assemble.launches) == before
    assert _build.library.cache_info().currsize == 0
    assert sorted(p.name for p in _build.CSRC_DIR.glob("*.cu")) == [
        "errors.cu", "render_assemble.cu", "softmax_moments.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS
