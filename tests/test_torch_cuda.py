"""The port's CUDA kernels and model on the card, against the port's own
plain versions. Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor tests/_torch_parity.py, so on a machine
with a card and without JAX it runs on its own:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

f32 comparisons set TF32 off (cuDNN's f32 convolutions default to it).
Tolerances: parts rtol 1e-5 (one exp and one division per element); μ,
Σ atol 1e-5 (sums of H·W f32 terms in another order); render output
atol 1e-5·max|out| (K products per element); warps 1e-4 (the TPS flow is
a 28-term dot in another order) and 1e-6 at given coordinates (the same
taps and weights; only the lerp's products may fuse); bf16 warps against
the f32 plain version cast once: one bf16 ulp at values below 1 (2⁻⁸);
cotangents 1e-4 of their largest (sums over H·W in another order, with
atomics for the warps' image cotangents); the render_assemble backward
kernel against its closed form 1e-5 of each cotangent's largest (the same
f32 products summed over tiles in another order; a bf16 d_app may round
to the neighbouring bf16 value: one ulp, at most 2⁻⁷ of it); whole-model outputs and
training metrics 1e-4 of their scale (tens of f32 layers).
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from partseg_tpu_torch import tracing
from partseg_tpu_torch.augment import TPSParams, TPSSampler
from partseg_tpu_torch.evals import export_infer, load_exported, make_infer_fn, transfer_batch
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from partseg_tpu_torch.partops import bilinear_sample
from partseg_tpu_torch.partops.kernels import (
    bilinear_sample_fused,
    render_assemble,
    render_assemble_plain,
    softmax_moments,
    softmax_moments_plain,
    tps_warp,
    tps_warp_plain,
)
from partseg_tpu_torch.partops.kernels.bilinear_sample import (
    bilinear_sample_plain,
    sample_with_grads,
)
from partseg_tpu_torch.partops.kernels.render_assemble import (
    render_assemble_backward,
    render_assemble_vjp,
)
from partseg_tpu_torch.partops.kernels import _build
from partseg_tpu_torch.partops.kernels.tps_warp import (
    band_config,
    kernel_order_flow,
    launch_plan,
    tps_flow,
    tps_sample_plain,
)
from partseg_tpu_torch.partops.warp import gather_sample
from partseg_tpu_torch.partops.moments import precision_from_cov
from partseg_tpu_torch.train import (
    LossConfig,
    OptimConfig,
    TrainConfig,
    build_perceptual,
    create_state,
    make_train_period,
)
from partseg_tpu_torch.augment import AugmentConfig, keyed_pair_draws

pytestmark = pytest.mark.cuda

BACKWARD = "kernel.render_assemble.backward_launches"


def launches(kernel: str) -> int:
    """The registry's count of ``kernel``'s forward launches (``tracing``)."""
    return tracing.counter(f"kernel.{kernel}.launches")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _logits(seed, b, size, k, delta=False):
    x = 3.0 * np.random.default_rng(seed).standard_normal((b, size, size, k + 1))
    if delta:
        x[:, 4, 9, :k] = 80.0        # one-hot part maps: a singular Σ
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("delta", [False, True])
def test_softmax_moments_kernel_matches_plain(cuda, delta):
    fg = _logits(6, 4, 64, 10, delta).to(cuda)[..., :10]
    before = launches("softmax_moments")
    got = softmax_moments(fg)
    want = softmax_moments_plain(fg)
    torch.cuda.synchronize()
    assert launches("softmax_moments") == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("b,h,w,k", [
    (256, 64, 64, 10), (128, 32, 32, 10),     # celeba serving, speed128 training
    (1, 64, 64, 10), (1, 128, 128, 10),       # one image: 8 CTAs; a run staged above 48 KB
    (1, 256, 256, 10),                        # a run too large to stage: read twice
    (2, 17, 13, 3), (3, 17, 13, 7),           # odd K; H·W not a multiple of 4
    (3, 17, 13, 10),                          # images 2 and 3 start off 16-byte alignment
])
def test_softmax_moments_kernel_shapes(cuda, b, h, w, k, delta):
    """Every launch shape of the cluster kernel, through the strided
    [..., :K] view of K+1 logits, against the plain version; two calls
    give the same bits (no atomics, sums in a fixed order)."""
    x = 3.0 * np.random.default_rng(b * 1000 + h * 10 + k).standard_normal((b, h, w, k + 1))
    if delta:
        x[:, h // 3, w // 2, :k] = 80.0          # one-hot part maps: a singular Σ
    fg = torch.from_numpy(x.astype(np.float32)).to(cuda)[..., :k]
    got = softmax_moments(fg)
    want = softmax_moments_plain(fg)
    again = softmax_moments(fg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,c", [(16, 256), (128, 32), (20, 3)])
def test_render_assemble_kernel_matches_plain(cuda, kernel, dtype, res, c):
    _, mu, sigma = softmax_moments_plain(_logits(7, 3, 32, 10, delta=True)[..., :10])
    lam = precision_from_cov(sigma)
    app = torch.randn((3, 10, c), generator=torch.Generator().manual_seed(1))
    mu, lam, app = mu.to(cuda), lam.to(cuda), app.to(cuda, dtype)
    before = launches("render_assemble")
    got = render_assemble(mu, lam, app, res, res, kernel)
    want = render_assemble_plain(mu, lam, app, res, res, kernel)
    torch.cuda.synchronize()
    assert launches("render_assemble") == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("c", [1, 3, 24, 256])
def test_render_assemble_kernel_odd_shapes(cuda, k, c):
    """Every register tile of parts (K ≤ 4, ≤ 12, ≤ 32), channel counts
    with and without a ragged quad, and 13×11 pixels: a partial tile."""
    rng = np.random.default_rng(k * 1000 + c)
    mu = torch.from_numpy(rng.uniform(-0.8, 0.8, (2, k, 2)).astype(np.float32)).to(cuda)
    lam = torch.from_numpy(np.tile(np.diag([9.0, 16.0]).astype(np.float32), (2, k, 1, 1))).to(cuda)
    app = torch.from_numpy(rng.standard_normal((2, k, c)).astype(np.float32)).to(cuda)
    got = render_assemble(mu, lam, app, 13, 11)
    want = render_assemble_plain(mu, lam, app, 13, 11)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("k", [13, 16])
@pytest.mark.parametrize("res,c", [(16, 256), (32, 128), (64, 64), (128, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_render_assemble_kernel_sixteen_part_tile(cuda, k, res, c, dtype):
    """The 16-part register tile (13 <= K <= 16) at the K = 16 decoder's four
    scales (deepfashion, human36m, penn_action) at B = 4, against the plain
    version; two calls give the same bits."""
    _, mu, sigma = softmax_moments_plain(_logits(40 + k, 4, 32, k)[..., :k])
    lam = precision_from_cov(sigma)
    app = torch.randn((4, k, c), generator=torch.Generator().manual_seed(res + k))
    mu, lam, app = mu.to(cuda).contiguous(), lam.to(cuda).contiguous(), app.to(cuda, dtype)
    before = launches("render_assemble")
    got = render_assemble(mu, lam, app, res, res)
    again = render_assemble(mu, lam, app, res, res)
    want = render_assemble_plain(mu, lam, app, res, res)
    torch.cuda.synchronize()
    assert launches("render_assemble") == before + 2 and torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def _backward_inputs(cuda, k=10, c=24, b=3, indefinite=False, seed=11):
    _, mu, sigma = softmax_moments_plain(_logits(seed, b, 32, k)[..., :k])
    lam = precision_from_cov(sigma)
    if indefinite:                   # Λ with a negative eigenvalue: the d ≥ 0 clamp acts
        lam[:, 0] = torch.tensor([[4.0, 0.0], [0.0, -9.0]])
    app = torch.randn((b, k, c), generator=torch.Generator().manual_seed(seed))
    return mu.to(cuda).contiguous(), lam.to(cuda).contiguous(), app.to(cuda)


@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,k,c,indefinite", [(32, 10, 24, False), (16, 10, 48, True),
                                                (8, 10, 96, False), (13, 3, 3, True),
                                                (8, 10, 1000, False)])
def test_render_assemble_backward_kernel_matches_closed_form(cuda, kernel, dtype, res, k, c,
                                                             indefinite):
    """The backward kernel against render_assemble_vjp on the same inputs:
    the training decoder's three scales, a ragged 13² tile with an odd K
    and an indefinite Λ where the clamp is active, and C = 1000, which the
    kernel walks in eight channel chunks."""
    mu, lam, app = _backward_inputs(cuda, k=k, c=c, indefinite=indefinite)
    app = app.to(dtype)
    g = torch.randn((3, res, res, c), generator=torch.Generator().manual_seed(12)).to(cuda)
    before = tracing.counter(BACKWARD)
    got = render_assemble_backward(mu, lam, app, res, res, kernel, g)
    want = render_assemble_vjp(mu, lam, app, res, res, kernel, g)
    torch.cuda.synchronize()
    assert tracing.counter(BACKWARD) == before + 1
    assert [v.dtype for v in got] == [torch.float32, torch.float32, dtype]
    for name, a, b in zip(("d_mu", "d_lam", "d_app"), got, want):
        scale = b.float().abs().max().item()
        rtol = 2 ** -7 if (name == "d_app" and dtype == torch.bfloat16) else 0.0
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=1e-5 * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert not got[1][..., 1, 0].any()
    again = render_assemble_backward(mu, lam, app, res, res, kernel, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))       # a fixed summation order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,res,k,c", [
    (128, 8, 10, 96), (128, 16, 10, 48), (128, 32, 10, 24),   # speed128: one cluster per image
    (4, 64, 10, 64), (2, 128, 10, 32),                        # celeba 64², 128²: partial sums
    (3, 32, 7, 30), (5, 64, 5, 13),                           # odd K, C not a multiple of 4
    (2, 24, 12, 128), (2, 20, 1, 4),                          # 32 and 1 lanes to a pixel row
    (2, 40, 13, 8),                                           # K > 12: a group of 16 parts
    (64, 16, 10, 256),                                        # the flagship's 16²×256: 2 chunks
    (4, 16, 16, 256), (4, 32, 16, 128),                       # deepfashion's K = 16 decode
    (4, 64, 16, 64), (4, 128, 16, 32),
    (2, 24, 17, 256), (2, 48, 17, 256),                       # two groups, two chunks; partials
    (2, 40, 32, 48), (2, 32, 10, 129),                        # K = 32; a chunk of one channel
    (2, 32, 10, 300),                                         # 3 chunks on 2 CTAs: an empty pass
])
def test_render_assemble_backward_kernel_paths(cuda, dtype, b, res, k, c):
    """Each path of the backward kernel against render_assemble_vjp: one
    cluster per image and part group (up to 8 tiles) and partial sums with
    a finish launch, every row width, one and two part groups (K = 13, 16,
    17, 32), and channels in chunks of 128 (C = 129, 256, 300), taken one
    after the other or by CTAs of a cluster side by side; repeats give the
    same bits."""
    mu, lam, app = _backward_inputs(cuda, k=k, c=c, b=b, seed=res + c)
    app = app.to(dtype)
    g = torch.randn((b, res, res, c), generator=torch.Generator().manual_seed(res)).to(cuda)
    got = render_assemble_backward(mu, lam, app, res, res, "gauss", g)
    want = render_assemble_vjp(mu, lam, app, res, res, "gauss", g)
    again = render_assemble_backward(mu, lam, app, res, res, "gauss", g)
    torch.cuda.synchronize()
    for name, a, w in zip(("d_mu", "d_lam", "d_app"), got, want):
        scale = w.float().abs().max().item()
        rtol = 2 ** -7 if (name == "d_app" and dtype == torch.bfloat16) else 0.0
        torch.testing.assert_close(a.float(), w.float(), rtol=rtol, atol=1e-5 * scale,
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert got[2].dtype == dtype
    assert all(torch.equal(a, w) for a, w in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 4, 8])
def test_bilinear_sample_kernel_odd_shapes(cuda, dtype, c):
    """Both variants at channel counts of every kernel (C ≤ 4 staged, 8
    the per-point loop), 1037 points per image (not a multiple of either
    block, and the second image's output starts unaligned), coordinates
    beyond the border and NaN. A NaN coordinate clamps like one far below
    -1 (the plain version's floor of NaN has no defined tap)."""
    gen = torch.Generator().manual_seed(c)
    img = torch.rand((2, 17, 23, c), generator=gen).to(cuda, dtype)
    crd = torch.rand((2, 1037, 2), generator=gen) * 3.0 - 1.5
    crd[0, 5, 0] = crd[1, 700, 1] = crd[1, 1036, 0] = float("nan")
    crd = crd.to(cuda)
    finite = torch.nan_to_num(crd, nan=-3.0)
    before = launches("bilinear_sample")
    got = bilinear_sample_fused(img, crd)
    want = bilinear_sample_plain(img.float(), finite).to(dtype)
    grads = sample_with_grads(img, crd)
    plain = bilinear_sample_plain(img, finite, with_grads=True)
    torch.cuda.synchronize()
    assert launches("bilinear_sample") == before + 2 and got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8 + 1e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    for a, b in zip(grads, plain):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_kernel_wrappers_raise_on_the_card(cuda):
    with pytest.raises(TypeError):
        softmax_moments(torch.zeros((1, 8, 8, 3), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        render_assemble(torch.zeros((1, 33, 2), device=cuda), torch.zeros((1, 33, 2, 2), device=cuda),
                        torch.zeros((1, 33, 4), device=cuda), 8, 8)
    img = torch.zeros((1, 8, 8, 3), device=cuda)
    with pytest.raises(ValueError):              # (y, x) pairs not 8-byte aligned
        bilinear_sample_fused(img, torch.zeros(17, device=cuda)[1:].reshape(1, 8, 2))


def test_partnet_on_card_matches_cpu(cuda):
    cfg = PartNetConfig(n_parts=4, img_size=32, features=16, depth=2, app_features=8,
                        decoder_scales=2, decoder_features=(16, 8), use_pallas=True,
                        dtype=torch.float32)
    cpu = init_weights(PartNet(cfg, device="cpu"), seed=0).eval()
    gpu = PartNet(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.eval()
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    xa = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    want = make_infer_fn(cpu)(xs)
    want["recon"] = transfer_batch(cpu, xs, xa)
    sm, ra = launches("softmax_moments"), launches("render_assemble")
    got = make_infer_fn(gpu)(xs.to(cuda))
    got["recon"] = transfer_batch(gpu, xs.to(cuda), xa.to(cuda))
    assert (launches("softmax_moments") - sm, launches("render_assemble") - ra) == (3, 2)
    for key in ("logits", "heatmaps", "landmarks", "sigma", "recon"):
        scale = want[key].abs().max().item()
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0, atol=1e-4 * scale,
                                   msg=key)
    torch.testing.assert_close(got["seg"].cpu(), want["seg"])


def _grad_pair(fn, plain, inputs, seed=0):
    """Cotangents of fn's and plain's inputs under the same output cotangents."""
    res = []
    for f in (fn, plain):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        outs = f(*xs)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        g = torch.Generator(device=xs[0].device).manual_seed(seed)
        cots = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype) for o in outs]
        res.append(torch.autograd.grad(outs, xs, cots))
    return res


def _close_scaled(got, want, rel=1e-4):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=rel * b.abs().max().item())


@pytest.mark.parametrize("delta", [False, True])
def test_softmax_moments_grad_matches_plain(cuda, delta):
    x = _logits(8, 4, 32, 10, delta).to(cuda)
    got, want = _grad_pair(lambda v: softmax_moments(v[..., :10]),
                           lambda v: softmax_moments_plain(v[..., :10]), [x])
    _close_scaled(got, want)


@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
def test_render_assemble_grad_matches_plain(cuda, kernel):
    _, mu, sigma = softmax_moments_plain(_logits(9, 3, 32, 10)[..., :10])
    lam = precision_from_cov(sigma)
    app = torch.randn((3, 10, 24), generator=torch.Generator().manual_seed(2))
    ins = [v.to(cuda).contiguous() for v in (mu, lam, app)]
    got, want = _grad_pair(lambda m, l, a: render_assemble(m, l, a, 32, 32, kernel),
                           lambda m, l, a: render_assemble_plain(m, l, a, 32, 32, kernel), ins)
    _close_scaled(got, want)


def _warp_inputs(cuda, b=3, h=40, w=48):
    sampler = TPSSampler()
    gen = torch.Generator().manual_seed(3)
    img = torch.rand((b, h, w, 3), generator=gen).to(cuda)
    weights = sampler.sample(gen, b).weights.to(cuda).contiguous()
    return img, weights, sampler.flow_basis(h, w, cuda)


@pytest.mark.parametrize("band", [0, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tps_warp_kernel_matches_plain(cuda, monkeypatch, band, dtype):
    monkeypatch.setenv("PARTSEG_WARP_BAND", str(band))
    monkeypatch.setenv("PARTSEG_WARP_TILE", "480")            # 10 rows of 48: 4 bands
    img, weights, basis = _warp_inputs(cuda)
    kh, tile = band_config(dtype, 40, 48)
    assert kh == band
    before = launches("tps_warp")
    got = tps_warp(img.to(dtype), weights, basis)
    want = tps_warp_plain(img.to(dtype).float(), weights, basis, kh, tile).to(dtype)
    torch.cuda.synchronize()
    assert launches("tps_warp") == before + 1 and got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2 ** -8 + 1e-4   # one bf16 ulp below 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


# (b, h, w, c, tps_grid, band, tile (0: the default), extreme weights, NaN weights,
#  slice at an odd offset)
TPS_SHAPES = {
    "training": (32, 128, 128, 3, 5, 0, 0, False, False, False),
    "one_image": (1, 40, 48, 3, 5, 0, 0, False, False, False),
    "b13": (13, 40, 48, 3, 5, 0, 0, False, False, False),      # not a multiple of the group
    "hw_40x48": (3, 40, 48, 3, 5, 0, 0, False, False, False),  # H·W not a multiple of the run
    "hw_17x13": (5, 17, 13, 3, 5, 0, 0, False, False, False),
    "m12": (9, 40, 48, 3, 3, 0, 0, False, False, False),       # tps_grid = 3
    "m52": (5, 40, 48, 3, 7, 0, 0, False, False, False),       # M > 32: w in blocks of 32
    "c1": (9, 40, 48, 1, 5, 0, 0, False, False, False),
    "c4": (9, 40, 48, 4, 5, 0, 0, False, False, False),
    "c5": (3, 17, 13, 5, 4, 0, 0, False, False, False),        # the any-C loop, M = 19
    "odd_slice": (5, 17, 13, 3, 5, 0, 0, False, False, True),  # x[1:]: H·W·C = 663
    "extreme_nan": (9, 40, 48, 3, 5, 0, 0, True, True, False),
    "band24": (10, 128, 128, 3, 5, 24, 0, False, False, False),
    "band40": (10, 128, 128, 3, 5, 40, 0, False, False, False),
    "band56": (32, 128, 128, 3, 5, 56, 0, False, False, False),
    "band_480": (10, 40, 48, 3, 5, 24, 480, False, False, False),      # 2 CTAs of 240 points
    "band_long_run": (3, 256, 256, 3, 5, 56, 65536, False, False, False),  # 16 chunks, 2 images
    "grid20": (32, 128, 128, 3, 20, 0, 0, False, False, False),   # M = 403: 5 basis chunks
    "band56_grid15": (32, 128, 128, 3, 15, 56, 0, False, False, False),  # M = 228: 7 chunks
}
# From grid 15 on, a TPS flow's dot sums thousands in magnitude to values
# near 1 (Σ|basis_j·w_j| ≈ 2700 at grid 15, 8800 at grid 20), and two f32
# orders of that sum differ by up to 0.006 px; so there the plain version
# samples the flow computed in the kernel's order (kernel_order_flow), and
# only the lerp's products may fuse.
KERNEL_ORDER_FROM_GRID = 15


def _set_band(monkeypatch, band, tile):
    monkeypatch.setenv("PARTSEG_WARP_BAND", str(band))
    if tile:
        monkeypatch.setenv("PARTSEG_WARP_TILE", str(tile))
    else:
        monkeypatch.delenv("PARTSEG_WARP_TILE", raising=False)


# Shifts of the flow (y, x) that put one axis or both beyond the border.
EXTREME_SHIFTS = [(4.0, 0.0), (-4.0, 0.0), (0.0, 4.0), (0.0, -4.0), (4.0, -4.0), (-1e3, 1e3)]


def _tps_case(cuda, dtype, b, h, w, c, grid, extreme, nan, odd_slice, seed=21):
    sampler = TPSSampler(grid_size=grid)
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand((b + odd_slice, h, w, c), generator=gen).to(cuda, dtype)[odd_slice:]
    weights = sampler.sample(gen, b).weights
    if extreme:                                      # the basis column of the constant 1
        for i, shift in zip(range(1, b), EXTREME_SHIFTS):
            weights[i, sampler.n_ctrl] += torch.tensor(shift)
    if nan:
        weights[0, 2, 1] = float("nan")              # image 0: every x NaN
        weights[b - 1] = float("nan")                # the last image: all NaN
    return img, weights.to(cuda).contiguous(), sampler.flow_basis(h, w, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(TPS_SHAPES))
def test_tps_warp_kernel_shapes(cuda, monkeypatch, case, dtype):
    """The kernel at the training shape, a batch of 1 and one that is not a
    multiple of the image group, runs that do not divide H·W, M = 12, 19 and 52,
    C = 1, 3, 4 and 5, an image at an odd element offset, extreme and NaN
    weights that put the flow beyond the border, and band mode at 128² (tiles split over a cluster of CTAs),
    against the plain version; repeats give the same bits. A NaN flow
    coordinate clamps like one far below -1 (the plain version's floor of
    NaN has no defined tap)."""
    b, h, w, c, grid, band, tile, extreme, nan, odd = TPS_SHAPES[case]
    _set_band(monkeypatch, band, tile)
    im, weights, basis = _tps_case(cuda, dtype, b, h, w, c, grid, extreme, nan, odd)
    assert im.is_contiguous() and (im.data_ptr() % 16 != 0) == odd
    kh, tile = band_config(dtype, h, w)
    assert kh == band
    before = launches("tps_warp")
    got = tps_warp(im, weights, basis)
    again = tps_warp(im, weights, basis)
    if nan:
        want = gather_sample(im.float(), torch.nan_to_num(tps_flow(weights, basis), nan=-3.0))
        want = want.reshape(got.shape).to(dtype)
    elif grid >= KERNEL_ORDER_FROM_GRID:
        flow, _ = kernel_order_flow(weights, basis)
        want = tps_sample_plain(im.float(), flow, kh, tile).to(dtype)
    else:
        want = tps_warp_plain(im.float(), weights, basis, kh, tile).to(dtype)
    torch.cuda.synchronize()
    assert launches("tps_warp") == before + 2 and got.dtype == dtype
    assert torch.equal(got, again)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -8 + 1e-4   # one bf16 ulp below 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("band", [0, 56])
def test_tps_sampler_warp_hands_the_wide_path_16_byte_rows(cuda, monkeypatch, band):
    """TPSSampler.warp at grid 20 (M = 403) passes the kernel its basis
    padded to 404 columns and the weights with it; the output equals the
    wrapper's on the unpadded basis (which pads it per call) bit for bit,
    and the plain sample at the flow in the kernel's order within one bf16
    ulp below 1."""
    _set_band(monkeypatch, band, 0)
    img, weights, basis = _tps_case(cuda, torch.bfloat16, 32, 128, 128, 3, 20, False, False,
                                    False)
    sampler = TPSSampler(grid_size=20)
    kh, tile = band_config(img.dtype, 128, 128)
    before = launches("tps_warp")
    got = sampler.warp(TPSParams(weights), img)
    again = tps_warp(img, weights, basis)
    flow, _ = kernel_order_flow(weights, basis)
    want = tps_sample_plain(img.float(), flow, kh, tile).to(img.dtype)
    torch.cuda.synchronize()
    assert launches("tps_warp") == before + 2 and kh == band
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 ** -8 + 1e-4)


@pytest.mark.parametrize("case", list(TPS_SHAPES))
def test_tps_warp_launch_plan_matches_the_kernel(cuda, monkeypatch, case):
    """partops/kernels/tps_warp.py:launch_plan is the CUDA source's make_plan."""
    b, h, w, _, grid, band, tile, *_ = TPS_SHAPES[case]
    m = grid * grid + 3
    _set_band(monkeypatch, band, tile)
    for dtype in (torch.float32, torch.bfloat16):
        kh, tile_ = band_config(dtype, h, w)
        got = (ctypes.c_int * 7)()
        _build.library().partseg_tps_warp_plan(b, h, w, m, tile_, kh, got)
        assert tuple(got) == tuple(launch_plan(b, h, w, m, kh, tile_))


@pytest.mark.parametrize("grid", [5, 20])
def test_tps_warp_in_image_large_flow_accuracy(cuda, monkeypatch, grid):
    """Large non-rigid flows that stay inside the image (control points
    moved by N(0, 0.25) around a 0.6 scaling, clamped to ±0.95), f32,
    against the sample at the exact flow (f64), under a bound derived from
    the dot's rounding. The kernel's flow is a chain of M f32 FMAs, each
    rounded once with relative error ≤ u = 2⁻²⁴ of its result ŝ_j, so the
    computed flow is the exact one plus Σ_j δ_j with |δ_j| ≤ u·|ŝ_j|:
    |error| ≤ u·Σ_j|ŝ_j| in coordinates, exactly (this is at most the usual
    M·u·Σ_j|basis_j·w_j|, and far below it where the sum cancels). The
    exact flow rounded to f32 and to_pixel's three roundings add at most
    4u·(|c| + 1); a pixel index is (c + 1)·S/2 − 0.5. The border-clamped
    bilinear sample is Lipschitz in each index with the image's largest
    neighbour difference along that axis as the constant, and the lerp's
    own roundings are below 1e-6 at values in [0, 1]. Grid 20 (M = 403)
    crosses the kernel's chunk boundaries (every 84 columns)."""
    _set_band(monkeypatch, 0, 0)
    b, h, w = 8, 128, 128
    sampler = TPSSampler(grid_size=grid)
    gen = torch.Generator().manual_seed(5)
    ctrl = torch.from_numpy(sampler._ctrl_np)
    targets = (0.6 * ctrl + 0.25 * torch.randn((b, sampler.n_ctrl, 2), generator=gen))
    weights = sampler._solve(targets.clamp(-0.95, 0.95)).weights.to(cuda).contiguous()
    img = torch.rand((b, h, w, 3), generator=gen).to(cuda)
    basis = sampler.flow_basis(h, w, cuda)
    got = tps_warp(img, weights, basis)
    exact = torch.einsum("nm,bmk->bnk", basis.double(), weights.double())
    _, path = kernel_order_flow(weights, basis)
    u = 2.0 ** -24
    err_c = u * path + 4 * u * (exact.abs() + 1)                # [B, N, 2] in coordinates
    lip_y = (img[:, 1:] - img[:, :-1]).abs().amax(dim=(1, 2, 3))  # per image
    lip_x = (img[:, :, 1:] - img[:, :, :-1]).abs().amax(dim=(1, 2, 3))
    bound = (err_c[..., 0] * h / 2 * lip_y[:, None] + err_c[..., 1] * w / 2 * lip_x[:, None]
             + 1e-6)                                              # [B, N]
    want = gather_sample(img, exact.float()).reshape(b, h * w, 3)
    err = (got.reshape(b, h * w, 3) - want).abs().amax(-1)
    inside = (exact.abs() <= 1).all(-1)
    assert inside.float().mean() > 0.95                          # the flow stays in the image
    assert (err <= bound).all(), (err / bound).max().item()
    assert err.max() > 0 or grid == 5                            # grid 20 rounds visibly


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_bilinear_sample_kernel_matches_plain(cuda, mode):
    img = torch.rand((2, 20, 30, 3), generator=torch.Generator().manual_seed(4)).to(cuda)
    crd = (torch.rand((2, 700, 2), generator=torch.Generator().manual_seed(5)) * 2.6 - 1.3).to(cuda)
    before = launches("bilinear_sample")
    got = bilinear_sample(img, crd, mode, impl="fused")
    want = bilinear_sample(img, crd, mode, impl="gather")
    torch.cuda.synchronize()
    assert launches("bilinear_sample") == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    got, want = _grad_pair(lambda i, c: bilinear_sample(i, c, mode, impl="fused"),
                           lambda i, c: bilinear_sample(i, c, mode, impl="gather"), [img, crd])
    _close_scaled(got, want)


def test_tps_warp_grad_matches_plain(cuda):
    img, weights, basis = _warp_inputs(cuda)
    got, want = _grad_pair(lambda i, w: tps_warp(i, w, basis),
                           lambda i, w: tps_warp_plain(i, w, basis), [img, weights])
    _close_scaled(got, want)


def test_train_period_on_card_matches_cpu(cuda):
    """A tiny f32 config, one period from the same weights and draws: the
    card (kernels) against the CPU (plain versions)."""
    cfg = TrainConfig(
        model=PartNetConfig(n_parts=3, img_size=32, features=16, depth=1, app_features=8,
                            decoder_scales=2, decoder_out_size=16, stem_stride=2,
                            dtype=torch.float32),
        augment=AugmentConfig(tps_grid=3, warp_every=2, warp_fraction=0.5),
        loss=LossConfig(vgg_layers=("relu1_2",), vgg_trim_blocks=1, vgg_resolution=16,
                        swap_weight=0.5),
        optim=OptimConfig(warmup_steps=10, decay_steps=100))
    sampler = cfg.augment.make_sampler()
    xs = [torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(i)) for i in (6, 7)]
    draws = [keyed_pair_draws(8 + i, 0, np.arange(4), sampler, cfg.augment) for i in range(2)]
    cpu_model = init_weights(PartNet(cfg.model, device="cpu"), seed=0)
    out = {}
    for dev in ("cpu", cuda):
        model = PartNet(cfg.model, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        dr = [type(d)(type(d.tps)(d.tps.weights.to(dev)),
                      type(d.color)(*(getattr(d.color, f.name).to(dev)
                                      for f in dataclasses.fields(d.color)))) for d in draws]
        period = make_train_period(cfg, model, sampler, build_perceptual(cfg, dev))
        state, m = period(create_state(cfg, model, step=5), tuple({"image": x.to(dev)} for x in xs),
                          draws=dr)
        out[str(dev)] = {k: v.item() for k, v in m.items()}
    for k, v in out["cpu"].items():
        assert abs(out["cuda"][k] - v) <= 1e-4 * max(abs(v), 1e-3), k


def test_softmax_moments_op_launches_the_kernel(cuda):
    """The registered op, called directly on the strided foreground slice,
    launches the kernel and matches the plain version."""
    fg = _logits(9, 3, 32, 10).to(cuda)[..., :10]
    before = launches("softmax_moments")
    got = torch.ops.partseg.softmax_moments(fg)
    torch.cuda.synchronize()
    assert launches("softmax_moments") == before + 1
    want = softmax_moments_plain(fg)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)


def test_exported_infer_on_the_card_runs_the_kernel(cuda, tmp_path):
    """A program exported on the card (symbolic batch) holds the op, launches
    the kernel once per call after save and load, equals the eager forward
    on the card (the same ops: 1e-5 of scale, seg equal) and the CPU's plain
    versions within 1e-4 of scale, as test_partnet_on_card_matches_cpu."""
    cfg = PartNetConfig(n_parts=4, img_size=32, features=16, depth=2, app_features=8,
                        decoder_scales=2, decoder_features=(16, 8), dtype=torch.float32)
    cpu = init_weights(PartNet(cfg, device="cpu"), seed=0).eval()
    gpu = PartNet(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.eval()
    program = export_infer(gpu, 32)
    names = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert names.count("partseg.softmax_moments.default") == 1
    path = str(tmp_path / "infer.pt2")
    torch.export.save(program, path)
    served = load_exported(path).module()
    for b in (1, 3):
        x = torch.from_numpy(np.random.default_rng(b).uniform(0, 1, (b, 32, 32, 3))
                             .astype(np.float32))
        before = launches("softmax_moments")
        got = served(x.to(cuda))
        torch.cuda.synchronize()
        assert launches("softmax_moments") == before + 1
        eager, plain = make_infer_fn(gpu)(x.to(cuda)), make_infer_fn(cpu)(x)
        torch.testing.assert_close(got["seg"], eager["seg"])
        for key in ("logits", "heatmaps", "landmarks", "sigma"):
            scale = plain[key].abs().max().item()
            torch.testing.assert_close(got[key], eager[key], rtol=0, atol=1e-5 * scale, msg=key)
            torch.testing.assert_close(got[key].cpu(), plain[key], rtol=0, atol=1e-4 * scale,
                                       msg=key)
