"""The port's CUDA kernels and model on the card, against the port's own
plain versions. Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor tests/_torch_parity.py, so on a machine
with a card and without JAX it runs on its own:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

f32 comparisons set TF32 off (cuDNN's f32 convolutions default to it).
Tolerances: parts rtol 1e-5 (one exp and one division per element); μ,
Σ atol 1e-5 (sums of H·W f32 terms in another order); render output
atol 1e-5·max|out| (K products per element); whole-model outputs 1e-4
of their scale (tens of f32 layers).
"""

import numpy as np
import pytest
import torch

from partseg_tpu_torch.evals import make_infer_fn, transfer_batch
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from partseg_tpu_torch.partops.kernels import (
    render_assemble,
    render_assemble_plain,
    softmax_moments,
    softmax_moments_plain,
)
from partseg_tpu_torch.partops.moments import precision_from_cov

pytestmark = pytest.mark.cuda


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
    before = softmax_moments.launches
    got = softmax_moments(fg)
    want = softmax_moments_plain(fg)
    torch.cuda.synchronize()
    assert softmax_moments.launches == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res,c", [(16, 256), (128, 32), (20, 3)])
def test_render_assemble_kernel_matches_plain(cuda, kernel, dtype, res, c):
    _, mu, sigma = softmax_moments_plain(_logits(7, 3, 32, 10, delta=True)[..., :10])
    lam = precision_from_cov(sigma)
    app = torch.randn((3, 10, c), generator=torch.Generator().manual_seed(1))
    mu, lam, app = mu.to(cuda), lam.to(cuda), app.to(cuda, dtype)
    before = render_assemble.launches
    got = render_assemble(mu, lam, app, res, res, kernel)
    want = render_assemble_plain(mu, lam, app, res, res, kernel)
    torch.cuda.synchronize()
    assert render_assemble.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_kernel_wrappers_raise_on_the_card(cuda):
    with pytest.raises(TypeError):
        softmax_moments(torch.zeros((1, 8, 8, 3), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        render_assemble(torch.zeros((1, 33, 2), device=cuda), torch.zeros((1, 33, 2, 2), device=cuda),
                        torch.zeros((1, 33, 4), device=cuda), 8, 8)


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
    sm, ra = softmax_moments.launches, render_assemble.launches
    got = make_infer_fn(gpu)(xs.to(cuda))
    got["recon"] = transfer_batch(gpu, xs.to(cuda), xa.to(cuda))
    assert (softmax_moments.launches - sm, render_assemble.launches - ra) == (3, 2)
    for key in ("logits", "heatmaps", "landmarks", "sigma", "recon"):
        scale = want[key].abs().max().item()
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0, atol=1e-4 * scale,
                                   msg=key)
    torch.testing.assert_close(got["seg"].cpu(), want["seg"])
