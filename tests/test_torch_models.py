"""Port parity: partseg_tpu_torch.models against the JAX package's Flax
models, module by module and for the whole PartNet forward, at float32
on the CPU. Weights come from the JAX ``init`` through
``partseg_tpu_torch.convert``; inputs from a numpy seed.

Tolerances: 1e-5 absolute for single blocks (f32 convolutions in another
sum order); 1e-4 for the encoders, the decoder and the full forward
(tens of layers deep); the part maps and moments of the full forward
keep 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partseg_tpu.models.blocks import ConvBlock as JConvBlock
from partseg_tpu.models.blocks import ResBlock as JResBlock
from partseg_tpu.models.blocks import f8_store as jax_f8_store
from partseg_tpu.models.blocks import quantize_activation as jax_quantize
from partseg_tpu.models.decoder import Decoder as JDecoder
from partseg_tpu.models.encoders import AppearanceEncoder as JAppearanceEncoder
from partseg_tpu.models.encoders import ShapeEncoder as JShapeEncoder
from partseg_tpu.models.encoders import _Stem as JStem
from partseg_tpu.models.hourglass import Hourglass as JHourglass
from partseg_tpu_torch.convert import load_flax_params
from partseg_tpu_torch.models import (
    AppearanceEncoder,
    ConvBlock,
    Decoder,
    Hourglass,
    PartNet,
    PartNetConfig,
    ResBlock,
    ShapeEncoder,
    init_weights,
)
from partseg_tpu_torch.models.blocks import f8_store, quantize_activation
from partseg_tpu_torch.models.encoders import _Stem
from _torch_parity import TINY, images, jax_partnet, n, t, torch_partnet

torch.set_num_threads(1)
F32 = torch.float32


def _carry(jmodule, tmodule, root, *inputs):
    """Init the Flax module on ``inputs``, load its params into the port's."""
    params = jmodule.init(jax.random.key(0), *inputs)
    load_flax_params(tmodule, jax.tree_util.tree_map(np.asarray, params), root)
    return params


def _nchw(x: np.ndarray) -> torch.Tensor:
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return n(x.permute(0, 2, 3, 1))


def _feats(seed, c, size=8, b=2):
    return np.random.default_rng(seed).standard_normal((b, size, size, c)).astype(np.float32)


@pytest.mark.parametrize("norm", ["block", "group", "none"])
@pytest.mark.parametrize("cin,features", [(16, 16), (24, 16)])
def test_resblock_matches(norm, cin, features):
    x = _feats(0, cin)
    jm = JResBlock(features, norm=norm, dtype=jnp.float32)
    tm = ResBlock(cin, features, norm=norm, dtype=F32)
    params = _carry(jm, tm, "resblock", x)
    assert (tm.skip is not None) == (cin != features)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm.apply(params, x)), atol=1e-5)


def test_convblock_defaults_to_group_norm():
    x = _feats(1, 16)
    jm = JConvBlock(8, kernel=3, dtype=jnp.float32)
    tm = ConvBlock(16, 8, kernel=3, dtype=F32)
    params = _carry(jm, tm, "convblock", x)
    assert tm.norm is not None and tm.norm.eps == 1e-6
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm.apply(params, x)), atol=1e-5)


@pytest.mark.parametrize("stride", [2, 4])
def test_stem_space_to_depth_channel_order(stride):
    x = images(2, 2, 16)
    jm = JStem(16, jnp.float32, stride=stride)
    tm = _Stem(16, F32, stride=stride)
    params = _carry(jm, tm, "stem", x)
    np.testing.assert_allclose(_nhwc(tm(t(x))), np.asarray(jm.apply(params, x)), atol=1e-5)
    # The trap: pixel_unshuffle's (c, sy, sx) order is NOT the stem's (sy, sx, c).
    shuffled = torch.nn.functional.pixel_unshuffle(_nchw(x), stride)
    with torch.no_grad():
        wrong = tm.res(tm.conv(shuffled))
    assert np.abs(_nhwc(wrong) - np.asarray(jm.apply(params, x))).max() > 1e-3


def test_hourglass_matches():
    x = _feats(3, 16, size=16)
    jm = JHourglass(depth=2, features=16, dtype=jnp.float32)
    tm = Hourglass(depth=2, features=16, dtype=F32)
    params = _carry(jm, tm, "hourglass", x)
    assert len(tm.blocks) == 7
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(jm.apply(params, x)), atol=1e-5)


@pytest.mark.parametrize("n_stacks,head_upsample,background", [(1, False, True), (2, True, False)])
def test_shape_encoder_matches(n_stacks, head_upsample, background):
    x = images(4, 2, 32)
    kw = dict(n_parts=4, background=background, depth=2, features=16, n_stacks=n_stacks,
              head_upsample=head_upsample)
    jm = JShapeEncoder(**kw, dtype=jnp.float32)
    tm = ShapeEncoder(**kw, dtype=F32)
    params = _carry(jm, tm, "shape_enc", x)
    got, want = n(tm(t(x))), np.asarray(jm.apply(params, x))
    m = 32 if head_upsample else 16
    assert got.shape == want.shape == (2, m, m, 4 + background)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_appearance_encoder_matches():
    x = images(5, 2, 32)
    jm = JAppearanceEncoder(out_features=8, depth=2, features=16, dtype=jnp.float32)
    tm = AppearanceEncoder(out_features=8, depth=2, features=16, dtype=F32)
    params = _carry(jm, tm, "app_enc", x)
    np.testing.assert_allclose(n(tm(t(x))), np.asarray(jm.apply(params, x)), atol=1e-4)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
def test_decoder_matches(use_pallas, kernel):
    rng = np.random.default_rng(6)
    mu = rng.uniform(-0.6, 0.6, (2, 4, 2)).astype(np.float32)
    a = (0.2 * rng.standard_normal((2, 4, 2, 2))).astype(np.float32)
    sigma = (np.einsum("...ij,...kj->...ik", a, a) + 0.01 * np.eye(2)).astype(np.float32)
    app = rng.standard_normal((2, 4, 8)).astype(np.float32)
    jm = JDecoder(out_size=32, n_scales=2, features=(16, 8), render_kernel=kernel,
                  use_pallas=use_pallas, dtype=jnp.float32)
    tm = Decoder(app_features=8, out_size=32, n_scales=2, features=(16, 8),
                 render_kernel=kernel, dtype=F32)
    params = _carry(jm, tm, "decoder", mu, sigma, app)
    got = n(tm(t(mu), t(sigma), t(app)))
    want = np.asarray(jm.apply(params, mu, sigma, app))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_pair():
    jm, jp = jax_partnet(use_pallas=True)
    return jm, jp, torch_partnet(jp)


def test_partnet_forward_matches(tiny_pair):
    jm, jp, tm = tiny_pair
    xs, xa = images(7, 2, 32), images(8, 2, 32)
    want = jm.apply(jp, xs, xa)
    with torch.no_grad():
        got = tm(t(xs), t(xa))
    tol = {"recon": 1e-4, "logits_a": 1e-4, "logits_s": 1e-4, "seg_a": 1e-5,
           "parts_a": 1e-5, "parts_s": 1e-5, "mu_a": 1e-5, "mu_s": 1e-5,
           "sigma_a": 1e-5, "sigma_s": 1e-5, "appearance": 1e-4}
    for field, atol in tol.items():
        g, w = n(getattr(got, field)), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, atol=atol, err_msg=field)


def test_partnet_variant_config_matches():
    """divide normalization, spatial pooling masks, heavy-tail render,
    GroupNorm in every conv — against the JAX plain path."""
    over = dict(spatial_norm="divide", pool_masks="spatial", render_kernel="heavy_tail",
                norm="group")
    jm, jp = jax_partnet(use_pallas=False, **over)
    tm = torch_partnet(jp, **over)
    xs, xa = images(9, 2, 32), images(10, 2, 32)
    want = jm.apply(jp, xs, xa)
    with torch.no_grad():
        got = tm(t(xs), t(xa))
    for field in ("recon", "parts_a", "mu_a", "sigma_a", "appearance"):
        np.testing.assert_allclose(n(getattr(got, field)), np.asarray(getattr(want, field)),
                                   atol=1e-4, err_msg=field)


def test_quantize_activation_f8_round_trip():
    x = (4 * _feats(11, 8)).astype(np.float32)
    got = n(quantize_activation(t(x), "f8"))
    np.testing.assert_array_equal(got, np.asarray(jax_quantize(jnp.asarray(x), "f8")))
    assert np.abs(got - x).max() > 0                  # it does round
    np.testing.assert_array_equal(n(quantize_activation(t(x), "none")), x)
    with pytest.raises(ValueError):
        quantize_activation(t(x), "int4")


def test_f8_store_passes_the_gradient_straight_through():
    """A 1e-5 cotangent (below e4m3's smallest subnormal, 2⁻⁹) comes back
    unchanged, as jax.grad of the JAX f8_store gives; rounding it through
    float8 as a plain cast's backward does would flush it to 0."""
    x = (4 * _feats(12, 8)).astype(np.float32)
    xt = t(x).requires_grad_()
    (got,) = torch.autograd.grad(quantize_activation(xt, "f8"), xt, torch.full_like(xt, 1e-5))
    want = jax.grad(lambda v: jnp.sum(jax_f8_store(v) * 1e-5))(jnp.asarray(x))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert (got == torch.tensor(1e-5)).all()
    np.testing.assert_array_equal(n(f8_store(t(x))), np.asarray(jax_f8_store(jnp.asarray(x))))
    (cast,) = torch.autograd.grad(xt.to(torch.float8_e4m3fn).to(torch.float32), xt,
                                  torch.full_like(xt, 1e-5))
    assert not cast.any()


def test_init_weights_is_seeded_and_scaled():
    cfg = PartNetConfig(**TINY, dtype=F32)
    a = init_weights(PartNet(cfg, device="cpu"), seed=3).state_dict()
    b = init_weights(PartNet(cfg, device="cpu"), seed=3).state_dict()
    c = init_weights(PartNet(cfg, device="cpu"), seed=4).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["shape_enc.hourglasses.0.blocks.0.convs.1.conv.weight"]      # 3×3, fan-in 72
    assert not torch.equal(w, c["shape_enc.hourglasses.0.blocks.0.convs.1.conv.weight"])
    assert w.abs().max() <= 2.0 / 72 ** 0.5 / 0.8796 + 1e-6
    assert 0.7 < w.std().item() * 72 ** 0.5 < 1.3
    assert torch.all(a["decoder.blocks.0.norm.weight"] == 1)
    assert torch.all(a["decoder.app_proj.0.bias"] == 0)


def test_remat_gives_the_same_loss_and_gradients():
    """PartNetConfig.remat runs each hourglass under activation
    checkpointing in training, as the JAX package's nn.remat(Hourglass):
    the same loss and gradients as without it (1e-6 relative at f32: the
    recomputation repeats the same ops in the same order), with fewer
    activations kept for the backward."""
    xs, xa = t(images(11, 2, 32)), t(images(12, 2, 32))
    weights = init_weights(PartNet(PartNetConfig(**TINY, n_stacks=2, dtype=F32), device="cpu"),
                           seed=3).state_dict()
    runs = {}
    for remat in (False, True):
        model = PartNet(PartNetConfig(**TINY, remat=remat, n_stacks=2, dtype=F32), device="cpu")
        model.load_state_dict(weights)
        kept = []

        def pack(x):
            kept.append(x.numel() * x.element_size())
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            out = model(xs, xa)
        loss = out.recon.square().mean() + out.mu_a.square().sum() + out.sigma_s.sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs[remat] = (loss, grads, sum(kept))
    (loss0, g0, kept0), (loss1, g1, kept1) = runs[False], runs[True]
    assert kept1 < 0.8 * kept0, (kept1, kept0)
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * b.abs().max().item())
