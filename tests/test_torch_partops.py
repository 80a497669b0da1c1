"""Port parity: partseg_tpu_torch.partops (plain PyTorch) against the JAX
package's partops, at float32 on the CPU, plus the port's package-level
checks (config fields, presets, converter, imports, default device).

Tolerances: 1e-6 absolute for ops that do the same f32 arithmetic in the
same order (grids, softmaxes, closed-form 2×2 algebra); 1e-5 for ops
whose sums run in another order (moments, render, pooling, assembly)."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import partseg_tpu.partops as jp
from partseg_tpu.models.partnet import PartNetConfig as JaxConfig
from partseg_tpu_torch import configs, convert, default_device
from partseg_tpu_torch import partops as tp
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig
from _torch_parity import TINY, jax_partnet, n, t

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _mu_sigma(seed, b, k, singular=False):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-0.7, 0.7, (b, k, 2)).astype(np.float32)
    a = (0.1 * rng.standard_normal((b, k, 2, 2))).astype(np.float32)
    sigma = np.einsum("...ij,...kj->...ik", a, a) + 0.01 * np.eye(2, dtype=np.float32)
    if singular:
        sigma[:, 0] = 0.0            # a delta part: Σ = 0
        sigma[:, 1] = [[1e-3, 1e-3], [1e-3, 1e-3]]   # rank 1
    return mu, sigma.astype(np.float32)


@pytest.mark.parametrize("h,w", [(8, 8), (16, 32), (64, 64), (5, 3)])
def test_coord_grid_and_basis_match(h, w):
    yy, xx = tp.coord_grid(h, w)
    jyy, jxx = jp.coord_grid(h, w)
    np.testing.assert_array_equal(n(yy), np.asarray(jyy))
    np.testing.assert_array_equal(n(xx), np.asarray(jxx))
    np.testing.assert_array_equal(n(tp.moment_basis(h, w)), np.asarray(jp.moment_basis(h, w)))


def test_softmaxes_match():
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 5)).astype(np.float32) * 3
    np.testing.assert_allclose(n(tp.part_softmax(t(x))), np.asarray(jp.part_softmax(x)), atol=1e-6)
    np.testing.assert_allclose(n(tp.spatial_softmax(t(x))), np.asarray(jp.spatial_softmax(x)),
                               atol=1e-6)
    m = np.abs(x)
    np.testing.assert_allclose(n(tp.normalize_maps(t(m))), np.asarray(jp.normalize_maps(m)),
                               atol=1e-6)


@pytest.mark.parametrize("delta", [False, True])
def test_soft_argmax_moments_match(delta):
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 4)).astype(np.float32)
    if delta:
        x[:, 3, 5, :] = 80.0         # one-hot part maps: Σ → 0
    p = np.asarray(jp.spatial_softmax(x))
    mu, sigma = tp.soft_argmax_moments(t(p))
    jmu, jsigma = jp.soft_argmax_moments(p)
    np.testing.assert_allclose(n(mu), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(n(sigma), np.asarray(jsigma), atol=1e-5)
    assert mu.dtype == sigma.dtype == torch.float32


@pytest.mark.parametrize("singular", [False, True])
def test_precision_and_cholesky_match(singular):
    _, sigma = _mu_sigma(2, 2, 4, singular)
    lam = tp.precision_from_cov(t(sigma))
    np.testing.assert_allclose(n(lam), np.asarray(jp.precision_from_cov(sigma)), rtol=1e-6)
    assert torch.isfinite(lam).all()
    np.testing.assert_allclose(n(tp.chol2x2(t(sigma))), np.asarray(jp.chol2x2(sigma)), atol=1e-6)


@pytest.mark.parametrize("kernel", ["gauss", "heavy_tail"])
@pytest.mark.parametrize("singular", [False, True])
def test_render_gaussians_match(kernel, singular):
    mu, sigma = _mu_sigma(3, 2, 4, singular)
    got = tp.render_gaussians(t(mu), t(sigma), 16, 8, kernel=kernel)
    want = jp.render_gaussians(mu, sigma, 16, 8, kernel=kernel)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    assert torch.isfinite(got).all()


def test_render_rejects_unknown_kernel():
    mu, sigma = _mu_sigma(3, 1, 2)
    with pytest.raises(ValueError):
        tp.render_gaussians(t(mu), t(sigma), 4, 4, kernel="box")


def test_pooling_and_assembly_match():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    parts = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tp.pool_appearance(t(feats), t(parts))),
                               np.asarray(jp.pool_appearance(feats, parts)), atol=1e-5)
    app = rng.standard_normal((2, 3, 6)).astype(np.float32)
    np.testing.assert_allclose(n(tp.assemble_decoder_input(t(parts), t(app))),
                               np.asarray(jp.assemble_decoder_input(parts, app)), atol=1e-5)
    with pytest.raises(ValueError):
        tp.pool_appearance(t(feats), t(parts[:, :4]))


# ------------------------------------------------------------- package level

def test_config_has_exactly_the_jax_fields():
    jax_fields = {(f.name, repr(f.default)) for f in dataclasses.fields(JaxConfig)
                  if f.name != "dtype"}
    port_fields = {(f.name, repr(f.default)) for f in dataclasses.fields(PartNetConfig)
                   if f.name != "dtype"}
    assert port_fields == jax_fields
    assert "dtype" in {f.name for f in dataclasses.fields(PartNetConfig)}
    assert str(PartNetConfig().dtype).split(".")[-1] == jnp.dtype(JaxConfig().dtype).name


def test_celeba_preset_equals_jax_config():
    from configs.celeba import get_config

    want = get_config().model
    got = configs.model_config("celeba")
    for f in dataclasses.fields(JaxConfig):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        else:
            assert a == b, f.name
    assert got.map_size == want.map_size == 64
    assert configs.model_config("celeba", use_pallas=True).use_pallas
    with pytest.raises(KeyError):
        configs.model_config("imagenet")


def test_converter_consumes_every_leaf_once():
    _, params = jax_partnet()
    flat = convert.flatten_params(jax.tree_util.tree_map(np.asarray, params))
    state = convert.flax_to_state_dict(flat)
    assert len(state) == len(flat)             # one key per leaf, none dropped
    cfg = PartNetConfig(**TINY, dtype=torch.float32)
    assert set(state) == set(PartNet(cfg, device="cpu").state_dict())
    # Layouts: conv HWIO → OIHW, Dense [in, out] → [out, in].
    k = flat["shape_enc/_Stem_0/Conv_0/kernel"]
    np.testing.assert_array_equal(n(state["shape_enc.stem.conv.weight"]), k.transpose(3, 2, 0, 1))
    d = flat["decoder/app_proj_1/kernel"]
    np.testing.assert_array_equal(n(state["decoder.app_proj.1.weight"]), d.T)
    np.testing.assert_array_equal(n(state["shape_enc.hourglasses.0.blocks.5.norm.weight"]),
                                  flat["shape_enc/Hourglass_0/ResBlock_5/GroupNorm_0/scale"])


def test_converter_fails_on_leftovers_and_mismatches():
    _, params = jax_partnet()
    flat = convert.flatten_params(jax.tree_util.tree_map(np.asarray, params))
    with pytest.raises(KeyError):
        convert.flax_to_state_dict({**flat, "decoder/Dense_9/kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError):
        convert.flax_to_state_dict({**flat, "decoder/Conv_0/scale": np.zeros(3)})
    model = PartNet(PartNetConfig(**TINY, dtype=torch.float32), device="cpu")
    short = {k: v for k, v in flat.items() if not k.startswith("decoder/Conv_0")}
    with pytest.raises(KeyError):
        convert.load_flax_params(model, short)
    wide = PartNet(PartNetConfig(**{**TINY, "app_features": 12}, dtype=torch.float32),
                   device="cpu")
    with pytest.raises(ValueError):
        convert.load_flax_params(wide, flat)


def test_npz_round_trip(tmp_path):
    model = PartNet(PartNetConfig(**TINY, dtype=torch.float32), device="cpu")
    convert.save_npz(tmp_path / "w.npz", model.state_dict())
    back = convert.load_npz(tmp_path / "w.npz")
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "partseg_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "_torch_golden.py"]
    assert len(files) > 15
    banned = {"jax", "jaxlib", "flax", "chex", "optax", "orbax", "grain", "tensorflow",
              "partseg_tpu", "configs"}
    for path in files:
        bad = _imports(path) & banned
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_default_device_is_cuda_or_raises(monkeypatch):
    assert default_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PartNet(PartNetConfig(**TINY))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
