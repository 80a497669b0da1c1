"""The golden check on the CPU: the port at bf16 against
tests/golden/golden.npz (the JAX package's bf16 outputs from
tests/test_golden.py), through tests/_torch_golden.py.

The inputs the port cannot draw without JAX (x from key 11, the
parameters from init key 12, the pair's draws from key 13) and each model
output's bf16 rounding error in the reference (eps: |golden − JAX at f32|
on the same weights and inputs) are in tests/golden/torch_golden_inputs.npz,
which the card's check reads. The first test holds that file to JAX;
regenerate it with ``PYTHONPATH=. python tests/test_torch_golden.py`` after an
intentional change of golden.npz.

Tolerances (derived in tests/_torch_golden.py): the pair (x_s,
x_a, tps_weights), computed in f32, within golden.npz's own 2e-4; each
model output (recon, mu_a, sigma_a, appearance), computed in bf16 with
roundings at other places than JAX's, within 2·eps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partseg_tpu.augment import AugmentConfig as JaxAugmentConfig
from partseg_tpu.augment.color import sample_color_params
from partseg_tpu.models.partnet import PartNet as JaxPartNet
from partseg_tpu.models.partnet import PartNetConfig as JaxConfig
from partseg_tpu_torch.augment import ColorParams
from partseg_tpu_torch.convert import flax_to_state_dict
import _torch_golden as golden

torch.set_num_threads(1)


def jax_inputs() -> dict[str, np.ndarray]:
    """The inputs file's contents, made by JAX as tests/test_golden.py
    makes golden.npz, plus eps from the JAX model at f32."""
    cfg = JaxConfig(**golden.MODEL, use_pallas=False)
    model = JaxPartNet(cfg)
    x = jax.random.uniform(jax.random.key(11), (2, 32, 32, 3))
    params = model.init(jax.random.key(12), x, x)
    acfg = JaxAugmentConfig()
    k_tps, k_col, _ = jax.random.split(jax.random.key(13), 3)    # as make_pair splits
    tps = acfg.make_sampler().sample(k_tps, 2)
    col = sample_color_params(k_col, 2, acfg.brightness, acfg.contrast, acfg.saturation,
                              acfg.hue)
    f32 = JaxPartNet(dataclasses.replace(cfg, dtype=jnp.float32)).apply(params, x, x * 0.5 + 0.25)
    with np.load(golden.GOLDEN) as data:
        want = {k: data[k] for k in data.files}
    out = {"x": np.asarray(x), "tps_weights": np.asarray(tps.weights)}
    out.update({f"color/{f.name}": np.asarray(getattr(col, f.name), np.float32)
                for f in dataclasses.fields(ColorParams)})
    out.update({f"param/{k}": v.numpy() for k, v in
                flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)).items()})
    out.update({f"eps/{k}": np.float32(np.abs(want[k] - np.asarray(getattr(f32, k), np.float32))
                                       .max()) for k in golden.MODEL_OUTPUTS})
    return out


@pytest.fixture(scope="module")
def made_by_jax():
    return jax_inputs()


@pytest.fixture(scope="module")
def port_vs_golden():
    return golden.check("cpu")


def test_golden_inputs_file_matches_jax(made_by_jax):
    stored = golden.load_inputs()
    assert set(stored) == set(made_by_jax)
    for k, v in made_by_jax.items():
        if k.startswith("eps/"):
            # XLA's f32 sums may change order across versions: eps to 1e-3.
            np.testing.assert_allclose(stored[k], v, rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)


@pytest.mark.parametrize("output", golden.MODEL_OUTPUTS + golden.PAIR_OUTPUTS)
def test_port_matches_golden(port_vs_golden, output):
    r = port_vs_golden[output]
    assert r["max_abs_err"] <= r["bound"], (output, r)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(golden.INPUTS, **jax_inputs())
    print(f"wrote {golden.INPUTS}")
