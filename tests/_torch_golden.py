"""The golden check: the port at bf16 against ``tests/golden/golden.npz``,
beside its data. ``tests/test_torch_golden.py`` runs it on the CPU and
``chip_smoke.py`` (phase golden) on the card; it imports nothing of JAX,
which the card's host lacks.

``golden.npz`` holds the JAX package's bf16 outputs for a fixed-seed
PartNet (``tests/test_golden.py``: 32 px, K = 4, features 32, depth 2,
init key 12, x from key 11, the pair from key 13). Without JAX the port
cannot draw those weights and inputs, so
``tests/golden/torch_golden_inputs.npz`` carries them, made once by JAX
(``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_golden.py``
writes it; the CPU test checks it against JAX on every run): x, the
converted parameters (``param/<name>``), the pair's draws (TPS weights
and colour parameters) and, per model
output, ``eps/<name>``, the reference's own bf16 rounding error: the
largest |golden − the JAX model at f32| on the same weights and inputs.

Bounds. The pair (x_s, x_a, tps_weights) runs in f32 on both sides and is
held to golden.npz's own ``atol=2e-4``. The model's outputs are bf16
computations that round at other places than JAX (bf16 convolutions whose
f32 sums run in another order, and a decoder that sums φ·a in f32 where
JAX's ``use_pallas=False`` renders in bf16). At f32 the port equals JAX
within 1e-4 (the parity tests). If the port's bf16 result is no further
from the f32 function than the reference's is (eps), the two differ by at
most 2·eps: that is each model output's bound.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
GOLDEN = GOLDEN_DIR / "golden.npz"
INPUTS = GOLDEN_DIR / "torch_golden_inputs.npz"
# tests/test_golden.py's PartNetConfig (use_pallas=False; dtype bf16).
MODEL = dict(n_parts=4, img_size=32, features=32, depth=2, app_features=16, decoder_scales=3)
MODEL_OUTPUTS = ("recon", "mu_a", "sigma_a", "appearance")
PAIR_OUTPUTS = ("x_s", "x_a", "tps_weights")
F32_ATOL = 2e-4          # golden.npz's own tolerance (tests/test_golden.py)


def load_inputs() -> dict[str, np.ndarray]:
    with np.load(INPUTS) as data:
        return {k: data[k] for k in data.files}


def bounds(inputs: dict[str, np.ndarray]) -> dict[str, float]:
    """Each output's bound: 2·eps for the bf16 model outputs, 2e-4 for the pair."""
    out = {k: 2.0 * float(inputs[f"eps/{k}"]) for k in MODEL_OUTPUTS}
    out.update({k: F32_ATOL for k in PAIR_OUTPUTS})
    return out


def port_outputs(inputs: dict[str, np.ndarray], device) -> dict[str, np.ndarray]:
    """The port's golden outputs on ``device``: PartNet at bf16 with the
    carried parameters on (x, 0.5·x + 0.25), and make_pair on x with the
    carried draws (the default AugmentConfig, as test_golden.py uses)."""
    from partseg_tpu_torch.augment import AugmentConfig, ColorParams, TPSParams, make_pair
    from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig

    model = PartNet(PartNetConfig(**MODEL), device="cpu")
    model.load_state_dict({k.removeprefix("param/"): torch.from_numpy(v)
                           for k, v in inputs.items() if k.startswith("param/")})
    model = model.to(device).eval()

    def t(name):
        return torch.from_numpy(inputs[name]).to(device)

    x = t("x")
    acfg = AugmentConfig()
    color = ColorParams(*(t(f"color/{f.name}") for f in dataclasses.fields(ColorParams)))
    with torch.no_grad():
        out = model(x, x * 0.5 + 0.25)
        pair = make_pair(x, TPSParams(t("tps_weights")), color, acfg.make_sampler(), acfg)
    got = {"recon": out.recon, "mu_a": out.mu_a, "sigma_a": out.sigma_a,
           "appearance": out.appearance, "x_s": pair["x_s"], "x_a": pair["x_a"],
           "tps_weights": pair["tps"].weights}
    return {k: v.float().cpu().numpy() for k, v in got.items()}


def check(device) -> dict[str, dict[str, float]]:
    """{output: {"max_abs_err", "bound"}} of the port on ``device`` against
    golden.npz."""
    inputs = load_inputs()
    with np.load(GOLDEN) as data:
        want = {k: data[k] for k in data.files}
    got = port_outputs(inputs, device)
    limit = bounds(inputs)
    if set(got) != set(want):
        raise KeyError(f"golden outputs {sorted(want)}, port {sorted(got)}")
    return {k: {"max_abs_err": float(np.abs(got[k] - want[k]).max()), "bound": limit[k]}
            for k in want}
