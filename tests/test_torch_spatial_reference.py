"""The port's spatial step against the benchmark's plain reference of it, on
the CPU: ``train.loop.build_step_fn``'s spatial step on 2 data × 2 space gloo
ranks (tests/_torch_dist_child.py, mode ``bench``), at the benchmark's tiny
size in float32, with seeded weights (``h100_bench/weights.py``) and the swap
loss on, against ``h100_bench/reference/sharded.py`` (each data shard's loss
and gradient computed whole, then averaged). One launch runs the step as it
is and with the ``no_halo`` fault planted (each rank's convolutions see zero
rows at its inner edge): the fault must break the agreement.

Tolerances, float32 against float32 (the two sum in other orders, the
program's GroupNorm statistics and part moments over the ranks):
- the loss, relative 2e-6: its terms are means of a few thousand elements,
  each agreeing to a few ulps;
- each gradient leaf (Adam's first moment ÷ (1 − b1)), 2e-5 of the leaf's
  largest entry, or of the median leaf's where that is larger: the gradient
  passes back through the halo exchanges and the sums over the group, each
  adding f32 rounding (up to about 6e-6 here); a bias before a GroupNorm
  has a gradient that is 0 but for rounding, which the median leaf scales;
- the parameters after one update, 2.5 · lr: Adam's first step moves each
  entry by about lr · sign(g), so an entry whose gradient is 0 but for
  rounding may move either way (2 · lr), and the rest agree to rounding.
"""

import json

import numpy as np
import pytest
import torch

from _torch_dist_child import launch
from h100_bench import program
from h100_bench import run as bench
from h100_bench.reference import sharded
from h100_bench.tests import tiny

torch.set_num_threads(1)
SEED = 2**31 + 101
LR = 1e-5


def _config() -> dict:
    cfg = json.loads((bench.BENCH_DIR / "configs" / "celeba256_spatial.json").read_text())
    cfg["model"].update(tiny.TINY_MODEL)
    cfg["loss"].update(tiny.TINY_LOSS, swap_weight=0.5)
    # A first update that moves the parameters (the schedule's warm-up starts at 0).
    cfg["optim"].update(lr=LR, warmup_steps=0)
    return cfg


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg = _config()
    b, s = 4, cfg["model"]["img_size"]
    images = program.image_pool(1, b, s, SEED, "cpu")[0]
    ids = np.arange(b) + 17
    tmp = tmp_path_factory.mktemp("spatial_reference")
    np.savez(tmp / "inputs.npz", config=np.asarray(json.dumps(cfg)), seed=np.asarray(SEED),
             space=np.asarray(2), images=images.numpy(), aug_id=ids, profile=np.asarray(False))
    out = launch("bench", 4, tmp / "inputs.npz", tmp / "out", timeout=120)
    want = sharded.reference_steps(cfg, program.model_weights(cfg, SEED, "cpu"),
                                   program.vgg_weights(cfg, SEED, "cpu"), [(images, ids)],
                                   SEED, "cpu", n_data=2)
    return cfg, out, want


def _gaps(rank: dict, tag: str, cfg: dict, want: dict) -> dict:
    """The worst loss, gradient and parameter gaps of one rank's step, each
    over its tolerance (1 is the edge)."""
    loss = float(rank[f"{tag}metric/loss"])
    out = {"loss": abs(loss - want["losses"][0]) / abs(want["losses"][0]) / 2e-6}
    b1 = cfg["optim"]["b1"]
    grad = param = 0.0
    median = float(np.median([float(g.abs().max()) for g in want["g1"].values()]))
    for k, g_ref in want["g1"].items():
        g = torch.from_numpy(rank[f"{tag}mu/{k}"]) / (1.0 - b1)
        scale = max(float(g_ref.abs().max()), median)
        grad = max(grad, float((g - g_ref).abs().max()) / (2e-5 * scale))
        p = torch.from_numpy(rank[f"{tag}param/{k}"])
        param = max(param, float((p - want["p_end"][k]).abs().max()) / (2.5 * LR))
    out.update(grad=grad, param=param)
    return out


def test_spatial_step_agrees_with_the_sharded_reference(ranks):
    cfg, out, want = ranks
    for r, rank in enumerate(out):
        gaps = _gaps(rank, "program/", cfg, want)
        assert all(v <= 1.0 for v in gaps.values()), (r, gaps)
    # The update moved the parameters: the comparison is not of p0 with itself.
    moved = max(float((want["p_end"][k] - want["p0"][k]).abs().max()) for k in want["p0"])
    assert moved > 0.5 * LR


def test_no_halo_breaks_the_agreement(ranks):
    cfg, out, want = ranks
    gaps = _gaps(out[0], "no_halo/", cfg, want)
    assert gaps["loss"] > 100 and gaps["grad"] > 100, gaps
