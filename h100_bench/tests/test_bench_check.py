"""The check that decides ``correct``: the reference agrees with the program
at a tiny size on the CPU (the float32 program and the float32 reference
compute the same function), each fault a cell can have comes out not
correct, and, on the card, the float8 control comes out not correct at the
cell's own size."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from h100_bench import run as bench
from h100_bench.tests import tiny

SEED = 2**31 + 977
FAULTS = {"deepfashion_train_b256": ("frozen_state", "half_batch"),
          "celeba_transfer_b256": ("altered_answer",),
          "celeba_infer_b256": ("altered_answer",)}
CELLS = sorted(c["name"] for c in json.loads((bench.ROOT / "BENCHMARK.json").read_text())["workloads"])
# The float32 program against the float32 reference at the tiny size: the
# training step's numbers differ by float32 rounding (the update through
# Adam's first steps, each about lr · sign(g), amplifies it most).
AGREE = {"loss_gap": 1e-5, "grad_gap": 1e-3, "update_gap": 0.05, "recon_rmse": 1e-4, "recon_img_mae": 1e-4,
         "landmark_err": 1e-4, "heatmap_err": 1e-4, "sigma_err": 1e-4}


def _run(cell, variant="program", trace=False):
    return bench.run(cell, SEED, 0.3, trace, variant, device="cpu", spec=tiny.spec(cell))


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_reference_agrees_with_the_program(cell):
    r = _run(cell)
    readings = {**{name: c["value"] for name, c in r["checks"].items()}, **r["detail"]}
    for name, value in readings.items():
        assert value <= AGREE[name], (name, value)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs])
def test_a_fault_comes_out_not_correct(cell, fault):
    r = _run(cell, fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_traced_run_reports_the_cells_per_layer_metrics(cell):
    r = _run(cell, trace=True)
    names = {m["name"] for m in bench.cell_metrics(tiny.spec(cell), trace=True)}
    # No card: the device readers find no kernels and stay silent.
    assert set(r["metrics"]) <= names
    assert any("mfu" in n for n in r["metrics"]) or not names
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload",
                          "celeba_infer_b256", "--seed", str(SEED), "--seconds", "1"],
                         capture_output=True, text=True, cwd=bench.ROOT, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is visible to this process")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_float8_control_is_not_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "h100_bench.calibrate", "--workload", cell,
                          "--seeds", "11,12,13", "--variants", "control", "--seconds", "1"],
                         capture_output=True, text=True, cwd=bench.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3 and not any(x["correct"] for x in lines), lines
