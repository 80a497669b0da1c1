"""End-to-end accuracy check on the synthetic blobs dataset, the port's
twin of tools/validate_synthetic.py: train the ``synthetic`` preset for a
few hundred steps through the port's loop, then check that

  1. the equivariance loss falls substantially (last < 0.5 × first), and
  2. soft-argmax μ predicts the true blob centres through the landmark
     regression protocol (error in % of the image diagonal) far better
     than a model with random weights (trained < 0.6 × random).

    python -m partseg_tpu_torch.tools.validate_synthetic [--steps 600] \\
        [--out_dir logs/validate_synthetic] [--set KEY=VAL ...] [--eval_only] [--cpu] \
        [--deterministic] [--no_tf32]

Prints one JSON line with the JAX tool's keys, then VALIDATION PASS or
FAIL; the exit code is 0 on a pass. It runs on the CUDA card unless --cpu.
With --deterministic it trains with ``torch.use_deterministic_algorithms``
(the card's default algorithms sum in no fixed order, so two runs of the
same seed may differ), and two runs give the same numbers. --no_tf32
turns TF32 off for convolutions (PyTorch's default has it on), as
chip_smoke.py runs them.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np


def main(steps: int = 600, out_dir: str = "logs/validate_synthetic",
         overrides: list | None = None, eval_only: bool = False, device=None) -> dict:
    from partseg_tpu_torch.data import build_dataset, make_loader
    from partseg_tpu_torch.device import default_device
    from partseg_tpu_torch.evals.infer import load_model_and_params
    from partseg_tpu_torch.evals.landmarks import (
        collect_mu,
        fit_landmark_regressor,
        landmark_error,
    )
    from partseg_tpu_torch.models.partnet import PartNet, init_weights
    from partseg_tpu_torch.train.config import apply_overrides, load_config
    from partseg_tpu_torch.train.loop import train

    cfg = load_config("synthetic").replace(steps=steps, ckpt_dir=out_dir, log_every=50,
                                           image_log_every=0)
    cfg = apply_overrides(cfg, overrides or [])
    we = cfg.augment.warp_every
    if we > 1 and cfg.steps % we:
        # The loop runs whole warp_every periods: round the budget up.
        cfg = cfg.replace(steps=cfg.steps + we - cfg.steps % we)

    dev = default_device(device)
    if eval_only:
        model = load_model_and_params(cfg, out_dir, device=dev)
    else:
        model = train(cfg, restore=False, device=dev).model.eval()

    hist = [json.loads(line) for line in
            pathlib.Path(out_dir, "metrics.jsonl").read_text().splitlines()]
    first_eq = next(h["equiv"] for h in hist if h["step"] <= 50)
    last_eq = hist[-1]["equiv"]

    # Synthetic blobs have no eyes: the normaliser is the full diagonal of
    # the [-1, 1]² frame, 2·√2.
    kwargs = dict(cfg.dataset_kwargs)

    def diag(gt):
        return np.full(len(gt), 2.0 * np.sqrt(2.0))

    def error_for(m):
        tr = make_loader(build_dataset("synthetic", split="val", **kwargs),
                         64, shuffle=False, num_epochs=1)
        te = make_loader(build_dataset("synthetic", split="test", **kwargs),
                         64, shuffle=False, num_epochs=1)
        mu_tr, gt_tr = collect_mu(m, tr, max_batches=8)
        mu_te, gt_te = collect_mu(m, te, max_batches=8)
        W = fit_landmark_regressor(mu_tr, gt_tr)
        return landmark_error(W, mu_te, gt_te, iod_fn=diag)

    trained_err = error_for(model)
    random_model = init_weights(PartNet(cfg.model, device="cpu"), seed=123).to(dev).eval()
    random_err = error_for(random_model)

    ok = last_eq < first_eq * 0.5 and trained_err < random_err * 0.6
    result = {
        "equiv_first": round(float(first_eq), 4),
        "equiv_last": round(float(last_eq), 4),
        "equiv_reduction": round(float(first_eq / max(last_eq, 1e-9)), 2),
        "landmark_err_pct_diag_trained": round(trained_err, 3),
        "landmark_err_pct_diag_random": round(random_err, 3),
        "steps": steps,
        "ok": ok,
    }
    print(json.dumps(result))
    print("VALIDATION", "PASS" if ok else "FAIL")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--out_dir", default="logs/validate_synthetic")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL")
    ap.add_argument("--eval_only", action="store_true",
                    help="skip training; evaluate the out_dir checkpoint")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("--deterministic", action="store_true",
                    help="train with torch.use_deterministic_algorithms")
    ap.add_argument("--no_tf32", action="store_true", help="convolutions without TF32")
    a = ap.parse_args()
    if a.deterministic or a.no_tf32:
        import os

        import torch

        if a.deterministic:
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # before cuBLAS starts
            torch.use_deterministic_algorithms(True)
        if a.no_tf32:
            torch.backends.cudnn.allow_tf32 = False
    raise SystemExit(0 if main(a.steps, a.out_dir, getattr(a, "set"), eval_only=a.eval_only,
                               device="cpu" if a.cpu else None)["ok"] else 1)
