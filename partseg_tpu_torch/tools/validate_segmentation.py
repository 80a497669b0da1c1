"""Segmentation-IoU check on synthetic blobs (the GCPR'20 eval path end
to end), the port's twin of tools/validate_segmentation.py: on the
checkpoint that validate_synthetic wrote, part-matched mIoU and
foreground IoU against the true blob masks, beside a model with random
weights.

    python -m partseg_tpu_torch.tools.validate_segmentation \\
        [--ckpt_dir logs/validate_synthetic] [--set KEY=VAL ...] [--cpu]

Prints one JSON line with the JAX tool's keys, then SEG VALIDATION PASS or
FAIL (the JAX tool's bar: mIoU above twice the random model's and
foreground IoU above 0.25); the exit code is 0 on a pass. It runs on the
CUDA card unless --cpu.
"""

from __future__ import annotations

import argparse
import json


def main(ckpt_dir: str, overrides: list | None = None, device=None) -> dict:
    from partseg_tpu_torch.data import SyntheticBlobs, make_loader
    from partseg_tpu_torch.device import default_device
    from partseg_tpu_torch.evals.infer import load_model_and_params
    from partseg_tpu_torch.evals.segmentation import evaluate_segmentation
    from partseg_tpu_torch.models.partnet import PartNet, init_weights
    from partseg_tpu_torch.train.config import apply_overrides, load_config

    cfg = apply_overrides(load_config("synthetic").replace(ckpt_dir=ckpt_dir), overrides or [])
    dev = default_device(device)
    model = load_model_and_params(cfg, ckpt_dir, device=dev)
    kwargs = dict(cfg.dataset_kwargs)
    kwargs.pop("n_examples", None)    # the eval split sizes itself below

    # Rendered once (the dataset caches its examples), scored for both models.
    ds = SyntheticBlobs(seed=2, n_examples=512, with_masks=True, **kwargs)

    def run(m):
        it = make_loader(ds, 64, shuffle=False, num_epochs=1, num_workers=4)
        return evaluate_segmentation(m, it, n_classes=ds.n_blobs + 1, max_batches=8)

    trained = run(model)
    rand = run(init_weights(PartNet(cfg.model, device="cpu"), seed=99).to(dev).eval())
    result = {
        "miou_trained": round(trained["miou"], 4),
        "fg_iou_trained": round(trained["fg_iou"], 4),
        "miou_random": round(rand["miou"], 4),
        "fg_iou_random": round(rand["fg_iou"], 4),
    }
    result["ok"] = trained["miou"] > 2 * rand["miou"] and trained["fg_iou"] > 0.25
    print(json.dumps(result))
    print("SEG VALIDATION", "PASS" if result["ok"] else "FAIL")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", default="logs/validate_synthetic")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    a = ap.parse_args()
    raise SystemExit(0 if main(a.ckpt_dir, getattr(a, "set"),
                               device="cpu" if a.cpu else None)["ok"] else 1)
