"""Eval CLI, the port's twin of partseg_tpu/evals/cli.py: the landmark
regression protocol over an annotated split, on the CUDA card unless
--cpu.

    python -m partseg_tpu_torch.evals.cli --config configs/celeba.py \\
        --ckpt_dir logs/celeba [--dataset celeba_mafl] [--max_batches N] \\
        [--dump OUT.npz] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from partseg_tpu_torch.data import build_dataset, make_loader
from partseg_tpu_torch.evals.infer import load_model_and_params
from partseg_tpu_torch.evals.landmarks import collect_mu, evaluate_landmarks
from partseg_tpu_torch.train.config import load_config


def main(argv=None):
    ap = argparse.ArgumentParser(description="partseg_tpu_torch landmark eval")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--dataset", default=None, help="override cfg.dataset")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max_batches", type=int, default=None)
    ap.add_argument("--dump", default=None, metavar="OUT.npz",
                    help="also dump mu and the ground truth of the test split")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    name = args.dataset or cfg.dataset
    model = load_model_and_params(cfg, args.ckpt_dir, device="cpu" if args.cpu else None)
    kwargs = dict(cfg.dataset_kwargs)

    def split(which: str):
        # drop_remainder=False: the protocol scores the WHOLE split (MAFL-test
        # is 1,000 images); collect_mu pads and trims the remainder batch.
        return make_loader(build_dataset(name, split=which, **kwargs), args.batch,
                           shuffle=False, num_epochs=1, drop_remainder=False)

    if args.dump:
        mu_te, gt_te = collect_mu(model, split("test"), args.max_batches)
        np.savez_compressed(args.dump, mu=mu_te, landmarks=gt_te)
        print(f"[eval] dumped {len(mu_te)} examples to {args.dump}")

    metrics = evaluate_landmarks(model, split("train"), split("test"),
                                 max_batches=args.max_batches)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
