"""CLI: ``python -m partseg_tpu_torch.train.cli --config speed128``.

The port's counterpart of ``python -m partseg_tpu.train.cli``: a preset
name or a config file (``configs/<name>.py`` names the port's preset),
dot-path overrides, restore-latest by default. It trains on the CUDA card
unless ``--device cpu`` is given. The JAX CLI's ``--platform`` is
``--device`` here; its ``--segment_steps``, which restarts the trainer
every N steps to bound a leak of the TPU transport's host staging
buffers, has no counterpart.

    python -m partseg_tpu_torch.train.cli --config synthetic --device cpu --steps 20 \\
        --set model.img_size=16 global_batch=8
"""

from __future__ import annotations

import argparse
import sys

from partseg_tpu_torch.train.config import apply_overrides, load_config


def main(argv=None):
    ap = argparse.ArgumentParser(description="partseg_tpu_torch trainer")
    ap.add_argument("--config", "-b", required=True,
                    help="a preset name, or a Python config file")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                    help="dot-path overrides, e.g. optim.lr=3e-4")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt_dir", "-p", default=None, help="run/project dir")
    ap.add_argument("--no-restore", action="store_true")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process address: not supported until data parallel "
                         "training is ported")
    ap.add_argument("--debug_nans", action="store_true",
                    help="autograd anomaly detection, and stop at a non-finite loss")
    ap.add_argument("--device", default=None,
                    help="the torch device (default: the CUDA card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--check_data", action="store_true",
                    help="validate the config's dataset layout under $PARTSEG_DATA "
                         "(docs/real_data.md) and exit")
    args = ap.parse_args(argv)

    cfg = apply_overrides(load_config(args.config), args.set)
    if args.check_data:
        from partseg_tpu_torch.data.check import check_data

        sys.exit(0 if check_data(cfg.dataset, dict(cfg.dataset_kwargs)) else 1)
    if args.coordinator:
        raise SystemExit("--coordinator: multi-process (data parallel) training is not "
                         "ported yet (ROADMAP Queue 1 item 5)")
    if args.steps is not None:
        cfg = cfg.replace(steps=args.steps)
    if args.ckpt_dir is not None:
        cfg = cfg.replace(ckpt_dir=args.ckpt_dir)

    from partseg_tpu_torch.train.loop import train

    train(cfg, restore=not args.no_restore, device=args.device, debug_nans=args.debug_nans)


if __name__ == "__main__":
    main()
