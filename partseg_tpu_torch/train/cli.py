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

Several processes train one model, data-parallel or with the image rows
split over ``space_shards`` ranks (``celeba256_spatial``), when ``torchrun``
starts them (or each is given ``RANK``, ``WORLD_SIZE`` and ``--coordinator``):

    torchrun --standalone --nproc_per_node=2 -m partseg_tpu_torch.train.cli \\
        --config speed128 --set global_batch=256

Each rank trains on ``cuda:LOCAL_RANK`` with NCCL. Two ranks on one card
must say so with ``--device cuda:0`` and take ``--dist_backend gloo``
(NCCL refuses two ranks on one GPU); on the CPU, ``--device cpu`` takes
gloo.
"""

from __future__ import annotations

import argparse
import os
import sys

from partseg_tpu_torch.train.config import apply_overrides, load_config


def rank_device(device: str | None, backend: str | None, world: int, local_rank: int,
                n_cuda: int) -> tuple[str | None, str]:
    """(device, backend) of this rank: ``cuda:LOCAL_RANK`` (the card, None,
    for a single process) and NCCL unless asked otherwise, gloo for the CPU.
    Raises where NCCL would meet two ranks on one card, or a rank would have
    no card of its own."""
    shared = device is not None and device != "cpu"     # every rank names the same card
    if device is None and world > 1:
        if local_rank >= n_cuda:
            raise SystemExit(
                f"rank {local_rank} of {world} on this host has no card of its own "
                f"({n_cuda} visible): give --device cuda:0 --dist_backend gloo to put "
                "several ranks on one card")
        device = f"cuda:{local_rank}"
    if backend is None:
        backend = "gloo" if device == "cpu" else "nccl"
    if backend == "nccl" and world > 1 and shared:
        raise SystemExit(
            f"--device {device} puts several ranks on one card, which NCCL refuses: "
            "give --dist_backend gloo")
    return device, backend


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
                    help="the process group's address, host:port (tcp://) or an init URL "
                         "(file://...); the rank and world size come from RANK and WORLD_SIZE. "
                         "torchrun needs none")
    ap.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"),
                    help="the collectives' backend (default: nccl on CUDA, gloo on the CPU)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True): a rerun or a resume "
                         "repeats the losses bit for bit (at some cost in speed)")
    ap.add_argument("--debug_nans", action="store_true",
                    help="autograd anomaly detection, and stop at a non-finite loss")
    ap.add_argument("--device", default=None,
                    help="the torch device (default: the CUDA card, cuda:LOCAL_RANK under "
                         "several ranks; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--check_data", action="store_true",
                    help="validate the config's dataset layout under $PARTSEG_DATA "
                         "(docs/real_data.md) and exit")
    args = ap.parse_args(argv)

    cfg = apply_overrides(load_config(args.config), args.set)
    if args.check_data:
        from partseg_tpu_torch.data.check import check_data

        sys.exit(0 if check_data(cfg.dataset, dict(cfg.dataset_kwargs)) else 1)
    if args.steps is not None:
        cfg = cfg.replace(steps=args.steps)
    if args.ckpt_dir is not None:
        cfg = cfg.replace(ckpt_dir=args.ckpt_dir)

    import torch
    import torch.distributed as dist

    from partseg_tpu_torch.dist.mesh import init_distributed, local_rank
    from partseg_tpu_torch.train.loop import train

    if args.deterministic:
        # cuBLAS needs a fixed workspace before its first handle exists.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    n_cuda = torch.cuda.device_count() if args.device != "cpu" else 0
    device, backend = rank_device(args.device, args.dist_backend, world, local_rank(), n_cuda)
    if init_distributed(args.coordinator, backend, torch.device(device or "cuda")):
        print(f"[train] rank {dist.get_rank()} of {dist.get_world_size()}, backend {backend}, "
              f"device {device}", flush=True)
    try:
        train(cfg, restore=not args.no_restore, device=device, debug_nans=args.debug_nans)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
