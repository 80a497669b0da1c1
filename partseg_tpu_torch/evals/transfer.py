"""Appearance transfer, twin of partseg_tpu/evals/transfer.py: shape
(μ, Σ) from one image, per-part appearance from another, decode → an
image with the first's geometry and the second's appearance.

CLI (the CUDA card unless --cpu):
    python -m partseg_tpu_torch.evals.transfer --config configs/deepfashion.py \\
        --ckpt_dir logs/deepfashion --shape a.jpg --appearance b.jpg --out t.png [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from partseg_tpu_torch.evals.export import as_images, model_device
from partseg_tpu_torch.evals.infer import load_model_and_params, read_image, write_image
from partseg_tpu_torch.models.partnet import PartNet
from partseg_tpu_torch.partops.pooling import pool_appearance


@torch.inference_mode()
def transfer_batch(model: PartNet, shape_imgs, app_imgs) -> torch.Tensor:
    """shape_imgs, app_imgs [B, H, W, 3] in [0,1] → [B, S, S, 3] tensor on
    the model's device (S = the decoder's output size)."""
    device = model_device(model)
    xs = as_images(shape_imgs, device)
    xa = as_images(app_imgs, device)
    _, mu, sigma = model.shape_stats(model.encode_shape(xs))
    parts_a, _, _ = model.shape_stats(model.encode_shape(xa))
    app_vec = pool_appearance(model.encode_appearance(xa), parts_a)
    return model.decode(mu, sigma, app_vec)


def transfer(model: PartNet, shape_img, app_img) -> np.ndarray:
    """shape_img, app_img [H, W, 3] f32 in [0,1] → [S, S, 3] numpy transfer."""
    device = model_device(model)
    out = transfer_batch(model, as_images(shape_img, device)[None],
                         as_images(app_img, device)[None])
    return out[0].float().cpu().numpy()


def full_size_decoder(cfg):
    """``cfg`` with the decoder at the full image size: throughput configs
    train the (fully convolutional) decoder at the loss resolution, and
    inference decodes at full size with the same parameters."""
    if not cfg.model.decoder_out_size:
        return cfg
    return cfg.replace(model=dataclasses.replace(cfg.model, decoder_out_size=None))


def main(argv=None):
    ap = argparse.ArgumentParser(description="partseg_tpu_torch appearance transfer")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--shape", required=True, help="image providing geometry")
    ap.add_argument("--appearance", required=True, help="image providing appearance")
    ap.add_argument("--out", default="transfer_out.png")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)

    from partseg_tpu_torch.train.config import load_config

    cfg = full_size_decoder(load_config(args.config))
    model = load_model_and_params(cfg, args.ckpt_dir, device="cpu" if args.cpu else None)
    s = cfg.model.img_size
    out = transfer(model, read_image(args.shape, s), read_image(args.appearance, s))
    write_image(args.out, out)
    print(f"[transfer] wrote {args.out}")


if __name__ == "__main__":
    main()
