"""Appearance transfer, twin of partseg_tpu/evals/transfer.py: shape
(μ, Σ) from one image, per-part appearance from another, decode → an
image with the first's geometry and the second's appearance."""

from __future__ import annotations

import numpy as np
import torch

from partseg_tpu_torch.evals.infer import as_images, model_device
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
