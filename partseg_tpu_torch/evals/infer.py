"""Inference entry points, twins of partseg_tpu/evals/export.py
(``make_infer_fn``) and partseg_tpu/evals/infer.py (``infer_image``):
the shape encoder alone gives part heatmaps, soft-argmax landmarks and
the dense part segmentation."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from partseg_tpu_torch.models.partnet import PartNet


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def as_images(images, device: torch.device) -> torch.Tensor:
    """NHWC numpy array or tensor in [0, 1] → f32 tensor on ``device``."""
    return torch.as_tensor(images, dtype=torch.float32, device=device)


def make_infer_fn(model: PartNet) -> Callable[[torch.Tensor], dict]:
    """Batched inference forward.

    images [B, H, W, 3] float in [0,1] (numpy or tensor) → dict of tensors
    on the model's device:
      heatmaps  [B, h, w, K]      per-part spatial distributions, f32
      logits    [B, h, w, K(+1)]  raw shape-encoder logits, f32
      landmarks [B, K, 2]         soft-argmax μ, (y, x) in [-1, 1]
      sigma     [B, K, 2, 2]      part covariances
      seg       [B, h, w]         int32 labels; with a background channel
                                  0 = background and part k → k+1
    """
    device = model_device(model)
    cfg = model.cfg

    @torch.inference_mode()
    def infer(images) -> dict:
        x = as_images(images, device)
        logits = model.encode_shape(x)
        parts, mu, sigma = model.shape_stats(logits)
        seg = torch.argmax(model.segmentation(logits), dim=-1).to(torch.int32)
        if cfg.background:
            # Softmax channel order is [parts..., bg]: bg → 0, part k → k+1.
            seg = torch.where(seg == cfg.n_parts, 0, seg + 1).to(torch.int32)
        return {"heatmaps": parts, "logits": logits, "landmarks": mu,
                "sigma": sigma, "seg": seg}

    return infer


def infer_image(model: PartNet, image) -> dict[str, np.ndarray]:
    """image [H, W, 3] float in [0,1] → numpy outputs for that image:
    heatmaps [h, w, K], seg [h, w], landmarks [K, 2], sigma [K, 2, 2],
    logits [h, w, K(+1)]."""
    out = make_infer_fn(model)(as_images(image, model_device(model))[None])
    return {k: v[0].cpu().numpy() for k, v in out.items()}
