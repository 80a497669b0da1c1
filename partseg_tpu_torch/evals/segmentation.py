"""Part-segmentation IoU eval (the GCPR'20 path), the port's twin of
partseg_tpu/evals/segmentation.py: the argmax of the per-pixel part
softmax is a dense part segmentation; IoU per part and mIoU against the
annotations after a part → class matching; foreground IoU treats the union
of the K parts as foreground (background = class 0 when the model has a
background channel). The forward runs on the model's device; the metrics
are numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from partseg_tpu_torch.evals.export import as_images, model_device
from partseg_tpu_torch.evals.landmarks import pad_batch
from partseg_tpu_torch.models.partnet import PartNet


def segmentation_iou(
    pred: np.ndarray,
    gt: np.ndarray,
    n_classes: int,
    ignore_index: int | None = None,
) -> dict[str, float]:
    """IoU metrics from label maps.

    Args:
      pred, gt: [N, H, W] integer label maps (0 = background).
      n_classes: number of classes incl. background.
      ignore_index: gt label to exclude from all metrics.

    Returns {"miou", "fg_iou", "iou_<c>"...}.
    """
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    valid = np.ones_like(gt, bool) if ignore_index is None else gt != ignore_index

    ious = {}
    per_class = []
    for c in range(n_classes):
        p = (pred == c) & valid
        g = (gt == c) & valid
        inter = np.logical_and(p, g).sum()
        union = np.logical_or(p, g).sum()
        if union > 0:
            iou = inter / union
            ious[f"iou_{c}"] = float(iou)
            per_class.append(iou)
    ious["miou"] = float(np.mean(per_class)) if per_class else 0.0

    pf = (pred != 0) & valid
    gf = (gt != 0) & valid
    union = np.logical_or(pf, gf).sum()
    ious["fg_iou"] = float(np.logical_and(pf, gf).sum() / union) if union else 0.0
    return ious


def evaluate_segmentation(
    model: PartNet,
    data_iter,
    n_classes: int,
    max_batches: int | None = None,
) -> dict[str, float]:
    """The GCPR'20-style protocol over a split with "mask" labels: batched
    forwards → per-pixel argmax part labels (bg = 0, part k → k+1) →
    majority-vote part→class matching over the whole split → IoU metrics.
    Predicted label maps are nearest-neighbour resampled to the label
    resolution (IoU at full label resolution; labels are never
    downsampled). Remainder batches are padded and trimmed, so the whole
    split is scored."""
    cfg = model.cfg
    device = model_device(model)
    preds, gts = [], []
    pad_to = None
    with torch.inference_mode():
        for i, batch in enumerate(data_iter):
            if max_batches is not None and i >= max_batches:
                break
            img = np.asarray(batch["image"])
            n = img.shape[0]
            pad_to = pad_to or n
            logits = model.encode_shape(as_images(pad_batch(img, pad_to), device))
            seg = torch.argmax(model.segmentation(logits), dim=-1)
            if cfg.background:
                seg = torch.where(seg == cfg.n_parts, 0, seg + 1)
            seg = seg[:n].cpu().numpy()
            gt = np.asarray(batch["mask"])
            if gt.shape[1:] != seg.shape[1:]:   # resample predictions to label res
                seg = nn_resize_labels(seg, gt.shape[1], gt.shape[2])
            preds.append(seg)
            gts.append(gt)
    pred = np.concatenate(preds)
    gt = np.concatenate(gts)
    mapping = match_parts_to_classes(pred, gt, cfg.n_parts, n_classes)
    return segmentation_iou(mapping[pred], gt, n_classes)


def nn_resize_labels(seg: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbour resize of integer label maps [N, h, w] → [N, out_h,
    out_w], pixel-centre convention (align_corners=False, as
    partops/coords.py), at any ratio, not only integer upsampling."""
    n, h, w = seg.shape
    ys = np.minimum(((np.arange(out_h) + 0.5) * h / out_h).astype(np.int64), h - 1)
    xs = np.minimum(((np.arange(out_w) + 0.5) * w / out_w).astype(np.int64), w - 1)
    return seg[:, ys[:, None], xs[None, :]]


def match_parts_to_classes(
    pred_parts: np.ndarray, gt: np.ndarray, n_parts: int, n_classes: int
) -> np.ndarray:
    """Majority-vote assignment of unsupervised parts → annotated classes
    (discovered parts are unordered). Returns mapping [n_parts+1] with
    background fixed to 0; apply as mapping[pred_label_map]."""
    mapping = np.zeros(n_parts + 1, np.int64)
    for k in range(1, n_parts + 1):
        mask = pred_parts == k
        if mask.sum() == 0:
            continue
        votes = np.bincount(gt[mask].reshape(-1), minlength=n_classes)
        mapping[k] = int(np.argmax(votes))
    return mapping
