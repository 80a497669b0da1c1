"""The port's copy of partseg_tpu/data/base.py (numpy and ctypes, no JAX).

Shared loader machinery for the real-image datasets.

Role parity: the reference's per-dataset edflow `DatasetMixin`
subclasses (SURVEY.md §2.1 "Dataset loaders", [B:7-11]): indexable,
`__getitem__(i) → {"image": [S,S,3] f32 in [0,1], "landmarks": [L,2]}`.
Host work is decode + crop + resize ONLY — augmentation happens
on-device (SURVEY.md §1 L2).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np


def load_image(path: str | pathlib.Path) -> np.ndarray:
    """Read an image file → RGB float32 [H, W, 3] in [0, 1]."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].astype(np.float32) / 255.0


def crop_resize(
    img: np.ndarray,
    size: int,
    bbox: tuple[float, float, float, float] | None = None,
    landmarks: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Optionally crop to bbox (x, y, w, h), resize to size², and map
    landmarks (pixel coords in the ORIGINAL image) into normalized
    [-1, 1] coords of the output crop. Returns (image, landmarks)."""
    import cv2

    h, w = img.shape[:2]
    if bbox is not None:
        x0, y0, bw, bh = bbox
        # Square crop around the bbox center, padded to stay in-image.
        side = max(bw, bh)
        cx, cy = x0 + bw / 2.0, y0 + bh / 2.0
        x0 = int(round(max(0, min(cx - side / 2.0, w - side))))
        y0 = int(round(max(0, min(cy - side / 2.0, h - side))))
        side = int(round(min(side, w, h)))
        img = img[y0 : y0 + side, x0 : x0 + side]
        crop_origin = np.array([y0, x0], np.float32)
        crop_side = np.array([side, side], np.float32)
    else:
        # Center square crop.
        side = min(h, w)
        y0 = (h - side) // 2
        x0 = (w - side) // 2
        img = img[y0 : y0 + side, x0 : x0 + side]
        crop_origin = np.array([y0, x0], np.float32)
        crop_side = np.array([side, side], np.float32)

    out = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    lm = None
    if landmarks is not None:
        # landmarks come in as (x, y) pixels; emit (y, x) in [-1, 1].
        yx = landmarks[:, ::-1].astype(np.float32)
        rel = (yx - crop_origin) / crop_side            # [0, 1] in crop
        lm = (rel * 2.0 - 1.0).astype(np.float32)
    return out.astype(np.float32), lm


@dataclasses.dataclass
class ImageListDataset:
    """Generic (path, bbox, landmarks) table → examples."""

    paths: list
    size: int
    bboxes: list | None = None
    landmarks: list | None = None

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        img = load_image(self.paths[idx])
        bbox = self.bboxes[idx] if self.bboxes is not None else None
        lms = self.landmarks[idx] if self.landmarks is not None else None
        img, lm = crop_resize(img, self.size, bbox, lms)
        out = {"image": img}
        if lm is not None:
            out["landmarks"] = lm
        return out
