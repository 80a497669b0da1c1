"""The port's copy of partseg_tpu/data/deepfashion.py (numpy and ctypes, no JAX).

DeepFashion In-shop (full-body, 16-part config, [B:10]).

Disk layout (under $PARTSEG_DATA/deepfashion):
  Img/img/...                        images
  Eval/list_eval_partition.txt       `path split(train|query|gallery)`
  Anno/list_landmarks_inshop.txt     `path cloth_type variation [v x y] * 8`

Landmarks: up to 8 fashion landmarks; occluded/invisible → NaN.
"""

from __future__ import annotations

import pathlib

import numpy as np

from partseg_tpu_torch.data.base import ImageListDataset
from partseg_tpu_torch.data.registry import data_root, register

N_LANDMARKS = 8


@register("deepfashion")
def deepfashion(split: str = "train", size: int = 128, **_):
    root = pathlib.Path(data_root()) / "deepfashion"
    part = {}
    lines = (root / "Eval" / "list_eval_partition.txt").read_text().splitlines()
    for line in lines[2:]:                      # count + header rows
        fields = line.split()
        if len(fields) >= 2:
            part[fields[0]] = fields[-1]
    want = {"train": "train", "unsup": "train", "test": "gallery", "val": "query"}[split]

    lms: dict[str, np.ndarray] = {}
    anno = root / "Anno" / "list_landmarks_inshop.txt"
    if anno.exists():
        for line in anno.read_text().splitlines()[2:]:
            f = line.split()
            if len(f) < 3:
                continue
            name = f[0]
            vals = f[3:]
            arr = np.full((N_LANDMARKS, 2), np.nan, np.float32)
            for j in range(min(len(vals) // 3, N_LANDMARKS)):
                vis, x, y = vals[3 * j : 3 * j + 3]
                if vis == "0":                 # 0 = visible in this format
                    arr[j] = (float(x), float(y))
            lms[name] = arr

    names = [n for n, s in part.items() if s == want]
    return ImageListDataset(
        paths=[root / "Img" / n for n in names],
        size=size,
        landmarks=[lms.get(n, np.full((N_LANDMARKS, 2), np.nan, np.float32)) for n in names]
        if lms
        else None,
    )
