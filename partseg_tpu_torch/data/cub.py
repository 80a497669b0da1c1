"""The port's copy of partseg_tpu/data/cub.py (numpy and ctypes, no JAX).

CUB-200-2011 birds (articulated objects with background clutter, [B:9]).

Disk layout (under $PARTSEG_DATA/CUB_200_2011): the standard release —
  images.txt              `id relpath`
  images/<relpath>
  bounding_boxes.txt      `id x y w h`
  train_test_split.txt    `id is_train`
  parts/part_locs.txt     `id part_id x y visible` (15 parts)

Examples are bbox-cropped (square, padded) then resized; the 15 part
locations act as eval landmarks (visible ones; invisible → NaN, and the
eval normalizer should use the bbox diagonal, not IOD).
"""

from __future__ import annotations

import pathlib

import numpy as np

from partseg_tpu_torch.data.base import ImageListDataset
from partseg_tpu_torch.data.registry import data_root, register

N_PARTS = 15


@register("cub")
def cub(split: str = "train", size: int = 128, **_):
    root = pathlib.Path(data_root()) / "CUB_200_2011"
    ids, relpaths = [], {}
    for line in (root / "images.txt").read_text().splitlines():
        i, p = line.split()
        ids.append(i)
        relpaths[i] = p
    is_train = {}
    for line in (root / "train_test_split.txt").read_text().splitlines():
        i, t = line.split()
        is_train[i] = t == "1"
    bboxes = {}
    for line in (root / "bounding_boxes.txt").read_text().splitlines():
        i, x, y, w, h = line.split()
        bboxes[i] = (float(x), float(y), float(w), float(h))
    part_locs: dict[str, np.ndarray] = {}
    pl_file = root / "parts" / "part_locs.txt"
    if pl_file.exists():
        for line in pl_file.read_text().splitlines():
            i, pid, x, y, vis = line.split()
            arr = part_locs.setdefault(i, np.full((N_PARTS, 2), np.nan, np.float32))
            if vis == "1":
                arr[int(pid) - 1] = (float(x), float(y))

    want_train = split in ("train", "unsup")
    sel = [i for i in ids if is_train[i] == want_train]
    return ImageListDataset(
        paths=[root / "images" / relpaths[i] for i in sel],
        size=size,
        bboxes=[bboxes[i] for i in sel],
        landmarks=[part_locs.get(i, np.full((N_PARTS, 2), np.nan, np.float32)) for i in sel]
        if part_locs
        else None,
    )
