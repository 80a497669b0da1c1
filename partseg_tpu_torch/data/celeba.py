"""The port's copy of partseg_tpu/data/celeba.py (numpy and ctypes, no JAX).

CelebA / CelebA-in-the-wild with MAFL landmark splits.

Role parity: SURVEY.md §2.1 dataset table + [B:7,8]. Disk layout
(under $PARTSEG_DATA/celeba):

  img_align_celeba/ *.jpg            (aligned) — or
  img_celeba/ *.jpg                  (wild)
  list_landmarks_align_celeba.txt    (5 landmarks: eyes, nose, mouth x2)
  list_landmarks_celeba.txt          (wild landmarks)
  mafl_training.txt / mafl_testing.txt  (MAFL split: one filename/line)

Landmark layout keeps eyes at indices 0, 1 — the IOD normalizer in
evals/landmarks.py depends on it.
"""

from __future__ import annotations

import pathlib

import numpy as np

from partseg_tpu_torch.data.base import ImageListDataset
from partseg_tpu_torch.data.registry import data_root, register


def _read_landmark_file(path: pathlib.Path) -> dict[str, np.ndarray]:
    """CelebA list_landmarks format: header lines then
    `name x1 y1 x2 y2 ... x5 y5`."""
    out = {}
    with open(path) as f:
        lines = f.read().strip().splitlines()
    for line in lines:
        parts = line.split()
        if len(parts) != 11:
            continue  # header rows
        try:
            vals = np.array([float(v) for v in parts[1:]], np.float32)
        except ValueError:
            continue
        out[parts[0]] = vals.reshape(5, 2)  # (x, y) pixels
    return out


def _load(root: pathlib.Path, wild: bool, split: str, size: int) -> ImageListDataset:
    img_dir = root / ("img_celeba" if wild else "img_align_celeba")
    lm_file = root / (
        "list_landmarks_celeba.txt" if wild else "list_landmarks_align_celeba.txt"
    )
    lms = _read_landmark_file(lm_file)

    if split in ("train", "test"):
        split_file = root / f"mafl_{'training' if split == 'train' else 'testing'}.txt"
        names = split_file.read_text().split()
        # MAFL training protocol uses the annotated split for the
        # regressor; unsupervised model training uses the full set minus
        # MAFL test (split="unsup").
    elif split == "unsup":
        test_names = set((root / "mafl_testing.txt").read_text().split())
        names = [n for n in sorted(lms) if n not in test_names]
    else:
        raise ValueError(f"unknown split {split!r} (train|test|unsup)")

    names = [n for n in names if n in lms]
    return ImageListDataset(
        paths=[img_dir / n for n in names],
        size=size,
        landmarks=[lms[n] for n in names],
    )


@register("celeba")
def celeba(split: str = "train", size: int = 128, **_):
    return _load(pathlib.Path(data_root()) / "celeba", wild=False, split=split, size=size)


@register("celeba_wild")
def celeba_wild(split: str = "train", size: int = 128, **_):
    return _load(pathlib.Path(data_root()) / "celeba", wild=True, split=split, size=size)
