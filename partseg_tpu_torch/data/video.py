"""The port's copy of partseg_tpu/data/video.py (numpy and ctypes, no JAX).

Video-frame datasets: Human3.6M and Penn Action ([B:11]).

Both are consumed as individual frames for the large-batch DP training
config (SURVEY.md §2.1). Expected pre-extracted-frame layouts:

Human3.6M  ($PARTSEG_DATA/human36m):
  frames/<subject>/<action>/<%06d>.jpg
  splits: subjects S1,S5,S6,S7,S8 train / S9,S11 test (standard protocol)

Penn Action ($PARTSEG_DATA/penn_action):
  frames/<seq>/<%06d>.jpg
  labels/<seq>.npz with keys x [T,13], y [T,13], visibility [T,13],
  train [1] (the .mat release converted to npz; a converter is in
  tools/convert_penn_action.py)
"""

from __future__ import annotations

import pathlib

import numpy as np

from partseg_tpu_torch.data.base import ImageListDataset
from partseg_tpu_torch.data.registry import data_root, register

_H36M_TRAIN = ("S1", "S5", "S6", "S7", "S8")
_H36M_TEST = ("S9", "S11")


@register("human36m")
def human36m(split: str = "train", size: int = 128, stride: int = 10, **_):
    root = pathlib.Path(data_root()) / "human36m" / "frames"
    subjects = _H36M_TRAIN if split in ("train", "unsup") else _H36M_TEST
    paths = []
    for s in subjects:
        sdir = root / s
        if not sdir.exists():
            continue
        for action in sorted(p for p in sdir.iterdir() if p.is_dir()):
            frames = sorted(action.glob("*.jpg"))
            paths.extend(frames[::stride])      # temporal subsampling
    if not paths:
        raise FileNotFoundError(f"no Human3.6M frames under {root}")
    return ImageListDataset(paths=paths, size=size)


@register("penn_action")
def penn_action(split: str = "train", size: int = 128, stride: int = 5, **_):
    root = pathlib.Path(data_root()) / "penn_action"
    frame_root = root / "frames"
    label_root = root / "labels"
    paths, lms = [], []
    want_train = split in ("train", "unsup")
    for seq_dir in sorted(p for p in frame_root.iterdir() if p.is_dir()):
        lab = label_root / f"{seq_dir.name}.npz"
        joints = None
        if lab.exists():
            d = np.load(lab)
            if bool(d["train"].reshape(-1)[0]) != want_train:
                continue
            vis = d["visibility"].astype(bool)          # [T, 13]
            joints = np.stack([d["x"], d["y"]], axis=-1).astype(np.float32)
            joints[~vis] = np.nan
        frames = sorted(seq_dir.glob("*.jpg"))[::stride]
        for f in frames:
            t = int(f.stem) - 1
            paths.append(f)
            if joints is not None and t < len(joints):
                lms.append(joints[t])
            else:
                lms.append(np.full((13, 2), np.nan, np.float32))
    if not paths:
        raise FileNotFoundError(f"no Penn Action frames under {frame_root}")
    return ImageListDataset(paths=paths, size=size, landmarks=lms)
