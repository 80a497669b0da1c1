"""Convert Penn Action .mat labels to the npz layout data/video.py
expects, the port's copy of tools/convert_penn_action.py (numpy and
scipy only).

The Penn Action release ships labels/<seq>.mat (MATLAB). The datasets
read labels/<seq>.npz with keys x [T,13], y [T,13], visibility [T,13],
train [1]. Run once wherever scipy is available:

    python -m partseg_tpu_torch.tools.convert_penn_action /data/penn_action
"""

import pathlib
import sys

import numpy as np


def convert(root: pathlib.Path) -> int:
    from scipy.io import loadmat

    label_dir = root / "labels"
    n = 0
    for mat_path in sorted(label_dir.glob("*.mat")):
        m = loadmat(mat_path)
        out = {
            "x": np.asarray(m["x"], np.float32),
            "y": np.asarray(m["y"], np.float32),
            "visibility": np.asarray(m["visibility"], bool),
            "train": np.asarray(m["train"]).reshape(-1)[:1],
        }
        np.savez(mat_path.with_suffix(".npz"), **out)
        n += 1
    return n


if __name__ == "__main__":
    root = pathlib.Path(sys.argv[1])
    print(f"converted {convert(root)} label files under {root}")
