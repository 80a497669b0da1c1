"""The port's copy of partseg_tpu/data/check.py (numpy and ctypes, no JAX).

Pre-flight real-data validation (`train.cli --check_data`).

Validates that $PARTSEG_DATA holds the directory layout a config's
dataset expects (docs/real_data.md) by actually constructing each split
and decoding one example — the same code paths training and eval use,
so a PASS here means the run will get real pixels, not fixture luck.
"""

from __future__ import annotations

import traceback
from typing import Any

import numpy as np

# Splits each dataset supports (split name → needed for).
_SPLITS = {
    "synthetic": ["train", "test"],
    "celeba": ["unsup", "train", "test"],
    "celeba_wild": ["unsup", "train", "test"],
    "cub": ["train", "test"],
    "deepfashion": ["train", "test"],
    "human36m": ["train", "test"],
    "penn_action": ["train", "test"],
}


def check_split(name: str, split: str, kwargs: dict) -> dict[str, Any]:
    from partseg_tpu_torch.data.registry import build_dataset

    rec: dict[str, Any] = {"dataset": name, "split": split}
    try:
        ds = build_dataset(name, split=split, **kwargs)
        rec["n_examples"] = len(ds)
        ex = ds[0]
        img = np.asarray(ex["image"])
        rec["image_shape"] = list(img.shape)
        assert img.ndim == 3 and img.shape[-1] == 3, img.shape
        assert np.isfinite(img).all() and 0.0 <= img.min() <= img.max() <= 1.0
        if "landmarks" in ex:
            rec["n_landmarks"] = int(np.asarray(ex["landmarks"]).shape[0])
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — report, don't crash the check
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc(limit=2)
    return rec


def check_data(name: str, kwargs: dict | None = None) -> bool:
    """Print a per-split PASS/FAIL report for `name`; True if all pass."""
    from partseg_tpu_torch.data.registry import data_root
    from partseg_tpu_torch.losses.vgg import VGG19Features, load_vgg19

    kwargs = dict(kwargs or {})
    print(f"[check_data] dataset={name} PARTSEG_DATA={data_root()}")
    ok = True
    for split in _SPLITS.get(name, ["train", "test"]):
        rec = check_split(name, split, kwargs)
        if rec["ok"]:
            extra = f", landmarks={rec['n_landmarks']}" if "n_landmarks" in rec else ""
            print(f"  PASS {split}: {rec['n_examples']} examples, "
                  f"image {rec['image_shape']}{extra}")
        else:
            ok = False
            print(f"  FAIL {split}: {rec['error']}")
    # VGG weight provenance matters as much as the data (docs/real_data.md).
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mode = load_vgg19(VGG19Features(("relu1_2",), trim_blocks=1), None)
    print(f"  VGG19 weights: {mode}"
          + ("" if mode.startswith("pretrained")
             else "  (accuracy runs need tools/export_vgg19.py output)"))
    print(f"[check_data] {'PASS' if ok else 'FAIL'}")
    return ok
