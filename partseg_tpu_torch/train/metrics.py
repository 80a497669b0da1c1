"""Metrics and logging, the port's copy of partseg_tpu/train/metrics.py.

Scalar metrics go to stdout as JSON lines and to ``metrics.jsonl`` in the
run dir; TensorBoard summaries through ``torch.utils.tensorboard`` when it
imports (on the first record: where TensorFlow is installed, that import
loads it); image grids as PNGs through ``cv2`` when it imports. A machine
without TensorBoard or cv2 (the H100 host has neither) still gets the
JSON lines.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Mapping

import numpy as np


_UNSET = object()


class MetricLogger:
    def __init__(self, run_dir: str):
        self._dir = pathlib.Path(run_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self._dir / "metrics.jsonl", "a")
        self._tb = _UNSET

    def _writer(self):
        """The TensorBoard writer, made on first use; None where
        ``torch.utils.tensorboard`` does not import."""
        if self._tb is _UNSET:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._tb = None
            else:
                self._tb = SummaryWriter(str(self._dir / "tb"))
        return self._tb

    def log(self, step: int, metrics: Mapping[str, Any]) -> None:
        # Strings (e.g. vgg_mode provenance) go to the JSONL record but
        # not to TensorBoard scalars.
        scalars = {k: float(v) for k, v in metrics.items() if not isinstance(v, str)}
        tags = {k: v for k, v in metrics.items() if isinstance(v, str)}
        line = json.dumps({"step": int(step), "time": time.time(), **scalars, **tags})
        print(line, flush=True)
        self._jsonl.write(line + "\n")
        self._jsonl.flush()
        tb = self._writer()
        if tb is not None:
            for k, v in scalars.items():
                tb.add_scalar(k, v, step)

    def log_images(self, step: int, images: Mapping[str, Any]) -> None:
        """Image grids [B, H, W, 3] in [0, 1] (recon, part overlays): PNGs
        under images/ in the run dir, and TensorBoard when available."""
        try:
            import cv2
        except ImportError:
            cv2 = None
        img_dir = self._dir / "images"
        img_dir.mkdir(exist_ok=True)
        tb = self._writer()
        for name, arr in images.items():
            a8 = (np.clip(np.asarray(arr), 0, 1) * 255).astype(np.uint8)
            if cv2 is not None:
                cv2.imwrite(str(img_dir / f"{name}_{step:07d}.png"), _to_grid(a8)[..., ::-1])
            if tb is not None:
                tb.add_images(name, a8[:4], step, dataformats="NHWC")

    def close(self):
        self._jsonl.close()
        if self._tb not in (None, _UNSET):
            self._tb.close()


def _to_grid(batch: np.ndarray) -> np.ndarray:
    """[B, H, W, C] uint8 → one row of at most 8 images."""
    return np.concatenate(list(batch[:8]), axis=1)
