"""The port's copy of partseg_tpu/data/native.py (numpy and ctypes, no JAX).

ctypes bindings + batched iterator over the native C++ decode pool.

The pool (partseg_native/loader.cc) does JPEG/PNG decode + square crop
+ bilinear resize across N threads with a bounded queue — the
TPU-native stand-in for torch's C++ DataLoader workers (SURVEY.md
§2.2). The .so is built on demand with g++ (no pip/pybind11 in this
image).

Use via make_loader(..., backend="native") in partseg_tpu_torch.data.loader,
or directly:

    with NativePool(out_size=128) as pool:
        batch = pool.load_batch(paths, bboxes)
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Iterator, Sequence

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent / "partseg_native"
_SO = _ROOT / "libpartseg_native.so"
_LOCK = threading.Lock()
_LIB = None


def _load_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        src = _ROOT / "loader.cc"
        stale = _SO.exists() and src.exists() and (
            src.stat().st_mtime > _SO.stat().st_mtime
        )
        if not _SO.exists() or stale:
            subprocess.run(["sh", str(_ROOT / "build.sh")], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(str(_SO))
        lib.psn_create.restype = ctypes.c_void_p
        lib.psn_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.psn_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.psn_get.restype = ctypes.c_int
        lib.psn_get.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.psn_get_u8.restype = ctypes.c_int
        lib.psn_get_u8.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.psn_pending.restype = ctypes.c_int
        lib.psn_pending.argtypes = [ctypes.c_void_p]
        lib.psn_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class NativePool:
    """Thin RAII wrapper over the C pool."""

    def __init__(self, out_size: int, n_threads: int = 8, capacity: int = 128,
                 scaled_decode: bool | None = None):
        # scaled_decode: JPEGs are decoded at the smallest N/8 DCT scale
        # that keeps the crop >= out_size (libjpeg-turbo IDCT scaling) —
        # ~(N/8)² of the pixel work on large frames, downsample-only so
        # quality is bilinear-class or better. Default ON; opt out with
        # PARTSEG_SCALED_DECODE=0 (e.g. to A/B against full decode).
        if scaled_decode is None:
            scaled_decode = os.environ.get("PARTSEG_SCALED_DECODE", "1") != "0"
        self._lib = _load_lib()
        self._h = self._lib.psn_create(
            n_threads, out_size, capacity, int(scaled_decode)
        )
        self.out_size = out_size

    def submit(self, idx: int, path: str, bbox=None) -> None:
        """bbox: (x, y, w, h) in source pixels or None for center crop."""
        if bbox is None:
            cx = cy = side = -1.0
        else:
            x, y, w, h = bbox
            cx, cy = x + w / 2.0, y + h / 2.0
            side = max(w, h)
        self._lib.psn_submit(
            self._h, idx, str(path).encode(), cx, cy, side
        )

    def get(self, dtype: str = "f32") -> tuple[int, np.ndarray | None]:
        """Blocking: returns (idx, [S,S,3] image) or (idx, None) on
        decode failure. dtype "f32" → [0,1] floats; "u8" → raw uint8
        (the 4×-smaller host→device training path)."""
        idx = ctypes.c_int64()
        if dtype == "u8":
            buf = np.empty((self.out_size, self.out_size, 3), np.uint8)
            rc = self._lib.psn_get_u8(
                self._h, ctypes.byref(idx),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
        else:
            buf = np.empty((self.out_size, self.out_size, 3), np.float32)
            rc = self._lib.psn_get(
                self._h, ctypes.byref(idx),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
        if rc < 0:
            raise RuntimeError("native pool shut down")
        return int(idx.value), (buf if rc == 1 else None)

    def load_batch(
        self, paths: Sequence, bboxes: Sequence | None = None,
        dtype: str = "f32",
    ) -> np.ndarray:
        """Decode a batch in parallel, order-preserving; failed decodes
        come back as zeros."""
        n = len(paths)
        for i, p in enumerate(paths):
            self.submit(i, p, bboxes[i] if bboxes is not None else None)
        np_dtype = np.uint8 if dtype == "u8" else np.float32
        out = np.zeros((n, self.out_size, self.out_size, 3), np_dtype)
        for _ in range(n):
            idx, img = self.get(dtype)
            if img is not None:
                out[idx] = img
        return out

    def close(self):
        if self._h:
            self._lib.psn_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_loader(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    num_threads: int = 8,
    process_index: int = 0,
    process_count: int = 1,
    start_batch: int = 0,
    out_dtype: str = "u8",
) -> Iterator[dict]:
    """Infinite batched iterator over an ImageListDataset using the
    native pool (images only; landmark-annotated eval splits should use
    the indexable path of loader.make_loader).

    The batches are those of loader.batch_indices, as for every backend:
    cut from the continuous repeated stream of per-epoch permutations, so
    `start_batch` seeks without decoding and the resumed sequence exactly
    matches an uninterrupted run.

    out_dtype defaults to "u8": the train step normalizes uint8 batches
    on-device, so the host→device transfer is 4× smaller than f32."""
    from partseg_tpu_torch.data.loader import batch_indices

    paths = list(dataset.paths)
    bboxes = list(dataset.bboxes) if getattr(dataset, "bboxes", None) else None
    pool = NativePool(dataset.size, n_threads=num_threads,
                      capacity=2 * batch_size)
    for sel in batch_indices(len(paths), batch_size, shuffle=shuffle, seed=seed,
                             process_index=process_index,
                             process_count=process_count, start_batch=start_batch):
        yield {
            "image": pool.load_batch(
                [paths[i] for i in sel],
                [bboxes[i] for i in sel] if bboxes else None,
                dtype=out_dtype,
            )
        }
