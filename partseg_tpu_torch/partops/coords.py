"""Coordinate grids and moment bases.

Convention (the same as partseg_tpu's, used everywhere in the port):
  * tensors at public functions are NHWC;
  * a pixel location is ``u = (y, x)`` in normalized coordinates, with
    ``y, x ∈ [-1, 1]`` at the pixel *centers* of rows/columns 0..H-1 /
    0..W-1 via ``y = -1 + 2*(i + 0.5)/H`` (``align_corners=False``).

The grids are computed in numpy float32 with the same expression as the
JAX package, so both frameworks see bit-identical coordinates; the CUDA
kernels evaluate the same float32 expression per pixel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _coord_grid_np(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    ys = -1.0 + (2.0 * (np.arange(h, dtype=np.float32) + 0.5)) / h
    xs = -1.0 + (2.0 * (np.arange(w, dtype=np.float32) + 0.5)) / w
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return yy, xx


@functools.lru_cache(maxsize=32)
def _moment_basis_np(h: int, w: int) -> np.ndarray:
    yy, xx = _coord_grid_np(h, w)
    y = yy.reshape(-1)
    x = xx.reshape(-1)
    return np.stack([y, x, y * y, y * x, x * x], axis=-1)  # [H*W, 5]


def coord_grid(h: int, w: int, device=None):
    """Return (yy, xx), each [H, W] f32, normalized pixel-center coords in [-1, 1]."""
    yy, xx = _coord_grid_np(h, w)
    return torch.tensor(yy, device=device), torch.tensor(xx, device=device)


def moment_basis(h: int, w: int, device=None) -> torch.Tensor:
    """[H*W, 5] f32 basis of (y, x, y², yx, x²) monomials at the pixel centers.

    ``p_flat @ moment_basis`` gives the raw moments E[y], E[x], E[y²],
    E[yx], E[x²] of a spatial distribution p.
    """
    return torch.tensor(_moment_basis_np(h, w), device=device)
