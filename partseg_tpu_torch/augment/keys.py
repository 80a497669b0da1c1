"""Per-sample random draws keyed by (seed, step, sample id): a
counter-based hash, computed on the host in numpy.

The JAX package folds each sample's global id (``aug_id``) into the
step's key, so a sample's augmentation does not depend on which batch,
shard or device it lands in (partseg_tpu/train/step.py). The port keys
the same way: draw d of sample a at step s is a function of (seed, s, a,
d) alone. Nothing is drawn from a ``torch.Generator``, no device state is
kept between steps, and no kernel is launched: every draw of a batch is
hashed in one pass over a [B, count] array, and the caller sends the
result to the device in one copy. The same draws come out on every
device.

The hash is ``lowbias32`` (C. Wellons' 32-bit integer mixer) on uint32
arrays, whose products wrap mod 2³². The top 24 bits of its output give
uniforms in (0, 1); Box-Muller turns each pair of uniforms into a pair
of normals (its cosine and sine branches), in float64.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_GOLDEN = np.uint32(0x9E3779B9)


def mix32(x: np.ndarray) -> np.ndarray:
    """lowbias32 on a uint32 array (at least one dimension, so that the
    products wrap without numpy's scalar overflow warning)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def sample_keys(seed: int, step: int, aug_id) -> np.ndarray:
    """The key of each sample [B] (uint32) at this step; ``aug_id`` [B]
    are host integers."""
    k = mix32(mix32(np.array([seed & _M32], np.uint32)) + _GOLDEN)
    k = mix32(k ^ np.uint32(step & _M32))
    ids = (np.asarray(aug_id, np.int64).reshape(-1) & _M32).astype(np.uint32)
    return mix32(ids ^ k)


def uniforms(keys: np.ndarray, count: int) -> np.ndarray:
    """[B, count] float64 uniforms in (0, 1): draws 0..count−1 of each
    sample key."""
    ctr = mix32(np.arange(count, dtype=np.uint32) * _GOLDEN)
    bits = mix32(mix32(keys[:, None] ^ ctr[None, :]))
    return ((bits >> np.uint32(8)).astype(np.float64) + 0.5) * (1.0 / (1 << 24))


def box_muller(u: np.ndarray) -> np.ndarray:
    """[B, 2m] uniforms in (0, 1) → [B, 2m] standard normals, float64."""
    m = u.shape[-1] // 2
    r = np.sqrt(-2.0 * np.log(u[:, :m]))
    theta = (2 * np.pi) * u[:, m:2 * m]
    return np.concatenate([r * np.cos(theta), r * np.sin(theta)], axis=-1)
