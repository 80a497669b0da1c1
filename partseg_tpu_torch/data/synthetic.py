"""The port's copy of partseg_tpu/data/synthetic.py (numpy and ctypes, no JAX).

Synthetic blob dataset (SURVEY.md §4.4): colored Gaussians on
textured backgrounds, with ground-truth blob centers as landmarks.

Needs no downloads; used by the integration smoke test (equivariance
loss must fall and μ must land on the blobs) and by the landmark-
regression eval protocol test. Deterministic per index.

Each example: `n_blobs` Gaussian blobs whose centers are a fixed base
constellation (a "face") plus small per-example jitter + a global
similarity transform — so there IS consistent structure for the model
to discover, like a dataset of aligned-ish objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticBlobs:
    size: int = 128
    n_blobs: int = 5
    n_examples: int = 10_000
    seed: int = 0
    with_masks: bool = False   # also emit part-label maps (seg-IoU eval)

    def __post_init__(self):
        # The constellation/colors/radii define the object CLASS and are
        # deliberately independent of `seed`: train/val/test splits (seeded
        # differently) must sample the SAME class, else eval regressors
        # cannot transfer across splits. `seed` only varies the examples.
        rng = np.random.default_rng(1234 + self.n_blobs)
        self._base = rng.uniform(-0.45, 0.45, size=(self.n_blobs, 2))
        self._colors = rng.uniform(0.3, 1.0, size=(self.n_blobs, 3))
        self._radii = rng.uniform(0.06, 0.14, size=(self.n_blobs,))
        # Examples are deterministic per index, so repeated epochs can
        # serve from memory: rendering an example costs ~20 ms of host
        # numpy, and a 1-core host otherwise caps training at ~45 img/s
        # (r3 quality-study finding). Bit-identical to uncached access.
        self._cache: dict[int, dict] = {}

    def __len__(self) -> int:
        return self.n_examples

    def __getitem__(self, idx: int) -> dict:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        out = self._render(int(idx))
        if len(self._cache) < 4096:        # ~1 GB cap at 128px
            self._cache[idx] = out
        return out

    def _render(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        s = self.size
        lin = np.linspace(-1.0, 1.0, s, dtype=np.float32)
        yy, xx = np.meshgrid(lin, lin, indexing="ij")

        # Per-example global similarity + per-blob jitter.
        scale = np.exp(rng.normal(0, 0.08))
        theta = rng.normal(0, 0.15)
        trans = rng.normal(0, 0.12, size=2)
        rot = np.array(
            [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
        )
        centers = (self._base + rng.normal(0, 0.02, size=self._base.shape)) @ (
            scale * rot
        ).T + trans                                             # [n, 2] (y, x)

        # Smooth random background texture.
        bg = rng.uniform(0.0, 0.25, size=(4, 4, 3)).astype(np.float32)
        img = _upsample_bilinear(bg, s)
        hue = rng.uniform(0.6, 1.0, size=3).astype(np.float32)
        img = img * hue

        color_jitter = rng.uniform(0.7, 1.3, size=(1, 3))
        blobs = np.zeros((self.n_blobs, s, s), np.float32)
        for i in range(self.n_blobs):
            d2 = (yy - centers[i, 0]) ** 2 + (xx - centers[i, 1]) ** 2
            blobs[i] = np.exp(-d2 / (2 * (self._radii[i] * scale) ** 2))
            col = np.clip(self._colors[i] * color_jitter[0], 0, 1)
            img = img * (1 - blobs[i][..., None]) + blobs[i][..., None] * col

        out = {
            "image": np.clip(img, 0.0, 1.0).astype(np.float32),
            "landmarks": centers.astype(np.float32),            # (y, x) in [-1,1]
        }
        if self.with_masks:
            # Ground-truth part segmentation: strongest blob where any
            # blob dominates the background (label 0 = background).
            strength = blobs.max(axis=0)
            label = blobs.argmax(axis=0) + 1
            out["mask"] = np.where(strength > 0.5, label, 0).astype(np.int32)
        return out


def _upsample_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """Tiny host-side bilinear upsample for the background texture."""
    h, w, c = img.shape
    ys = np.linspace(0, h - 1, size)
    xs = np.linspace(0, w - 1, size)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)
