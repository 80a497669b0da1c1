"""Unsupervised landmark evaluation (Thewlis'17 linear-regression
protocol), the port's twin of partseg_tpu/evals/landmarks.py:

  1. μ_i ∈ R^{2K} from batched forwards over an annotated split, on the
     model's device;
  2. a linear regressor (no intercept, per the protocol) fit μ → ground
     truth on the train split;
  3. test error = mean ‖ŷ − y‖₂ / inter-ocular distance, in %.

For datasets without eye landmarks (CUB etc.) the normaliser is
configurable (e.g. the bbox diagonal): pass ``iod_fn``. Everything after
the forward is numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from partseg_tpu_torch.evals.export import as_images, model_device
from partseg_tpu_torch.models.partnet import PartNet


def pad_batch(x: np.ndarray, pad_to: int) -> np.ndarray:
    """Pad a short remainder batch to ``pad_to`` rows by repeating the last
    example, so every forward of a split has one shape. Callers slice the
    outputs back to the true length."""
    n = x.shape[0]
    if n >= pad_to:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad_to - n, axis=0)])


def collect_mu(
    model: PartNet,
    data_iter: Iterator[dict],
    max_batches: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Run the shape stream over a split; returns (mu [N, K, 2], gt [N, L, 2]).

    Remainder batches (from drop_remainder=False loaders) are padded to
    the first batch's size and trimmed after the forward, so the whole
    split is scored at one shape.
    """
    device = model_device(model)
    mus, gts = [], []
    pad_to = None
    with torch.inference_mode():
        for i, batch in enumerate(data_iter):
            if max_batches is not None and i >= max_batches:
                break
            img = np.asarray(batch["image"])
            n = img.shape[0]
            pad_to = pad_to or n
            logits = model.encode_shape(as_images(pad_batch(img, pad_to), device))
            _, mu, _ = model.shape_stats(logits)
            mus.append(mu[:n].cpu().numpy())
            gts.append(np.asarray(batch["landmarks"]))
    return np.concatenate(mus), np.concatenate(gts)


def fit_landmark_regressor(mu_train: np.ndarray, gt_train: np.ndarray) -> np.ndarray:
    """Least-squares W: [2K → 2L], no intercept (Thewlis'17 variant).

    Returns W [2K, 2L] minimizing ‖mu·W − gt‖².
    """
    n = mu_train.shape[0]
    X = mu_train.reshape(n, -1).astype(np.float64)
    Y = gt_train.reshape(n, -1).astype(np.float64)
    W, *_ = np.linalg.lstsq(X, Y, rcond=None)
    return W


def landmark_error(
    W: np.ndarray,
    mu_test: np.ndarray,
    gt_test: np.ndarray,
    iod_fn: Callable[[np.ndarray], np.ndarray] | None = None,
) -> float:
    """Mean landmark error as % of inter-ocular distance.

    iod_fn maps gt [N, L, 2] → normalizer [N]; default assumes the
    CelebA/MAFL 5-landmark layout with the eyes at indices 0, 1.
    """
    n, l, _ = gt_test.shape
    pred = (mu_test.reshape(n, -1) @ W).reshape(n, l, 2)
    if iod_fn is None:
        iod = np.linalg.norm(gt_test[:, 0] - gt_test[:, 1], axis=-1)
    else:
        iod = iod_fn(gt_test)
    err = np.linalg.norm(pred - gt_test, axis=-1).mean(axis=-1)    # [N]
    return float(np.mean(err / np.maximum(iod, 1e-8)) * 100.0)


def evaluate_landmarks(
    model: PartNet,
    train_iter: Iterator[dict],
    test_iter: Iterator[dict],
    iod_fn: Callable | None = None,
    max_batches: int | None = None,
) -> dict[str, float]:
    """The whole protocol. Returns {"landmark_error_pct_iod", "n_train", "n_test"}."""
    mu_tr, gt_tr = collect_mu(model, train_iter, max_batches)
    mu_te, gt_te = collect_mu(model, test_iter, max_batches)
    W = fit_landmark_regressor(mu_tr, gt_tr)
    return {
        "landmark_error_pct_iod": landmark_error(W, mu_te, gt_te, iod_fn),
        "n_train": float(len(mu_tr)),
        "n_test": float(len(mu_te)),
    }
