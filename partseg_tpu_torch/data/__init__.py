"""Data pipelines, the port's copy of partseg_tpu/data (numpy, ctypes and
threads; no JAX, no grain).

One interface for all datasets: a dataset yields dict examples {"image":
[H, W, 3] float32 in [0, 1], optional "landmarks": [L, 2] normalized
(y, x)}; ``make_loader`` wraps it into per-process-sharded batches.
"""

from partseg_tpu_torch.data.loader import make_loader, prefetch
from partseg_tpu_torch.data.registry import build_dataset
from partseg_tpu_torch.data.synthetic import SyntheticBlobs

# Import dataset modules for their @register side effects.
from partseg_tpu_torch.data import celeba as _celeba    # noqa: F401
from partseg_tpu_torch.data import cub as _cub          # noqa: F401
from partseg_tpu_torch.data import deepfashion as _df   # noqa: F401
from partseg_tpu_torch.data import video as _video      # noqa: F401

__all__ = ["SyntheticBlobs", "build_dataset", "make_loader", "prefetch"]
