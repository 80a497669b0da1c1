"""The port's copy of partseg_tpu/data/registry.py (numpy and ctypes, no JAX).

Dataset registry: name → constructor (SURVEY.md §2.1 dataset matrix).

Real-image datasets (CelebA, CUB, DeepFashion, Human3.6M, Penn Action)
need their files on disk under $PARTSEG_DATA (no network in this
environment); the synthetic dataset always works.
"""

from __future__ import annotations

import os
from typing import Any, Callable

_REGISTRY: dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def build_dataset(name: str, split: str = "train", **kwargs) -> Any:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown dataset {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](split=split, **kwargs)


def data_root() -> str:
    return os.environ.get("PARTSEG_DATA", os.path.expanduser("~/partseg_data"))


@register("synthetic")
def _synthetic(split: str = "train", **kw):
    from partseg_tpu_torch.data.synthetic import SyntheticBlobs

    seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
    kw.setdefault("n_examples", 10_000 if split == "train" else 1_000)
    return SyntheticBlobs(seed=seed, **kw)
