"""Device choice: the port runs on the CUDA card unless asked for the CPU."""

from __future__ import annotations

import torch


def default_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point builds on.

    ``None`` means the CUDA card, and raises if there is none: there is
    no silent CPU fallback. Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU (the tests do).
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "partseg_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return torch.device("cuda")
