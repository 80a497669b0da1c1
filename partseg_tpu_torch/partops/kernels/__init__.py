"""CUDA kernel wrappers for the JAX package's Pallas kernels on the
serving path. Each wrapper validates its inputs, runs the plain PyTorch
version on a CPU tensor, and launches its hand-written kernel (built
from ``csrc/`` at first use) on a CUDA tensor, counting launches in its
``launches`` attribute."""

from partseg_tpu_torch.partops.kernels.render_assemble import (
    render_assemble,
    render_assemble_plain,
)
from partseg_tpu_torch.partops.kernels.softmax_moments import (
    softmax_moments,
    softmax_moments_plain,
)

KERNELS = (softmax_moments, render_assemble)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "softmax_moments",
    "softmax_moments_plain",
    "render_assemble",
    "render_assemble_plain",
    "KERNELS",
    "reset_launch_counts",
]
