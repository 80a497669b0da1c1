"""CUDA kernel wrappers for the JAX package's Pallas kernels. Each
wrapper validates its inputs, runs the plain PyTorch version on a CPU
tensor, and launches its hand-written kernel (built from ``csrc/`` at
first use) on a CUDA tensor, counting forward launches in the registry
counter ``kernel.<name>.launches`` (``partseg_tpu_torch.tracing``; and
render_assemble its backward kernel's in
``kernel.render_assemble.backward_launches``). Each is an autograd
Function."""

from partseg_tpu_torch.partops.kernels.bilinear_sample import (
    bilinear_sample_fused,
    bilinear_sample_plain,
)
from partseg_tpu_torch.partops.kernels.render_assemble import (
    render_assemble,
    render_assemble_backward,
    render_assemble_plain,
    render_assemble_vjp,
)
from partseg_tpu_torch.partops.kernels.softmax_moments import (
    softmax_moments,
    softmax_moments_plain,
)
from partseg_tpu_torch.partops.kernels.tps_warp import tps_warp, tps_warp_plain

__all__ = [
    "softmax_moments",
    "softmax_moments_plain",
    "render_assemble",
    "render_assemble_plain",
    "render_assemble_backward",
    "render_assemble_vjp",
    "tps_warp",
    "tps_warp_plain",
    "bilinear_sample_fused",
    "bilinear_sample_plain",
]
