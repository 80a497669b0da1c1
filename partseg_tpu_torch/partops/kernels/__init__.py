"""CUDA kernel wrappers for the JAX package's Pallas kernels. Each
wrapper validates its inputs, runs the plain PyTorch version on a CPU
tensor, and launches its hand-written kernel (built from ``csrc/`` at
first use) on a CUDA tensor, counting forward launches in the registry
counter ``kernel.<name>.launches`` (``partseg_tpu_torch.tracing``; and
render_assemble, group_norm and bias_act their backward kernels' in
``kernel.<name>.backward_launches``). Each is differentiable: a registered
op with its autograd (softmax_moments, group_norm, bias_act) or an
autograd Function. bias_act replaces no Pallas kernel either: it is a
convolution's bias epilogue."""

from partseg_tpu_torch.partops.kernels.bias_act import bias_act, bias_act_plain
from partseg_tpu_torch.partops.kernels.bilinear_sample import (
    bilinear_sample_fused,
    bilinear_sample_plain,
)
from partseg_tpu_torch.partops.kernels.group_norm import group_norm, group_norm_plain
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
    "group_norm",
    "group_norm_plain",
    "bias_act",
    "bias_act_plain",
]
