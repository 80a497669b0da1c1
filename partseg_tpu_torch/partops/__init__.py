"""Part ops: plain PyTorch versions (this package) and the CUDA kernel
wrappers (``partops.kernels``) that replace the JAX package's Pallas
kernels. Every op takes and returns NHWC tensors."""

from partseg_tpu_torch.partops.assembly import assemble_decoder_input
from partseg_tpu_torch.partops.coords import coord_grid, moment_basis
from partseg_tpu_torch.partops.moments import (
    chol2x2,
    moments_from_raw,
    precision_from_cov,
    soft_argmax_moments,
)
from partseg_tpu_torch.partops.pooling import pool_appearance
from partseg_tpu_torch.partops.render import render_gaussians
from partseg_tpu_torch.partops.softmax import normalize_maps, part_softmax, spatial_softmax

__all__ = [
    "coord_grid",
    "moment_basis",
    "part_softmax",
    "spatial_softmax",
    "normalize_maps",
    "soft_argmax_moments",
    "moments_from_raw",
    "precision_from_cov",
    "chol2x2",
    "render_gaussians",
    "pool_appearance",
    "assemble_decoder_input",
]
