"""Spatial sharding (image rows over a space group of ranks), the port's
counterpart of partseg_tpu/parallel."""

from partseg_tpu_torch.parallel.spatial import (
    group_sum,
    halo_exchange,
    sharded_pool_appearance,
    sharded_render_gaussians,
    sharded_soft_argmax_moments,
    sharded_spatial_conv,
    sharded_spatial_softmax,
)

__all__ = [
    "group_sum",
    "halo_exchange",
    "sharded_pool_appearance",
    "sharded_render_gaussians",
    "sharded_soft_argmax_moments",
    "sharded_spatial_conv",
    "sharded_spatial_softmax",
]
