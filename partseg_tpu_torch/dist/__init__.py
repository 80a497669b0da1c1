"""Multi-process training: the process group, the (data, space) mesh and
the explicit collectives, the port's counterpart of partseg_tpu/dist."""

from partseg_tpu_torch.dist.mesh import (
    Mesh,
    average,
    broadcast_parameters,
    group_rank,
    group_size,
    init_distributed,
    local_rank,
    make_mesh,
    make_spatial_mesh,
)

__all__ = [
    "Mesh",
    "average",
    "broadcast_parameters",
    "group_rank",
    "group_size",
    "init_distributed",
    "local_rank",
    "make_mesh",
    "make_spatial_mesh",
]
