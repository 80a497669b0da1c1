"""Process group and mesh, the port's counterpart of partseg_tpu/dist/mesh.py.

JAX runs one program over a mesh of devices; the port runs one process
per rank (``torchrun``), each on its own device. A ``Mesh`` lays the
ranks out as a (data, space) grid, space fastest, as JAX's
``make_spatial_mesh`` reshapes its devices: rank = data_index · space +
space_index. Each data row (the ranks that split one data shard's image
rows) has a space group, and each space column a data group.

The JAX module's placement helpers (``batch_sharding``, ``shard_batch``,
``replicated_sharding``) have no counterpart: each rank holds its own
shard of the batch and its own copy of the parameters, which
``broadcast_parameters`` makes identical. Collectives are explicit:
``average`` all-reduces a list of tensors in one flat buffer.

World size 1 needs no process group: every collective here is then the
identity, and the train step runs exactly as it does without a mesh.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


def init_distributed(coordinator: str | None = None, backend: str = "gloo",
                     device: torch.device | None = None) -> bool:
    """Join the process group when there are several processes: torchrun's
    environment (``RANK``, ``WORLD_SIZE``; ``env://`` at ``MASTER_ADDR``) or
    an explicit ``coordinator`` (``host:port`` for ``tcp://``, or any init
    URL such as ``file://``), with the given ``backend`` ("nccl" or "gloo").
    No-op for a single process without a coordinator. Returns whether a
    process group is up."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and coordinator is None:
        return False
    rank = int(os.environ.get("RANK", "0"))
    if coordinator is None:
        init = "env://"
    else:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {}
    if backend == "nccl" and device is not None and device.type == "cuda":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world, **kw)
    return True


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


@dataclasses.dataclass
class Mesh:
    """The ranks as a (data, space) grid, and this rank's place in it.

    ``data_group`` averages the gradients of one space column over the
    data shards; ``space_group`` carries the halo exchanges and the
    reductions of one data shard's rows. Both are None at world size 1
    (no process group), where every collective is the identity."""

    world: int
    rank: int
    space: int
    data_group: object = None
    space_group: object = None

    @property
    def n_data(self) -> int:
        return self.world // self.space

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_spatial_mesh(space_shards: int) -> Mesh:
    """The (data, space) mesh over every rank of the process group, image
    rows sharded over ``space_shards`` ranks; raises, as JAX does, when
    the world size is not divisible by it. Every rank must call it (it
    creates the groups)."""
    world, rank = _world()
    if world % space_shards:
        raise ValueError(f"{world} devices not divisible by space_shards={space_shards}")
    if world == 1:
        return Mesh(1, 0, 1)
    n_data = world // space_shards
    data_group = space_group = None
    # new_group is collective: every rank creates every group, in one order.
    for s in range(space_shards):
        g = dist.new_group([d * space_shards + s for d in range(n_data)])
        if rank % space_shards == s:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * space_shards + s for s in range(space_shards)])
        if rank // space_shards == d:
            space_group = g
    return Mesh(world, rank, space_shards, data_group, space_group)


def make_mesh() -> Mesh:
    """The 1-D data-parallel mesh over every rank."""
    return make_spatial_mesh(1)


def group_size(group) -> int:
    """The number of ranks in ``group`` (1 for None without a process group)."""
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group`` (0 for None without a process group)."""
    if group is None and not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def average(tensors: list[torch.Tensor], group, divisor: int | None = None) -> list[torch.Tensor]:
    """Sum ``tensors`` over ``group`` in one all-reduce of a flat f32 buffer
    and divide by ``divisor`` (the group's size unless given). Returns new
    tensors of the inputs' shapes and dtypes; at a group size of 1 and no
    divisor, returns the inputs."""
    n = group_size(group)
    if n == 1 and divisor is None:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    if n > 1:
        dist.all_reduce(flat, group=group)
    flat.div_(n if divisor is None else divisor)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def broadcast_parameters(module: torch.nn.Module, src: int = 0) -> None:
    """Make ``module``'s parameters and buffers those of rank ``src`` (the
    JAX package's ``create_replicated``: every rank initialises from the
    same seed, and the broadcast guarantees the copies are identical)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)
