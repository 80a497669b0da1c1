"""The training loop, the port's counterpart of partseg_tpu/train/loop.py.

Orchestration only; the math lives in the step (``train/step.py``). It
restores the latest checkpoint on start and seeks the data stream to it,
runs the ``augment.warp_every`` period (and ``data_echo``, ``scan_groups``)
schedule, keys every sample's draws by its global id (``aug_id``), logs
metrics with the throughput and the hand kernels' launches per step
(``kernel.<name>.launches_per_step``, from the ``tracing`` counters), writes
checkpoints at group boundaries, can trace a window of steps with
``torch.profiler`` (``profile_steps``; the program's spans are on in it,
among them ``loop.fetch``, the loader's wait and the copy of each group of
batches), and can kill itself at a given step to test resume.

Several processes (``torchrun``, or the CLI's ``--coordinator``) train
one model on a (data, space) mesh (``dist/mesh.py``), one rank per
process and device. Each rank takes ``global_batch / n_data`` examples per
step from its data shard of the loader, keys their draws by their global
ids (the same under any sharding), and trains either data-parallel
(``space_shards`` = 1: gradients averaged over the data ranks) or with
its data shard's image rows split over ``space_shards`` ranks
(``parallel/spatial_train.py``). Only rank 0 writes metrics, image grids
and checkpoints; every rank restores the same checkpoint.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from partseg_tpu_torch import tracing
from partseg_tpu_torch.data import build_dataset, make_loader, prefetch
from partseg_tpu_torch.device import default_device
from partseg_tpu_torch.dist.mesh import Mesh, broadcast_parameters, make_spatial_mesh
from partseg_tpu_torch.models.partnet import PartNet, init_weights
from partseg_tpu_torch.train.checkpoint import CheckpointManager
from partseg_tpu_torch.train.config import TrainConfig
from partseg_tpu_torch.train.metrics import MetricLogger
from partseg_tpu_torch.train.state import TrainState, create_state
from partseg_tpu_torch.train.step import (
    build_perceptual,
    compose_scan,
    make_train_period,
    make_train_step,
)


def build_step_fn(cfg: TrainConfig, model: PartNet, sampler, perceptual,
                  mesh: Mesh | None = None):
    """fn(state, batches, seed) → (state, metrics) for one dispatch of the
    loop: a period of ``augment.warp_every`` sub-steps (a tuple of as many
    batches; sub-step 0 warps), or with ``scan_groups > 1`` a list of that
    many such tuples, each applied ``data_echo`` times (compose_scan).
    On a mesh with a space axis it is the spatially sharded step; on one of
    several data ranks, the data-parallel step; else the plain step."""
    mesh = mesh or Mesh(1, 0, 1)
    if mesh.space > 1:
        from partseg_tpu_torch.parallel.spatial_train import build_spatial_step_fn

        body = build_spatial_step_fn(cfg, model, sampler, perceptual, mesh)
    elif cfg.augment.warp_every <= 1:
        step = make_train_step(cfg, model, sampler, perceptual, warp_on=True,
                               group=mesh.data_group)

        def body(state, batches, seed):
            return step(state, batches[0], seed)
    else:
        body = make_train_period(cfg, model, sampler, perceptual, group=mesh.data_group)
    if cfg.scan_groups > 1:
        return compose_scan(body, cfg.scan_groups, cfg.data_echo)
    return body


def _check_schedule(cfg: TrainConfig, start_step: int, period: int) -> tuple[int, int]:
    """(group, stride) of the schedule: the steps of one fetch group and of
    one dispatch; after the JAX loop's checks that steps, checkpoints and a
    resumed step align to it."""
    echo, scan = cfg.data_echo, cfg.scan_groups
    if echo < 1:
        raise ValueError(f"data_echo must be >= 1, got {echo}")
    group = period * echo
    span = group * scan                 # optimizer steps per dispatch
    if scan > 1:
        if cfg.fault_injection_step is not None:
            raise ValueError(
                "fault_injection_step targets a single sub-step; it is "
                "not supported with scan_groups>1 (a dispatch is "
                f"{span} steps)"
            )
        if start_step % span or (cfg.steps - start_step) % span:
            raise ValueError(
                f"steps {start_step}..{cfg.steps} must align to "
                f"warp_every*data_echo*scan_groups={span} (one scan "
                "dispatch is indivisible)"
            )
        if cfg.ckpt_every % span:
            raise ValueError(
                f"ckpt_every={cfg.ckpt_every} must be a multiple of "
                f"warp_every*data_echo*scan_groups={span}: checkpoints "
                "only land on dispatch boundaries"
            )
    if group > 1:
        if start_step % group:
            raise ValueError(
                f"restored step {start_step} is not aligned to "
                f"augment.warp_every*data_echo={group}; scheduled runs "
                "only checkpoint at group boundaries — this checkpoint "
                "came from a different schedule"
            )
        if (cfg.steps - start_step) % group:
            raise ValueError(
                f"steps={cfg.steps} must be a multiple of "
                f"augment.warp_every*data_echo={group} (the schedule "
                "period runs as one unit; echo re-dispatches it)"
            )
        if cfg.ckpt_every % group:
            raise ValueError(
                f"ckpt_every={cfg.ckpt_every} must be a multiple of "
                f"augment.warp_every*data_echo={group}: checkpoints only "
                "land on group boundaries, so any other cadence would "
                f"silently stretch to lcm({group}, {cfg.ckpt_every})"
            )
    return group, (period if scan == 1 else span)


def aug_ids(per_rank: int, data_index: int, fetch_step: int, sub: int,
            global_batch: int) -> np.ndarray:
    """The global sample ids of a rank's batch: its data shard's slot in the
    global batch of sub-step ``sub`` of the fetch group at ``fetch_step``."""
    return (np.arange(per_rank, dtype=np.int64) + data_index * per_rank
            + (fetch_step + sub) * global_batch)


def train(cfg: TrainConfig, *, data_iter: Iterator[dict] | None = None, restore: bool = True,
          device: str | torch.device | None = None, debug_nans: bool = False,
          mesh: Mesh | None = None) -> TrainState:
    """Run training on ``device`` (the CUDA card unless given). Returns the
    final TrainState. ``data_iter`` replaces the config's dataset (the
    caller then owns the resume seek and the rank's shard); ``debug_nans``
    turns on autograd's anomaly detection and fails on a non-finite loss.
    ``mesh`` defaults to every rank of the process group (one rank without
    one) with ``space_shards`` ranks to a data shard's rows."""
    dev = default_device(device)
    if mesh is None:
        mesh = make_spatial_mesh(cfg.space_shards)
    if cfg.global_batch % mesh.n_data:
        raise ValueError(
            f"global_batch {cfg.global_batch} not divisible by {mesh.n_data} data shards")
    batch = cfg.global_batch // mesh.n_data      # this rank's share of a step
    lead = mesh.rank == 0                         # the one writer
    model = init_weights(PartNet(cfg.model, device="cpu"), seed=cfg.seed).to(dev)
    broadcast_parameters(model)
    sampler = cfg.augment.make_sampler()
    perceptual = build_perceptual(cfg, dev)
    print(f"[train] vgg_mode={perceptual.vgg_mode}", flush=True)
    state = create_state(cfg, model)

    ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep, save_every=cfg.ckpt_every)
    start_step = 0
    if restore:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state, start_step = restored
            print(f"[train] restored checkpoint at step {start_step}", flush=True)

    period = max(cfg.augment.warp_every, 1)
    group, stride = _check_schedule(cfg, start_step, period)
    table = None
    if cfg.device_data:
        if mesh.space > 1:
            raise ValueError(
                "device_data is not supported with spatial sharding: the "
                "image must enter the step already row-sharded, but the "
                "device table gather produces full-height rows per shard"
            )
        if data_iter is not None:
            raise ValueError(
                "device_data builds its own index-carrying loader; pass "
                "data_iter=None"
            )
        if cfg.loader_backend != "grain":
            raise ValueError(
                "device_data requires loader_backend='grain' (the native "
                "decode pool has no per-example index plumbing)"
            )
    if data_iter is None:
        dataset = build_dataset(cfg.dataset, split="train", **dict(cfg.dataset_kwargs))
        if cfg.device_data:
            table = _device_dataset_table(dataset, dev, u8=cfg.device_data_u8)
            dataset = _IndexDataset(len(dataset))
        # One batch per data_echo steps: seeking to start_step // data_echo
        # reproduces the uninterrupted batch sequence (start_step is
        # group-aligned, checked above).
        # The rank's data shard of the examples (every space rank of a data
        # shard reads the same batches).
        data_iter = prefetch(make_loader(
            dataset, batch, seed=cfg.seed, num_workers=4, backend=cfg.loader_backend,
            start_batch=start_step // cfg.data_echo, process_index=mesh.data_index,
            process_count=mesh.n_data))

    step_fn = build_step_fn(cfg, model, sampler, perceptual, mesh)
    seed = cfg.seed + 1                 # the augmentation's key, apart from the init's
    pin = dev.type == "cuda"
    rows = slice(None)
    if mesh.space > 1:
        h = cfg.model.img_size // mesh.space
        rows = slice(mesh.space_index * h, (mesh.space_index + 1) * h)

    def fetch(fetch_step: int, sub: int) -> dict:
        """The next host batch, with the global ids of its samples."""
        hb = dict(next(data_iter))
        hb["aug_id"] = aug_ids(batch, mesh.data_index, fetch_step, sub, cfg.global_batch)
        return hb

    def to_device(hb: dict) -> dict:
        """A host batch on the device: pinned memory, copied asynchronously;
        with device_data, the images gathered from the device table; with
        spatial sharding, the rank's rows only (the full images stay on the
        host for the image grids). The aug_ids stay on the host, where the
        step hashes its draws."""
        key = "index" if table is not None else "image"
        x = torch.from_numpy(np.ascontiguousarray(hb[key][:, rows] if mesh.space > 1
                                                  else hb[key]))
        x = x.pin_memory().to(dev, non_blocking=True) if pin else x
        image = table.index_select(0, x) if table is not None else x
        out = {"image": image, "aug_id": hb["aug_id"]}
        if mesh.space > 1:
            out["full"] = hb["image"]
        return out

    def viz_images(b: dict) -> torch.Tensor:
        return torch.from_numpy(np.asarray(b["full"])).to(dev) if "full" in b else b["image"]

    def save(step: int, force: bool = False) -> None:
        """Rank 0 writes; every rank passes the barrier after it."""
        if lead:
            ckpt.save(step, state, force=force)
        if mesh.world > 1:
            dist.barrier()

    logger = MetricLogger(cfg.ckpt_dir) if lead else None
    anomaly = torch.autograd.detect_anomaly() if debug_nans else contextlib.nullcontext()
    profiler = None
    t_last = time.perf_counter()
    imgs_since = 0
    launches_at = tracing.counters("kernel.")
    echoed = None
    with anomaly:
        for step in range(start_step, cfg.steps, stride):
            if lead and cfg.profile_steps and step <= cfg.profile_steps[0] < step + stride:
                profiler = _start_profile(dev)
            if cfg.scan_groups > 1:
                # One dispatch = scan_groups fetch groups, fetched group-major:
                # the same batches and aug_ids as that many dispatches.
                with tracing.span("loop.fetch"):
                    groups = [tuple(to_device(fetch(step + g * group, j)) for j in range(period))
                              for g in range(cfg.scan_groups)]
                viz = groups[0][0]
                state, metrics = step_fn(state, groups, seed)
            else:
                # data_echo: a fresh group of batches once per data_echo
                # dispatches, the same device batches in between (their
                # draws still differ: they are keyed by the step).
                if step % group == 0 or echoed is None:
                    with tracing.span("loop.fetch"):
                        echoed = tuple(to_device(fetch(step, j)) for j in range(period))
                viz = echoed[0]
                state, metrics = step_fn(state, echoed, seed)
            imgs_since += cfg.global_batch * stride

            if profiler is not None and step <= cfg.profile_steps[1] < step + stride:
                _stop_profile(profiler, dev, os.path.join(cfg.ckpt_dir, "profile"), step)
                profiler = None
            if debug_nans and not torch.isfinite(metrics["loss"]):
                raise FloatingPointError(f"non-finite loss at step {step}: {metrics['loss']}")

            if step % cfg.log_every < stride or step + stride >= cfg.steps:
                # The metrics are the mean over the data shards, the same on
                # every rank; the throughput is per rank (per card).
                m = {k: v.item() for k, v in metrics.items()}
                now = time.perf_counter()
                dt = now - t_last
                m["img_per_sec_per_chip"] = imgs_since / dt / mesh.world if dt > 0 else 0.0
                launched = tracing.counters("kernel.")
                steps_since = imgs_since // cfg.global_batch
                for k, v in launched.items():
                    m[f"{k}_per_step"] = (v - launches_at.get(k, 0)) / steps_since
                launches_at = launched
                m["lr_step"] = step
                m["vgg_mode"] = perceptual.vgg_mode
                if lead:
                    logger.log(step, m)
                t_last = now
                imgs_since = 0

            if lead and cfg.image_log_every and step % cfg.image_log_every < stride:
                _log_images(logger, state.model, viz_images(viz), step)

            if (cfg.fault_injection_step is not None
                    and step <= cfg.fault_injection_step < step + stride):
                print(f"[train] FAULT INJECTION at step {step} — exiting hard", flush=True)
                ckpt.wait()
                os._exit(42)

            if (step + stride) % group == 0:
                # Checkpoints only at group boundaries, so that the resume
                # seek (start_batch = step // data_echo) stays exact.
                save(step + stride)

    if profiler is not None:
        _stop_profile(profiler, dev, os.path.join(cfg.ckpt_dir, "profile"), cfg.steps)
    if lead:
        ckpt.save(cfg.steps, state, force=True)
        ckpt.wait()
        logger.close()
    if mesh.world > 1:
        dist.barrier()
    return state


class _IndexDataset:
    """The examples of a device_data run: each example's own index, which
    the loader batches like any other field (so the shuffle, shard and
    seek arithmetic, and the batch sequence, are those of the dataset)."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> dict:
        return {"index": np.int64(idx)}


def _device_dataset_table(dataset, device: torch.device, limit_bytes: int = 8 << 30,
                          u8: bool = False) -> torch.Tensor:
    """The whole dataset's images as one device tensor [N, H, W, 3]
    (cfg.device_data), built once; each step then gathers its batch on the
    device by index. u8 (cfg.device_data_u8): stored as uint8, floats
    quantised round(x·255) (the representation a JPEG-decoding host loader
    ships, normalised by the step), for 4× the capacity of f32."""

    def prep(img):
        img = np.asarray(img)
        if u8 and img.dtype != np.uint8:
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        return img

    n = len(dataset)
    first = prep(dataset[0]["image"])
    nbytes = n * first.nbytes
    if nbytes > limit_bytes:
        raise ValueError(
            f"device_data: dataset images are {nbytes / 2**30:.1f} GiB "
            f"({n} examples x {first.nbytes / 2**20:.2f} MiB) — too large "
            "for a device-resident table; use the streaming loader"
            + ("" if u8 else " or device_data_u8=True (4x capacity)")
        )
    table = np.empty((n,) + first.shape, first.dtype)
    table[0] = first
    for i in range(1, n):
        table[i] = prep(dataset[i]["image"])
    return torch.from_numpy(table).to(device)


def _start_profile(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, device: torch.device, out_dir: str, step: int) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{step:07d}.json"))


def _log_images(logger: MetricLogger, model: PartNet, images: torch.Tensor, step: int) -> None:
    """Up to 8 inputs, their reconstructions and a part-map overlay."""
    x = images[:8]
    if x.dtype == torch.uint8:
        x = x.float() * (1.0 / 255.0)
    with torch.no_grad():
        out = model(x, x)
    heat = out.parts_a.float().cpu().numpy()                 # [n, h, w, K]
    palette = np.random.default_rng(0).uniform(0.2, 1.0, size=(heat.shape[-1], 3))
    overlay = np.einsum("bhwk,kc->bhwc", heat / (heat.max() + 1e-8), palette)
    logger.log_images(step, {
        "input": x.float().cpu().numpy(),
        "recon": out.recon.float().cpu().numpy(),
        "parts": np.clip(overlay / (overlay.max() + 1e-8), 0, 1),
    })
