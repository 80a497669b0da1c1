"""The training loop, the port's counterpart of partseg_tpu/train/loop.py.

Orchestration only; the math lives in the step (``train/step.py``). It
restores the latest checkpoint on start and seeks the data stream to it,
runs the ``augment.warp_every`` period (and ``data_echo``, ``scan_groups``)
schedule, keys every sample's draws by its global id (``aug_id``), logs
metrics with the throughput, writes checkpoints at group boundaries, can
trace a window of steps with ``torch.profiler``, and can kill itself at a
given step to test resume. One process, one device: the spatially
sharded path (``space_shards > 1``) is not ported yet.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch

from partseg_tpu_torch.data import build_dataset, make_loader, prefetch
from partseg_tpu_torch.device import default_device
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


def build_step_fn(cfg: TrainConfig, model: PartNet, sampler, perceptual):
    """fn(state, batches, seed) → (state, metrics) for one dispatch of the
    loop: a period of ``augment.warp_every`` sub-steps (a tuple of as many
    batches; sub-step 0 warps), or with ``scan_groups > 1`` a list of that
    many such tuples, each applied ``data_echo`` times (compose_scan)."""
    if cfg.augment.warp_every <= 1:
        step = make_train_step(cfg, model, sampler, perceptual, warp_on=True)

        def body(state, batches, seed):
            return step(state, batches[0], seed)
    else:
        body = make_train_period(cfg, model, sampler, perceptual)
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


def train(cfg: TrainConfig, *, data_iter: Iterator[dict] | None = None, restore: bool = True,
          device: str | torch.device | None = None, debug_nans: bool = False) -> TrainState:
    """Run training on ``device`` (the CUDA card unless given). Returns the
    final TrainState. ``data_iter`` replaces the config's dataset (the
    caller then owns the resume seek); ``debug_nans`` turns on autograd's
    anomaly detection and fails on a non-finite loss."""
    if cfg.space_shards > 1:
        raise NotImplementedError(
            f"space_shards={cfg.space_shards}: spatially sharded training is not ported "
            "yet (ROADMAP Queue 1 item 6)")
    dev = default_device(device)
    batch = cfg.global_batch            # one process on one device
    model = init_weights(PartNet(cfg.model, device="cpu"), seed=cfg.seed).to(dev)
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
        data_iter = prefetch(make_loader(
            dataset, batch, seed=cfg.seed, num_workers=4, backend=cfg.loader_backend,
            start_batch=start_step // cfg.data_echo))

    step_fn = build_step_fn(cfg, model, sampler, perceptual)
    seed = cfg.seed + 1                 # the augmentation's key, apart from the init's
    pin = dev.type == "cuda"

    def fetch(fetch_step: int, sub: int) -> dict:
        """The next host batch, with the global ids of its samples."""
        hb = dict(next(data_iter))
        hb["aug_id"] = np.arange(batch, dtype=np.int64) + (fetch_step + sub) * cfg.global_batch
        return hb

    def to_device(hb: dict) -> dict:
        """A host batch on the device: pinned memory, copied asynchronously;
        with device_data, the images gathered from the device table. The
        aug_ids stay on the host, where the step hashes its draws."""
        key = "index" if table is not None else "image"
        x = torch.from_numpy(np.ascontiguousarray(hb[key]))
        x = x.pin_memory().to(dev, non_blocking=True) if pin else x
        image = table.index_select(0, x) if table is not None else x
        return {"image": image, "aug_id": hb["aug_id"]}

    logger = MetricLogger(cfg.ckpt_dir)
    anomaly = torch.autograd.detect_anomaly() if debug_nans else contextlib.nullcontext()
    profiler = None
    t_last = time.perf_counter()
    imgs_since = 0
    echoed = None
    with anomaly:
        for step in range(start_step, cfg.steps, stride):
            if cfg.profile_steps and step <= cfg.profile_steps[0] < step + stride:
                profiler = _start_profile(dev)
            if cfg.scan_groups > 1:
                # One dispatch = scan_groups fetch groups, fetched group-major:
                # the same batches and aug_ids as that many dispatches.
                groups = [tuple(to_device(fetch(step + g * group, j)) for j in range(period))
                          for g in range(cfg.scan_groups)]
                viz = groups[0][0]
                state, metrics = step_fn(state, groups, seed)
            else:
                # data_echo: a fresh group of batches once per data_echo
                # dispatches, the same device batches in between (their
                # draws still differ: they are keyed by the step).
                if step % group == 0 or echoed is None:
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
                m = {k: v.item() for k, v in metrics.items()}
                now = time.perf_counter()
                dt = now - t_last
                m["img_per_sec_per_chip"] = imgs_since / dt if dt > 0 else 0.0
                m["lr_step"] = step
                m["vgg_mode"] = perceptual.vgg_mode
                logger.log(step, m)
                t_last = now
                imgs_since = 0

            if cfg.image_log_every and step % cfg.image_log_every < stride:
                _log_images(logger, state.model, viz["image"], step)

            if (cfg.fault_injection_step is not None
                    and step <= cfg.fault_injection_step < step + stride):
                print(f"[train] FAULT INJECTION at step {step} — exiting hard", flush=True)
                ckpt.wait()
                os._exit(42)

            if (step + stride) % group == 0:
                # Checkpoints only at group boundaries, so that the resume
                # seek (start_batch = step // data_echo) stays exact.
                ckpt.save(step + stride, state)

    if profiler is not None:
        _stop_profile(profiler, dev, os.path.join(cfg.ckpt_dir, "profile"), cfg.steps)
    ckpt.save(cfg.steps, state, force=True)
    ckpt.wait()
    logger.close()
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
