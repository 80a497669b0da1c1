"""Train-step throughput of the port on one CUDA card, the counterpart of
the JAX package's ``bench.py``:

    python -m partseg_tpu_torch.bench [--batch 128] [--steps 20] [--config speed128]
                                      [--set KEY=VAL ...]

Runs the config's training period (``augment.warp_every`` sub-steps, the
first one TPS-warped) at the given batch on device-resident random
images, with seeded random weights and the port's VGG (``vgg_mode`` says
which), and prints one JSON line. The time is taken by CUDA events
between synchronisations, after warm-up periods. ``host_ms_per_period``
is the host's time to issue one period onto an idle card (each period
started after a synchronisation; median of ``HOST_PERIODS``): while it is
below ``period_ms`` the card, not the host, sets the rate.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from partseg_tpu_torch.configs import train_config
from partseg_tpu_torch.models.partnet import PartNet, init_weights
from partseg_tpu_torch.train import build_perceptual, create_state, make_train_period

HOST_PERIODS = 10


def build_trainer(cfg, batch: int, seed: int = 0, device: str = "cuda"):
    """(state, period_fn, batches, perceptual): the config's model with
    seeded random weights at step 0, its training period, and one
    device-resident batch of uniform random images per sub-step (the same
    buffer, as the JAX bench reuses one)."""
    model = init_weights(PartNet(cfg.model, device="cpu"), seed=seed).to(device)
    perceptual = build_perceptual(cfg, device)
    sampler = cfg.augment.make_sampler()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    s = cfg.model.img_size
    image = torch.rand((batch, s, s, 3), generator=gen, device=device)
    batches = tuple({"image": image} for _ in range(cfg.augment.warp_every))
    period = make_train_period(cfg, model, sampler, perceptual)
    return create_state(cfg, model), period, batches, perceptual


def main(batch: int = 128, steps: int = 20, warmup: int = 3, config: str = "speed128",
         overrides=()) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures the CUDA card and none is available")
    cfg = train_config(config, overrides)
    state, period, batches, perceptual = build_trainer(cfg, batch)
    for _ in range(warmup):
        state, _ = period(state, batches, cfg.seed)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, metrics = period(state, batches, cfg.seed)
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    host = []
    for _ in range(HOST_PERIODS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = period(state, batches, cfg.seed)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    images = batch * cfg.augment.warp_every * steps
    result = {
        "metric": "train_throughput_128px",
        "value": images / seconds,
        "unit": "img/s/chip",
        "period_ms": seconds * 1e3 / steps,
        "host_ms_per_period": statistics.median(host),
        "vgg_mode": perceptual.vgg_mode,
        "config": config,
        "backend": "cuda",
        "device": torch.cuda.get_device_name(0),
        "loss": metrics["loss"].item(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20, help="timed periods")
    ap.add_argument("--config", default="speed128", help="a train preset of configs.py")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                    help="dot-path config overrides")
    a = ap.parse_args()
    main(batch=a.batch, steps=a.steps, config=a.config, overrides=getattr(a, "set"))
