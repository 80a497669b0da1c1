"""Component-level timing on the card, the port's twin of
tools/profile_components.py: the forward (and backward) of each stage of
the train step in isolation, at the flagship 128 px config with B = 64.

    python -m partseg_tpu_torch.tools.profile_components [--cpu]

Rows, as the JAX tool's: the shape encoder forward, and forward +
backward (the gradient of Σ out² with respect to its parameters); the
appearance encoder forward; the decoder forward, and forward + backward
(gradient of Σ out); the VGG perceptual loss (trim_blocks = 4, the port's
seeded random VGG) forward, and forward + backward (gradient with
respect to the reconstruction); the augment pair (the keyed draws, the TPS
warp of the whole batch and the colour jitter); the TPS warp only (the
tps_warp kernel); the TPS flow only; the bilinear gather only (the
bilinear_sample kernel on the explicit flow); and the warp backward
(gradient of Σ warp(x) with respect to x, through the kernel's grads
variant). Each row is one warm-up call, then the mean of 10 calls: CUDA
events on the card, the host's clock around the calls on the CPU. Prints
the JAX tool's ``name  ms  img/s`` table and one JSON line per row.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from partseg_tpu_torch.models.partnet import PartNetConfig

B = 64
S = 128
CFG = PartNetConfig(n_parts=10, img_size=S)
STEPS = 10


def bench(name: str, fn, cuda: bool, steps: int = STEPS) -> dict:
    """Mean ms of one call of ``fn`` over ``steps`` calls after a warm-up."""
    fn()
    if cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / steps
    else:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"{name:28s} {ms:8.2f} ms   {B / ms * 1e3:8.0f} img/s", flush=True)
    return {"metric": "component_ms", "name": name, "ms": ms, "img_per_s": B / ms * 1e3,
            "batch": B, "img_size": S, "timer": "cuda_events" if cuda else "host_clock"}


def main(device=None) -> list[dict]:
    from partseg_tpu_torch.augment import AugmentConfig, keyed_pair_draws, make_pair
    from partseg_tpu_torch.device import default_device
    from partseg_tpu_torch.losses.perceptual import PerceptualLoss
    from partseg_tpu_torch.losses.vgg import RANDOM_SEED, VGG19Features
    from partseg_tpu_torch.models.decoder import Decoder
    from partseg_tpu_torch.models.encoders import AppearanceEncoder, ShapeEncoder
    from partseg_tpu_torch.models.partnet import init_weights
    from partseg_tpu_torch.partops.warp import warp_image

    dev = default_device(device)
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((B, S, S, 3), generator=gen, device=dev)
    rows = []

    def grads(loss, params):
        return torch.autograd.grad(loss, params)

    shape_enc = init_weights(ShapeEncoder(
        n_parts=CFG.n_parts, background=CFG.background, depth=CFG.depth,
        features=CFG.features, stem_stride=CFG.stem_stride, dtype=CFG.dtype)).to(dev)
    p_shape = list(shape_enc.parameters())
    with torch.no_grad():
        rows.append(bench("shape_enc fwd", lambda: shape_enc(x), cuda))
    rows.append(bench("shape_enc fwd+bwd",
                      lambda: grads(torch.sum(shape_enc(x).float() ** 2), p_shape), cuda))

    app_enc = init_weights(AppearanceEncoder(
        out_features=CFG.app_features, depth=CFG.depth, features=CFG.features,
        stem_stride=CFG.stem_stride, dtype=CFG.dtype)).to(dev)
    with torch.no_grad():
        rows.append(bench("app_enc fwd", lambda: app_enc(x), cuda))

    dec = init_weights(Decoder(app_features=CFG.app_features, out_size=S,
                               n_scales=CFG.decoder_scales, features=CFG.decoder_features,
                               dtype=CFG.dtype)).to(dev)
    p_dec = list(dec.parameters())
    mu = torch.rand((B, CFG.n_parts, 2), generator=gen, device=dev) - 0.5
    sigma = 0.02 * torch.eye(2, device=dev).expand(B, CFG.n_parts, 2, 2)
    app = torch.randn((B, CFG.n_parts, CFG.app_features), generator=gen, device=dev)
    with torch.no_grad():
        rows.append(bench("decoder fwd", lambda: dec(mu, sigma, app), cuda))
    rows.append(bench("decoder fwd+bwd",
                      lambda: grads(torch.sum(dec(mu, sigma, app).float()), p_dec), cuda))

    vgg = init_weights(VGG19Features(trim_blocks=4, dtype=CFG.dtype), seed=RANDOM_SEED)
    loss = PerceptualLoss(vgg, vgg_mode="random-torch").to(dev)
    y = (x * 0.5).requires_grad_(True)
    with torch.no_grad():
        rows.append(bench("vgg loss fwd", lambda: loss(y, x), cuda))
    rows.append(bench("vgg loss fwd+bwd", lambda: grads(loss(y, x), [y]), cuda))

    acfg = AugmentConfig()
    sampler = acfg.make_sampler()
    aug_id = torch.arange(B)

    def pair():
        d = keyed_pair_draws(0, 0, aug_id, sampler, acfg, device=dev)
        return make_pair(x, d.tps, d.color, sampler, acfg)["x_s"]

    with torch.no_grad():
        rows.append(bench("augment pair (tps+jitter)", pair, cuda))
        tps = sampler.sample(gen, B)
        rows.append(bench("tps warp only", lambda: sampler.warp(tps, x), cuda))
        rows.append(bench("tps flow only", lambda: sampler.flow_field(tps, S, S), cuda))
        flow = sampler.flow_field(tps, S, S)
        rows.append(bench("bilinear gather only", lambda: warp_image(x, flow), cuda))
    xg = x.clone().requires_grad_(True)
    rows.append(bench("warp bwd", lambda: grads(torch.sum(warp_image(xg, flow)), [xg]), cuda))
    for row in rows:
        print(json.dumps({**row, "device": str(dev)}))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="time on the CPU (plain versions)")
    main(device="cpu" if ap.parse_args().cpu else None)
