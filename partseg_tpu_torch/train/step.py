"""The training step, twin of partseg_tpu/train/step.py.

One step: paired augmentation (no gradient) → PartNet forward on
[x_a; x_s] → VGG-perceptual + equivariance (+ seg-consistency, + swap)
losses → gradients → clip → Adam on a warmup-cosine schedule. PyTorch
runs it eagerly; the state is updated in place.

Draws come from one ``torch.Generator`` per (seed, step) on the images'
device, unless the caller passes them (the tests pass the JAX package's).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from partseg_tpu_torch.augment.pair import PairDraws, make_pair, sample_pair_draws
from partseg_tpu_torch.augment.tps import TPSSampler
from partseg_tpu_torch.losses.equivariance import equivariance_loss
from partseg_tpu_torch.device import default_device
from partseg_tpu_torch.losses.perceptual import PerceptualLoss
from partseg_tpu_torch.losses.vgg import VGG19Features, load_vgg19
from partseg_tpu_torch.models.partnet import PartNet
from partseg_tpu_torch.partops.moments import precision_from_cov
from partseg_tpu_torch.partops.render import render_gaussians
from partseg_tpu_torch.train.config import TrainConfig
from partseg_tpu_torch.train.state import TrainState, make_optimizer, trainable


def build_perceptual(cfg: TrainConfig, device=None) -> PerceptualLoss:
    """The config's perceptual loss on ``device`` (the CUDA card unless
    given), its VGG from ``loss.vgg_npz`` or the port's seeded random init."""
    lw = cfg.loss
    vgg = VGG19Features(lw.vgg_layers, lw.vgg_trim_blocks, dtype=cfg.model.dtype)
    mode = load_vgg19(vgg, lw.vgg_npz)
    return PerceptualLoss(vgg, lw.vgg_layer_weights, lw.pixel_weight, lw.vgg_resolution,
                          vgg_mode=mode).to(default_device(device))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s draws: one per (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed << 32) | (step & 0xFFFFFFFF))
    return gen


def make_loss_fn(cfg: TrainConfig, model: PartNet, sampler: TPSSampler,
                 perceptual: PerceptualLoss, warp_on: bool = True) -> Callable:
    """loss_fn(batch, draws) → (loss, metrics) for ``model``'s parameters.
    ``batch["image"]`` is [B, H, W, 3] f32 in [0, 1] or uint8."""
    lw = cfg.loss

    def loss_fn(batch: dict, draws: PairDraws):
        images = batch["image"]
        if images.dtype == torch.uint8:
            images = images.float() * (1.0 / 255.0)
        # Augmentation is input data: no gradient, in the model dtype (the
        # encoders cast their inputs anyway). The f32 images stay the
        # reconstruction target.
        with torch.no_grad():
            pair = make_pair(images.to(cfg.model.dtype), draws.tps, draws.color, sampler,
                             cfg.augment, warp_on=warp_on, tps2=draws.tps2)
        out = model(pair["x_s"], pair["x_a"])
        l_rec = perceptual(out.recon, images)
        l_eq, eq_metrics = equivariance_loss(
            sampler, pair["tps"], out.mu_s, out.sigma_s, out.mu_a, out.sigma_a,
            sigma_weight=lw.equiv_sigma_weight)
        loss = lw.rec_weight * l_rec + lw.equiv_weight * l_eq
        metrics = {"rec": l_rec, "equiv": l_eq, **eq_metrics}
        if lw.seg_weight and cfg.model.background:
            l_seg = _seg_consistency(out)
            loss = loss + lw.seg_weight * l_seg
            metrics["seg"] = l_seg
        if lw.swap_weight:
            # Appearance-swap consistency: shape must survive appearance
            # transfer (in-batch roll of the appearance vectors).
            recon_sw = model.decode(out.mu_a, out.sigma_a, torch.roll(out.appearance, 1, 0))
            _, mu_sw, _ = model.shape_stats(model.encode_shape(recon_sw))
            l_swap = torch.mean(torch.sum((mu_sw - out.mu_a.float()) ** 2, dim=-1))
            loss = loss + lw.swap_weight * l_swap
            metrics["swap"] = l_swap
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_train_step(cfg: TrainConfig, model: PartNet, sampler: TPSSampler,
                    perceptual: PerceptualLoss, warp_on: bool = True) -> Callable:
    """train_step(state, batch, seed=0, draws=None) → (state, metrics).

    warp_on is static, as in the JAX package: a warp_every > 1 schedule
    builds one step with the warp and one without (make_train_period).
    Metrics are 0-dim tensors on the model's device."""
    optimizer = make_optimizer(cfg.optim)
    loss_fn = make_loss_fn(cfg, model, sampler, perceptual, warp_on)

    def train_step(state: TrainState, batch: dict, seed: int = 0,
                   draws: PairDraws | None = None):
        images = batch["image"]
        if draws is None:
            gen = step_generator(seed, state.step, images.device)
            draws = sample_pair_draws(gen, images.shape[0], sampler, cfg.augment)
        loss, metrics = loss_fn(batch, draws)
        params = list(trainable(state.model).values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.update(state.model, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return train_step


def make_train_period(cfg: TrainConfig, model: PartNet, sampler: TPSSampler,
                      perceptual: PerceptualLoss) -> Callable:
    """One full ``augment.warp_every`` period: sub-step 0 warps, the
    others train warp-free. Takes a tuple of one batch per sub-step."""
    subs = [make_train_step(cfg, model, sampler, perceptual, warp_on=(i == 0))
            for i in range(cfg.augment.warp_every)]
    return compose_period(subs)


def compose_period(subs: list) -> Callable:
    """Sequence sub-step closures into one period. Each draws by its own
    step, which increments between subs. Metrics: the mean over the
    period, plus "loss_warp_on" / "loss_warp_off" of the first and last."""

    def period_step(state: TrainState, batches: tuple, seed: int = 0,
                    draws: tuple | None = None):
        ms = []
        for i, (fn, batch) in enumerate(zip(subs, batches)):
            state, m = fn(state, batch, seed, None if draws is None else draws[i])
            ms.append(m)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        metrics["loss_warp_on"] = ms[0]["loss"]
        metrics["loss_warp_off"] = ms[-1]["loss"]
        return state, metrics

    return period_step


def _seg_consistency(out) -> torch.Tensor:
    """Cross-entropy between the per-pixel part softmax (K+bg) and the
    no-grad occupancy of the rendered Gaussians: part k with weight
    φ_k(u), background with weight clip(1 − Σ_k φ_k, 0, 1)."""
    logits = out.logits_a                                   # [B, h, w, K+1]
    _, h, w, _ = logits.shape
    with torch.no_grad():
        lam = precision_from_cov(out.sigma_a)
        phi = render_gaussians(out.mu_a, out.sigma_a, h, w, precision=lam)
        bg = torch.clamp(1.0 - phi.sum(-1, keepdim=True), 0.0, 1.0)
        target = torch.cat([phi, bg], dim=-1)
        target = target / (target.sum(-1, keepdim=True) + 1e-8)
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(target * logp, dim=-1))
