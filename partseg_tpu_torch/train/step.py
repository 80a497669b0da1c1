"""The training step, twin of partseg_tpu/train/step.py.

One step: paired augmentation (no gradient) → PartNet forward on
[x_a; x_s] → VGG-perceptual + equivariance (+ seg-consistency, + swap)
losses → gradients → clip → Adam on a warmup-cosine schedule. PyTorch
runs it eagerly; the state is updated in place.

Each sample's draws are keyed by (seed, step, aug_id), as the JAX
package folds ``aug_id`` into the step's key (``augment/keys.py``), unless
the caller passes them (the parity tests pass the JAX package's).

The step and its parts run in the spans ``train.step``, ``train.augment``,
``train.model``, ``train.perceptual``, ``train.equivariance``,
``train.swap``, ``train.backward`` and ``train.optimizer`` (``tracing``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from partseg_tpu_torch.augment.pair import PairDraws, keyed_pair_draws, make_pair
from partseg_tpu_torch.augment.tps import TPSSampler
from partseg_tpu_torch.losses.equivariance import equivariance_loss
from partseg_tpu_torch.device import default_device
from partseg_tpu_torch.dist.mesh import average, group_size
from partseg_tpu_torch.losses.perceptual import PerceptualLoss
from partseg_tpu_torch.losses.vgg import VGG19Features, load_vgg19
from partseg_tpu_torch.models.partnet import PartNet
from partseg_tpu_torch.partops.moments import precision_from_cov
from partseg_tpu_torch.partops.render import render_gaussians
from partseg_tpu_torch.tracing import span
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
        with torch.no_grad(), span("train.augment"):
            pair = make_pair(images.to(cfg.model.dtype), draws.tps, draws.color, sampler,
                             cfg.augment, warp_on=warp_on, tps2=draws.tps2)
        with span("train.model"):
            out = model(pair["x_s"], pair["x_a"])
        with span("train.perceptual"):
            l_rec = perceptual(out.recon, images)
        with span("train.equivariance"):
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
            with span("train.swap"):
                recon_sw = model.decode(out.mu_a, out.sigma_a, torch.roll(out.appearance, 1, 0))
                _, mu_sw, _ = model.shape_stats(model.encode_shape(recon_sw))
                l_swap = torch.mean(torch.sum((mu_sw - out.mu_a.float()) ** 2, dim=-1))
                loss = loss + lw.swap_weight * l_swap
            metrics["swap"] = l_swap
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_train_step(cfg: TrainConfig, model: PartNet, sampler: TPSSampler,
                    perceptual: PerceptualLoss, warp_on: bool = True,
                    group=None) -> Callable:
    """train_step(state, batch, seed=0, draws=None) → (state, metrics).

    warp_on is static, as in the JAX package: a warp_every > 1 schedule
    builds one step with the warp and one without (make_train_period).
    ``batch["aug_id"]`` [B] (host integers, default 0..B−1) are the
    samples' global ids that key their draws. Metrics are 0-dim tensors on the model's device.

    ``group`` (a mesh's data group) makes it the data-parallel step, the
    JAX step with ``axis_name``: each rank takes its shard of the batch,
    and the gradients and the metrics are averaged over the group, in one
    all-reduce, before the clip and Adam (the swap loss rolls the
    appearance within the shard). At a group size of 1 the step has no
    collective, and without a group it has none either."""
    optimizer = make_optimizer(cfg.optim)
    loss_fn = make_loss_fn(cfg, model, sampler, perceptual, warp_on)

    def train_step(state: TrainState, batch: dict, seed: int = 0,
                   draws: PairDraws | None = None):
        with span("train.step"):
            images = batch["image"]
            if draws is None:
                aug_id = batch.get("aug_id")
                if aug_id is None:
                    aug_id = np.arange(images.shape[0])
                with span("train.augment"):
                    draws = keyed_pair_draws(seed, state.step, aug_id, sampler, cfg.augment,
                                             images.device)
            loss, metrics = loss_fn(batch, draws)
            params = list(trainable(state.model).values())
            with span("train.backward"):
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            metrics = {k: v.detach() for k, v in metrics.items()}
            if group is not None and group_size(group) > 1:
                names = list(metrics)
                reduced = average(grads + [metrics[k] for k in names], group)
                grads = reduced[:len(grads)]
                metrics = dict(zip(names, reduced[len(grads):]))
            with span("train.optimizer"):
                metrics["grad_norm"] = optimizer.update(state.model, grads, state.opt_state)
            state.step += 1
            return state, metrics

    return train_step


def make_train_period(cfg: TrainConfig, model: PartNet, sampler: TPSSampler,
                      perceptual: PerceptualLoss, group=None) -> Callable:
    """One full ``augment.warp_every`` period: sub-step 0 warps, the
    others train warp-free. Takes a tuple of one batch per sub-step."""
    subs = [make_train_step(cfg, model, sampler, perceptual, warp_on=(i == 0), group=group)
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


def compose_scan(body: Callable, scan_groups: int, data_echo: int = 1) -> Callable:
    """Run ``body`` (a step or period) over ``scan_groups`` fetch groups
    per call, each applied ``data_echo`` times in a row: the JAX package's
    ``compose_scan`` (one ``lax.scan`` dispatch) as a host loop, the same
    step sequence (each sub-step draws by its own step, which advances).
    Takes a sequence of ``scan_groups`` batch arguments of ``body``.
    Metrics: the mean over every step of the call."""

    def scan_dispatch(state, groups, seed: int = 0):
        if len(groups) != scan_groups:
            raise ValueError(f"compose_scan takes {scan_groups} fetch groups, got {len(groups)}")
        ms = []
        for batches in groups:
            for _ in range(data_echo):
                state, m = body(state, batches, seed)
                ms.append(m)
        return state, {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    return scan_dispatch


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
