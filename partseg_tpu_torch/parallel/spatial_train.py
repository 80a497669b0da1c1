"""The spatially sharded train step, the port's counterpart of
partseg_tpu/parallel/spatial_train.py.

The whole PartNet step (paired augmentation, both encoders, the decoder,
the perceptual, equivariance, seg-consistency and swap losses, the
gradients, clip and Adam) on a (data, space) mesh: the batch split over
the data shards, each data shard's image rows over its space group.
Parameters are replicated.

- Augmentation is an image-level op (the TPS warp reads any row), so
  each rank all-gathers its data shard's input rows over the space group,
  augments the full images with the samples' keyed draws (the same on
  every rank of the group) and keeps its own rows. The compute is
  repeated across the group; the activations are not.
- Forward: the sharded encoders (halo convolutions, GroupNorm over the
  group), the per-pixel part softmax, moments and pooling summed over the
  group, row-local rendering, the sharded decoder and VGG. Each rank
  holds the exact loss of its whole data shard.
- Gradients: each collective's backward is its adjoint
  (parallel/spatial.py), so the ranks' gradients sum to space_shards
  times the data shard's gradient. One all-reduce over every rank,
  divided by the world size, gives the data-parallel mean of the data
  shards' gradients (and the metrics' mean); then clip and Adam.

The part ops run as plain torch, as the JAX path's are jnp: the
softmax_moments and render_assemble kernels want whole maps. The warp
runs the tps_warp kernel on the gathered full images.

The appearance-swap round rolls the appearance within the data shard,
as the data-parallel step does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from partseg_tpu_torch.augment.pair import PairDraws, keyed_pair_draws, make_pair
from partseg_tpu_torch.dist.mesh import Mesh, average, group_rank, group_size
from partseg_tpu_torch.losses.equivariance import equivariance_loss
from partseg_tpu_torch.losses.perceptual import PerceptualLoss, _pool_mean
from partseg_tpu_torch.losses.vgg import VGG19Features
from partseg_tpu_torch.models.decoder import Decoder
from partseg_tpu_torch.models.blocks import upsample2x
from partseg_tpu_torch.models.encoders import to_nchw, to_nhwc
from partseg_tpu_torch.models.partnet import PartNet
from partseg_tpu_torch.parallel.spatial import (
    all_gather,
    group_sum,
    sharded_pool_appearance,
    sharded_render_gaussians,
    sharded_soft_argmax_moments,
    sharded_spatial_softmax,
)
from partseg_tpu_torch.parallel.spatial_model import (
    _conv,
    _resblock,
    sharded_appearance_encoder,
    sharded_shape_encoder,
)
from partseg_tpu_torch.partops.assembly import assemble_decoder_input
from partseg_tpu_torch.partops.moments import precision_from_cov
from partseg_tpu_torch.train.state import make_optimizer, trainable


def _mean_elems(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over ALL elements of a row-sharded tensor, f32: the local
    sum summed over the group, over the global element count."""
    s = group_sum(x.sum(dtype=torch.float32).reshape(1), group)[0]
    return s / (x.numel() * group_size(group))


def _gather_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """The full images of the data shard from each rank's rows (no gradient)."""
    if group_size(group) == 1:
        return rows
    return torch.cat(all_gather(rows, group), dim=1)


# ------------------------------------------------------------------ decoder


def sharded_decoder(dec: Decoder, mu: torch.Tensor, sigma: torch.Tensor,
                    appearance: torch.Tensor, group) -> torch.Tensor:
    """models/decoder.py on row shards → this rank's rows of the
    reconstruction [B, S/n, S, 3]. (μ, Σ, a) are replicated; each scale's
    blobs are rendered row-locally and assembled in f32 with a plain
    product (the render_assemble kernel's numerics), then the ResBlocks
    run with halos and GroupNorm over the group."""
    n = group_size(group)
    lam = precision_from_cov(sigma)
    app = appearance.to(dec.dtype)
    x = None
    for i in range(dec.n_scales):
        res = dec.out_size // (2 ** (dec.n_scales - 1 - i))
        if res % n:
            raise ValueError(f"decoder scale {res} does not split into {n} row shards")
        a_i = dec.app_proj[i](app)
        blobs = sharded_render_gaussians(mu, None, res, res, res // n, group,
                                         kernel=dec.render_kernel, precision=lam)
        feat = to_nchw(assemble_decoder_input(blobs, a_i.float()).to(dec.dtype))
        x = feat if x is None else torch.cat([upsample2x(x), feat], dim=1)
        x = _resblock(_resblock(x, dec.blocks[2 * i], group), dec.blocks[2 * i + 1], group)
    return to_nhwc(torch.sigmoid(_conv(x, dec.to_rgb, group)))


# ------------------------------------------------------------------ vgg loss


def sharded_vgg_features(vgg: VGG19Features, x: torch.Tensor, group) -> dict:
    """losses/vgg.py VGG19Features on NHWC row shards: halo convolutions,
    row-local 2×2 max pools (the shard's rows must stay even through them)."""
    h = to_nchw((x - vgg.mean.to(x.dtype)) / vgg.std.to(x.dtype))
    feats = {}
    for block, i in vgg.layers:
        if i == 1 and block > 1:
            if h.shape[2] % 2:
                raise ValueError(f"a row shard of {h.shape[2]} rows cannot be max-pooled 2×2")
            h = F.max_pool2d(h, 2, 2)
        h = F.relu(_conv(h, getattr(vgg, f"conv{block}_{i}"), group))
        if f"relu{block}_{i}" in vgg.extract:
            feats[f"relu{block}_{i}"] = h
    return feats


def _pool_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.shape[1] % k:
        raise ValueError(f"a row shard of {x.shape[1]} rows cannot be pooled {k}×{k}")
    return _pool_mean(x, k)


def sharded_perceptual_loss(perceptual: PerceptualLoss, x_hat: torch.Tensor,
                            x: torch.Tensor, group) -> torch.Tensor:
    """losses/perceptual.py on row shards: pool to the feature resolution
    row-locally, the sharded VGG on both, element means summed over the
    group. Returns the data shard's loss (f32 scalar) on every rank."""
    n = group_size(group)
    h_hat, h_x = x_hat.shape[1] * n, x.shape[1] * n           # global rows
    vgg = perceptual.vgg
    vh, vt = x_hat, x.to(x_hat.dtype)
    r = min(perceptual.feature_resolution or h_hat, h_hat)
    if h_hat > r:
        vh = _pool_rows(vh.to(vgg.dtype), h_hat // r)
    if h_x > r:
        vt = _pool_rows(vt.to(vgg.dtype), h_x // r)
    feats_hat = sharded_vgg_features(vgg, vh, group)
    with torch.no_grad():
        feats_tgt = sharded_vgg_features(vgg, vt, group)
    loss = x_hat.new_zeros((), dtype=torch.float32)
    for name, w in zip(perceptual.extract, perceptual.layer_weights):
        loss = loss + w * _mean_elems((feats_hat[name] - feats_tgt[name]).abs(), group)
    if perceptual.pixel_weight:
        xp = x
        if h_x > h_hat:
            xp = _pool_rows(x.float(), h_x // h_hat)
        loss = loss + perceptual.pixel_weight * _mean_elems(
            (x_hat.float() - xp.float()).abs(), group)
    return loss


# ------------------------------------------------------------------ forward


def _sharded_stats(logits: torch.Tensor, cfg, h_map: int, group):
    """PartNet.shape_stats on row shards: the spatial normalisation over the
    GLOBAL map, the moments summed over the group."""
    fg = logits[..., :cfg.n_parts]
    if cfg.spatial_norm == "softmax":
        parts = sharded_spatial_softmax(fg, group)
    else:
        e = F.softplus(fg.float())
        parts = e / (group_sum(e.sum(dim=(1, 2), keepdim=True), group) + 1e-8)
    mu, sigma = sharded_soft_argmax_moments(parts, h_map, group)
    return parts, mu, sigma


def sharded_partnet_forward(model: PartNet, x_s: torch.Tensor, x_a: torch.Tensor,
                            group) -> dict:
    """PartNet.forward on row shards. Returns the fields the losses read:
    μ, Σ and the appearance replicated over the group, the image-like
    fields (recon, logits_a) as this rank's rows."""
    cfg = model.cfg
    if cfg.act_quant != "none":
        raise ValueError(
            "spatial sharding does not implement activation-storage "
            f"quantization (act_quant={cfg.act_quant!r}); train spatial "
            "configs with act_quant='none' — a silent numeric mismatch "
            "vs the unsharded forward is worse than this error")
    b = x_s.shape[0]
    logits_both = sharded_shape_encoder(model.shape_enc, torch.cat([x_a, x_s], dim=0), group)
    logits_a, logits_s = logits_both[:b], logits_both[b:]
    _, mu_a, sigma_a = _sharded_stats(logits_a, cfg, cfg.map_size, group)
    parts_s, mu_s, sigma_s = _sharded_stats(logits_s, cfg, cfg.map_size, group)
    feats_s = sharded_appearance_encoder(model.app_enc, x_s, group)
    seg = torch.softmax(logits_s.float(), dim=-1)
    masks_s = seg[..., :cfg.n_parts] if cfg.pool_masks == "pixel" else parts_s
    appearance = sharded_pool_appearance(feats_s, masks_s, group)
    recon = sharded_decoder(model.decoder, mu_a, sigma_a, appearance, group)
    return dict(recon=recon, logits_a=logits_a, mu_a=mu_a, sigma_a=sigma_a,
                mu_s=mu_s, sigma_s=sigma_s, appearance=appearance)


def _sharded_seg_consistency(out: dict, group) -> torch.Tensor:
    """train/step.py _seg_consistency on row shards: the no-grad target
    rendered row-locally, the cross-entropy's mean over the group."""
    logits = out["logits_a"]
    _, h, w, _ = logits.shape
    with torch.no_grad():
        lam = precision_from_cov(out["sigma_a"])
        phi = sharded_render_gaussians(out["mu_a"], None, h * group_size(group), w, h, group,
                                       precision=lam)
        bg = torch.clamp(1.0 - phi.sum(-1, keepdim=True), 0.0, 1.0)
        target = torch.cat([phi, bg], dim=-1)
        target = target / (target.sum(-1, keepdim=True) + 1e-8)
    logp = F.log_softmax(logits.float(), dim=-1)
    return _mean_elems(-torch.sum(target * logp, dim=-1), group)


# ------------------------------------------------------------------ train step


def make_spatial_train_step(cfg, model: PartNet, sampler, perceptual: PerceptualLoss,
                            mesh: Mesh, warp_on: bool = True) -> Callable:
    """train_step(state, batch, seed=0, draws=None) → (state, metrics) on
    ``mesh``: ``batch["image"]`` [B_shard, H/space, W, 3] holds this rank's
    rows of its data shard, ``batch["aug_id"]`` [B_shard] the shard's
    global sample ids (the same on every rank of the space group).
    ``draws`` (optional) are the whole data shard's. warp_on is static, as
    in make_train_step."""
    optimizer = make_optimizer(cfg.optim)
    lw, mc = cfg.loss, cfg.model
    space = mesh.space_group

    def loss_fn(batch: dict, draws: PairDraws):
        rows = batch["image"]
        if rows.dtype == torch.uint8:
            rows = rows.float() * (1.0 / 255.0)
        with torch.no_grad():
            images = _gather_rows(rows, space)
            pair = make_pair(images.to(mc.dtype), draws.tps, draws.color, sampler,
                             cfg.augment, warp_on=warp_on, tps2=draws.tps2)
        h = rows.shape[1]
        r0 = group_rank(space) * h
        x_s, x_a = pair["x_s"][:, r0:r0 + h], pair["x_a"][:, r0:r0 + h]
        out = sharded_partnet_forward(model, x_s, x_a, space)
        l_rec = sharded_perceptual_loss(perceptual, out["recon"], rows, space)
        l_eq, eq_metrics = equivariance_loss(
            sampler, pair["tps"], out["mu_s"], out["sigma_s"], out["mu_a"], out["sigma_a"],
            sigma_weight=lw.equiv_sigma_weight)
        loss = lw.rec_weight * l_rec + lw.equiv_weight * l_eq
        metrics = {"rec": l_rec, "equiv": l_eq, **eq_metrics}
        if lw.seg_weight and mc.background:
            l_seg = _sharded_seg_consistency(out, space)
            loss = loss + lw.seg_weight * l_seg
            metrics["seg"] = l_seg
        if lw.swap_weight:
            # The roll stays within the data shard, as in the data-parallel step.
            recon_sw = sharded_decoder(model.decoder, out["mu_a"], out["sigma_a"],
                                       torch.roll(out["appearance"], 1, 0), space)
            logits_sw = sharded_shape_encoder(model.shape_enc, recon_sw.to(mc.dtype), space)
            out_size = mc.decoder_out_size or mc.img_size
            h_sw = (out_size // mc.stem_stride) * (2 if mc.head_upsample else 1)
            _, mu_sw, _ = _sharded_stats(logits_sw, mc, h_sw, space)
            l_swap = torch.mean(torch.sum((mu_sw - out["mu_a"].float()) ** 2, dim=-1))
            loss = loss + lw.swap_weight * l_swap
            metrics["swap"] = l_swap
        metrics["loss"] = loss
        return loss, metrics

    def train_step(state, batch: dict, seed: int = 0, draws: PairDraws | None = None):
        rows = batch["image"]
        if draws is None:
            aug_id = batch.get("aug_id")
            if aug_id is None:
                aug_id = np.arange(rows.shape[0])
            draws = keyed_pair_draws(seed, state.step, aug_id, sampler, cfg.augment, rows.device)
        loss, metrics = loss_fn(batch, draws)
        params = list(trainable(state.model).values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        names = list(metrics)
        # Σ over every rank / world: Σ over space is space × the shard's
        # gradient (the adjoint scheme), so this is the mean over data.
        reduced = average(grads + [metrics[k].detach().float() for k in names],
                          dist.group.WORLD, divisor=mesh.world)
        grads = reduced[:len(grads)]
        metrics = dict(zip(names, reduced[len(grads):]))
        metrics["grad_norm"] = optimizer.update(state.model, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return train_step


def build_spatial_step_fn(cfg, model: PartNet, sampler, perceptual: PerceptualLoss,
                          mesh: Mesh) -> Callable:
    """One dispatch of the spatial step: a single step (a one-batch tuple
    argument) or, with ``augment.warp_every`` > 1, the period of that many
    sub-steps whose first warps (``train.step.compose_period``)."""
    from partseg_tpu_torch.train.step import compose_period

    every = max(cfg.augment.warp_every, 1)
    subs = [make_spatial_train_step(cfg, model, sampler, perceptual, mesh, warp_on=(i == 0))
            for i in range(every)]
    if every == 1:
        step = subs[0]

        def body(state, batches, seed=0, draws=None):
            return step(state, batches[0], seed, None if draws is None else draws[0])

        return body
    return compose_period(subs)
