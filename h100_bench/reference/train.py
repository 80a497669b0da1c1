"""The plain reference of one training step, in float32: paired augmentation,
the model on [x_a; x_s], the VGG-19 perceptual loss, the TPS equivariance
loss, the dense-segmentation consistency and the appearance-swap term, then
clip by the global norm and Adam on a warmup-cosine schedule (optax's
semantics: the learning rate is read at the count before the increment, the
bias corrections formed in float32, eps outside the square root).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.augment import TPS, make_pair
from h100_bench.reference.model import PartNet, nchw, precision, render

_VGG19 = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class VGG19(nn.Module):
    """VGG-19 up to the deepest of ``layers`` (never past ``trim_blocks``)."""

    def __init__(self, layers, trim_blocks: int):
        super().__init__()
        self.extract = tuple(layers)
        deepest = max((b, i) for b, n, _ in _VGG19 for i in range(1, n + 1)
                      if f"relu{b}_{i}" in self.extract)
        self.convs, cin = [], 3
        for block, n, ch in _VGG19[:trim_blocks]:
            for i in range(1, n + 1):
                if (block, i) > deepest:
                    break
                self.add_module(f"conv{block}_{i}", nn.Conv2d(cin, ch, 3, padding=1))
                self.convs.append((block, i))
                cin = ch

    def forward(self, x):
        mean = torch.tensor(_MEAN, device=x.device)
        std = torch.tensor(_STD, device=x.device)
        h, feats = nchw((x - mean) / std), {}
        for block, i in self.convs:
            if i == 1 and block > 1:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(getattr(self, f"conv{block}_{i}")(h))
            if f"relu{block}_{i}" in self.extract:
                feats[f"relu{block}_{i}"] = h
        return feats


def _pool(x, k):
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


def perceptual(vgg: VGG19, loss: dict, x_hat, x):
    """Σ_l λ_l mean|φ_l(x̂) − φ_l(x)| + λ_pix mean|x̂ − x|, the VGG inputs pooled
    to ``vgg_resolution`` when that is below the image size."""
    r = min(loss["vgg_resolution"] or x_hat.shape[1], x_hat.shape[1])
    vh = _pool(x_hat, x_hat.shape[1] // r) if x_hat.shape[1] > r else x_hat
    vt = _pool(x, x.shape[1] // r) if x.shape[1] > r else x
    fh = vgg(vh)
    with torch.no_grad():
        ft = vgg(vt)
    weights = loss["vgg_layer_weights"] or (1.0,) * len(vgg.extract)
    out = x_hat.new_zeros(())
    for name, w in zip(vgg.extract, weights):
        out = out + w * (fh[name] - ft[name]).abs().mean()
    if loss["pixel_weight"]:
        xp = _pool(x, x.shape[1] // x_hat.shape[1]) if x.shape[1] > x_hat.shape[1] else x
        out = out + loss["pixel_weight"] * (x_hat - xp).abs().mean()
    return out


def equivariance(tps: TPS, w, mu_s, sigma_s, mu_a, sigma_a, sigma_weight: float):
    """mean ‖T(μ_s) − μ_a‖² + λ_Σ mean ‖J Σ_s Jᵀ − Σ_a‖_F."""
    jac = tps.jacobian(w, mu_s)
    sig_pred = torch.einsum("bkij,bkjl,bkml->bkim", jac, sigma_s, jac)
    mu_err = torch.sum((tps.transform(w, mu_s) - mu_a) ** 2, dim=-1).mean()
    sig_err = torch.sqrt(torch.sum((sig_pred - sigma_a) ** 2, dim=(-2, -1)) + 1e-12).mean()
    return mu_err + sigma_weight * sig_err


def seg_consistency(logits_a, mu_a, sigma_a):
    """Cross-entropy of the per-pixel part softmax against the no-grad
    occupancy of the rendered blobs (background: clip(1 − Σ_k φ_k, 0, 1))."""
    _, h, w, _ = logits_a.shape
    with torch.no_grad():
        phi = render(mu_a, precision(sigma_a), h, w)
        target = torch.cat([phi, torch.clamp(1.0 - phi.sum(-1, keepdim=True), 0.0, 1.0)], -1)
        target = target / (target.sum(-1, keepdim=True) + 1e-8)
    return -torch.mean(torch.sum(target * F.log_softmax(logits_a, dim=-1), dim=-1))


def loss_fn(model: PartNet, vgg: VGG19, tps: TPS, cfg: dict, images, seed: int, step: int,
            ids: np.ndarray, outputs: dict | None = None, warp_on: bool = True):
    """The step's loss; ``outputs``, where given, receives the forward's
    reconstruction and landmarks."""
    lw, m = cfg["loss"], cfg["model"]
    pair = make_pair(images, seed, step, ids, tps, cfg["augment"], warp_on)
    out = model(pair["x_s"], pair["x_a"])
    if outputs is not None:
        outputs.update({k: out[k].detach() for k in ("recon", "mu_a")})
    loss = lw["rec_weight"] * perceptual(vgg, lw, out["recon"], images)
    loss = loss + lw["equiv_weight"] * equivariance(
        tps, pair["tps"], out["mu_s"], out["sigma_s"], out["mu_a"], out["sigma_a"],
        lw["equiv_sigma_weight"])
    if lw["seg_weight"] and m["background"]:
        loss = loss + lw["seg_weight"] * seg_consistency(out["logits_a"], out["mu_a"], out["sigma_a"])
    if lw["swap_weight"]:
        recon_sw = model.decoder(out["mu_a"], out["sigma_a"], torch.roll(out["appearance"], 1, 0))
        _, mu_sw, _ = model.shape_stats(model.shape_enc(recon_sw))
        loss = loss + lw["swap_weight"] * torch.mean(torch.sum((mu_sw - out["mu_a"]) ** 2, -1))
    return loss


def learning_rate(o: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay, lr·end) at ``count``."""
    f32 = np.float32
    peak, warm = o["lr"], o["warmup_steps"]
    alpha = o["end_lr_factor"]
    span = o["decay_steps"] - warm
    if count < warm:
        frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
        return float(f32(0.0 - peak) * frac + f32(peak))
    t = f32(min(count - warm, span))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(span)))
    return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))


class Adam:
    """clip_by_global_norm → Adam(W), optax's semantics, plain loops over leaves."""

    def __init__(self, o: dict, params: dict):
        self.o, self.count = o, 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        o = self.o
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = 1.0 if (not o["grad_clip"] or norm < o["grad_clip"]) else o["grad_clip"] / norm
        n = self.count + 1
        f32 = np.float32
        c1 = float(f32(1) - f32(o["b1"]) ** f32(n))
        c2 = float(f32(1) - f32(o["b2"]) ** f32(n))
        lr = learning_rate(o, self.count)
        for k, p in params.items():
            g = grads[k] * scale
            self.mu[k].mul_(o["b1"]).add_(g, alpha=1.0 - o["b1"])
            self.nu[k].mul_(o["b2"]).addcmul_(g, g, value=1.0 - o["b2"])
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + 1e-8)
            if o["weight_decay"]:
                upd = upd + o["weight_decay"] * p
            p.add_(upd, alpha=-lr)
        self.count = n
