"""Train state and optimizer, twin of partseg_tpu/train/state.py.

The optimizer is the JAX package's optax chain — clip_by_global_norm →
adam(w) on a warmup-cosine schedule — written out with optax's
semantics, which differ from torch's own in four places:

- the clip scales by max_norm / norm only when norm ≥ max_norm, with no
  +1e-6 (``clip_grad_norm_`` adds one);
- the schedule is read at the count before the increment, so step 0 has
  lr = 0 under the 0-init warmup, and ``decay_steps`` includes the warmup;
- Adam's eps = 1e-8 sits outside the square root, with the bias
  correction at count + 1;
- decoupled weight decay (adamw) applies only when ``weight_decay`` is set.

Parameters and moments are updated in place with ``torch._foreach_*``
ops; the state keeps the step and the count on the host, so an update
never waits for the card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from partseg_tpu_torch.train.config import OptimConfig


@dataclasses.dataclass
class OptState:
    count: int                       # updates applied so far
    mu: dict[str, torch.Tensor]      # Adam first moments, by parameter name
    nu: dict[str, torch.Tensor]      # Adam second moments


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: OptState


def warmup_cosine(cfg: OptimConfig):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay, lr·end)
    as a function of the update count, evaluated in float32 in optax's
    order of operations (its warmup line cancels in f32 at small counts)."""
    f32 = np.float32
    peak, warm = cfg.lr, cfg.warmup_steps
    end = cfg.lr * cfg.end_lr_factor
    alpha = 0.0 if peak == 0.0 else end / peak
    span = cfg.decay_steps - warm

    def schedule(count: int) -> float:
        if count < warm:
            frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
            return float(f32(0.0 - peak) * frac + f32(peak))
        t = f32(min(count - warm, span))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(span)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


class Optimizer:
    """clip_by_global_norm(grad_clip) → adam(w)(schedule, b1, b2)."""

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = warmup_cosine(cfg)

    def init(self, model: nn.Module) -> OptState:
        params = trainable(model)
        return OptState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                        {k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, model: nn.Module, grads: list[torch.Tensor],
               opt: OptState) -> torch.Tensor:
        """Apply one update in place; ``grads`` in ``trainable(model)``
        order. Returns the global norm of the unclipped gradients."""
        cfg = self.cfg
        named = trainable(model)
        names, params = list(named), list(named.values())
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if cfg.grad_clip:
            # optax: select(norm < max, g, (g / norm) · max), exactly.
            keep = norm < cfg.grad_clip
            one = torch.ones_like(norm)
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * cfg.grad_clip))
        mu = [opt.mu[k] for k in names]
        nu = [opt.nu[k] for k in names]
        torch._foreach_mul_(mu, cfg.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - cfg.b1)
        torch._foreach_mul_(nu, cfg.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - cfg.b2)
        n = opt.count + 1
        # Bias corrections 1 − bᵏ in f32, as optax forms them (1 − 0.999 in
        # f32 is 1.3e-5 off the exact value, and optax carries that).
        f32 = np.float32
        mu_hat = torch._foreach_div(mu, float(f32(1) - f32(cfg.b1) ** f32(n)))
        denom = torch._foreach_sqrt(
            torch._foreach_div(nu, float(f32(1) - f32(cfg.b2) ** f32(n))))
        torch._foreach_add_(denom, 1e-8)
        upd = torch._foreach_div(mu_hat, denom)
        if cfg.weight_decay:
            torch._foreach_add_(upd, params, alpha=cfg.weight_decay)
        with torch.no_grad():
            torch._foreach_add_(params, upd, alpha=-self.schedule(opt.count))
        opt.count = n
        return norm


def trainable(model: nn.Module) -> dict[str, torch.Tensor]:
    """The parameters the optimizer updates, by name, in a fixed order."""
    return {k: p for k, p in model.named_parameters() if p.requires_grad}


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    return Optimizer(cfg)


def create_state(cfg, model: nn.Module, step: int = 0) -> TrainState:
    """A fresh state for ``model`` (its weights as they are) at ``step``,
    with zero moments and the optimizer count equal to ``step``."""
    opt = make_optimizer(cfg.optim).init(model)
    opt.count = step
    return TrainState(step=step, model=model, opt_state=opt)
