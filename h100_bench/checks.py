"""The training check: the reference follows a trainer's first steps, and the
program's first forward, first gradient and parameter change are compared
with its (the gradient and the change by their norms, leaf by leaf)."""

from __future__ import annotations

import contextlib
import math
import statistics

import torch

from h100_bench import weights
from h100_bench.reference import model as ref
from h100_bench.reference import train as ref_train
from h100_bench.reference.augment import TPS


def clone(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (TF32 off) while the reference runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_steps(cfg: dict, w_model: dict, w_vgg: dict, steps: list, seed: int,
                    device) -> dict:
    """The reference trainer through ``steps``, each a batch's (images, sample
    ids). Returns the losses, the first step's forward outputs, the first
    gradient as Adam got it, and the parameters before and after."""
    with no_tf32():
        net = ref.PartNet(cfg["model"], remat=True).to(device)
        weights.load(net, w_model)
        vgg = ref_train.VGG19(cfg["loss"]["vgg_layers"], cfg["loss"]["vgg_trim_blocks"]).to(device)
        weights.load(vgg, w_vgg)
        vgg.requires_grad_(False)
        tps = TPS(cfg["augment"], device)
        params = dict(net.named_parameters())
        p0 = clone(params)
        adam = ref_train.Adam(cfg["optim"], params)
        losses, g1, first = [], None, {}
        for i, (images, ids) in enumerate(steps):
            loss = ref_train.loss_fn(net, vgg, tps, cfg, images, seed, i, ids,
                                     first if i == 0 else {})
            gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), gs)}
            adam.update(params, grads)
            if i == 0:
                g1 = {k: v / (1.0 - cfg["optim"]["b1"]) for k, v in clone(adam.mu).items()}
            losses.append(float(loss.detach()))
    return {"losses": losses, "g1": g1, "p0": p0, "p_end": clone(params), "first": first}


def leaf_gaps(prog: dict, refd: dict, keys) -> dict:
    """Each leaf's |‖prog‖ − ‖ref‖| ÷ max(‖ref leaf‖, median ‖ref leaf‖)."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(refd[k].double())) for k in keys}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys}


def forward_gaps(prog: dict, want: dict) -> dict:
    """The first step's forward against the reference's: the reconstruction's
    root mean square error and the landmarks' widest error (infinite where the
    program's forward was not read)."""
    if not prog:
        return {"recon_rmse": math.inf, "landmark_err": math.inf}
    diff = prog["recon"].float() - want["recon"]
    return {"recon_rmse": float(diff.square().mean().sqrt()),
            "landmark_err": float((prog["mu_a"].float() - want["mu_a"]).abs().max())}


def train_gaps(prog: dict, want: dict) -> dict:
    """The first step's forward (``forward_gaps``); grad_gap: the first
    gradient's worst leaf; update_gap: the change's worst leaf, over the leaves
    whose reference gradient is at least a thousandth of the median leaf's (the
    others move under Adam by round-off alone); loss_gap: the worst step's
    |loss − ref| ÷ |ref|."""
    keys = list(want["g1"])
    gnorm = {k: float(torch.linalg.vector_norm(want["g1"][k].double())) for k in keys}
    moved = [k for k in keys if gnorm[k] >= 1e-3 * statistics.median(gnorm.values())]
    d_prog = {k: prog["p_end"][k] - prog["p0"][k] for k in moved}
    d_ref = {k: want["p_end"][k] - want["p0"][k] for k in moved}
    return {
        **forward_gaps(prog["first"], want["first"]),
        "grad_gap": max(leaf_gaps(prog["g1"], want["g1"], keys).values()),
        "update_gap": max(leaf_gaps(d_prog, d_ref, moved).values()),
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], want["losses"])),
    }
