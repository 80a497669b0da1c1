"""FLOPs of the cell's work, counted by ``torch.utils.flop_counter`` over the
benchmark's own reference at batch 1 (every counted op is linear in the
batch): the forward for serving, the forward and backward of the loss for a
training step. The count is of the work, whatever implements it in the
program, and counts no recomputation.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench.reference import model as ref
from h100_bench.reference import train as ref_train
from h100_bench.reference.augment import TPS


def per_image(cfg: dict, entry: str, device="cpu") -> float:
    """FLOPs per image of ``entry`` ("infer", "transfer" or "train")."""
    m = cfg["model"]
    net = ref.PartNet(m).to(device)
    s = m["img_size"]
    x = torch.rand((1, s, s, 3), device=device)
    counter = FlopCounterMode(display=False)
    if entry == "train":
        lw = cfg["loss"]
        vgg = ref_train.VGG19(lw["vgg_layers"], lw["vgg_trim_blocks"]).to(device).requires_grad_(False)
        tps = TPS(cfg["augment"], device)
        params = [p for p in net.parameters()]
        with counter:
            loss = ref_train.loss_fn(net, vgg, tps, cfg, x, 0, 0, np.arange(1))
            torch.autograd.grad(loss, params, allow_unused=True)
    else:
        with counter, torch.no_grad():
            if entry == "infer":
                ref.infer(net, x)
            elif entry == "transfer":
                ref.transfer(net, x, x)
            else:
                raise ValueError(f"unknown entry {entry!r}")
    return float(counter.get_total_flops())
