"""The plain reference of one spatially sharded training step (2 data shards
× 2 space ranks), composed from the unsharded reference (``model.py``,
``train.py``): each data shard's loss and gradient are computed whole, on
the shard's own images, and the shards' gradients averaged before the clip
and Adam. Float32, TF32 off (the caller's ``checks.no_tf32``), no kernel.

Splitting a shard's image rows over space ranks changes nothing here: a
sharded step is exact against the unsharded one, so its reference is the
unsharded step of each data shard.

Departures from the published description (Lorenz et al., CVPR 2019), each
the program's and the benchmark's own:

- 256 px images (the paper trains CelebA at 128 px), with the VGG-19 inputs
  pooled to 128² (``vgg_resolution``) and its weights seeded random;
- data parallel over shards: the step's gradient is the mean of the data
  shards' gradients, its loss the mean of their losses, and the
  appearance-swap term rolls the appearance within a shard;
- the reference's own: the encoders and the decoder are recomputed in the
  backward (``torch.utils.checkpoint``), which changes no number.

``reference_steps`` can run a subset of the shards on each of several
processes: ``shards`` names this process's, and ``reduce`` (a sum over the
processes, given a list of tensors) joins their losses and gradients before
each update; every process then holds the same parameters.
"""

from __future__ import annotations

import torch

from h100_bench import weights
from h100_bench.reference import model as ref
from h100_bench.reference import train as ref_train
from h100_bench.reference.augment import TPS


def _clone(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


def reference_steps(cfg: dict, w_model: dict, w_vgg: dict, steps: list, seed: int, device,
                    n_data: int, shards=None, reduce=None) -> dict:
    """The 2 × 2 step's reference through ``steps``, each a global batch's
    (images [B, S, S, 3], sample ids [B]) split into ``n_data`` shards of
    B / n_data rows. Returns the losses (the mean over shards), the first
    step's forward on shard 0 where this process runs it (``first``: its
    reconstruction and landmarks), the first gradient as Adam got it, and the
    parameters before and after."""
    shards = range(n_data) if shards is None else shards
    net = ref.PartNet(cfg["model"], remat=True).to(device)
    weights.load(net, w_model)
    vgg = ref_train.VGG19(cfg["loss"]["vgg_layers"], cfg["loss"]["vgg_trim_blocks"]).to(device)
    weights.load(vgg, w_vgg)
    vgg.requires_grad_(False)
    tps = TPS(cfg["augment"], device)
    params = dict(net.named_parameters())
    p0 = _clone(params)
    adam = ref_train.Adam(cfg["optim"], params)
    losses, g1, first = [], None, {}
    for i, (images, ids) in enumerate(steps):
        b = images.shape[0] // n_data
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss = torch.zeros((), device=device)
        for d in shards:
            rows = slice(d * b, (d + 1) * b)
            out = first if (i == 0 and d == 0) else None
            l_d = ref_train.loss_fn(net, vgg, tps, cfg, images[rows], seed, i, ids[rows], out)
            gs = torch.autograd.grad(l_d, list(params.values()), allow_unused=True)
            for (k, _), g in zip(params.items(), gs):
                if g is not None:
                    grads[k] += g
            loss += l_d.detach()
            del l_d, gs
        if reduce is not None:
            summed = reduce([loss] + list(grads.values()))
            loss, grads = summed[0], dict(zip(grads, summed[1:]))
        grads = {k: g / n_data for k, g in grads.items()}
        adam.update(params, grads)
        if i == 0:
            g1 = {k: v / (1.0 - cfg["optim"]["b1"]) for k, v in _clone(adam.mu).items()}
        losses.append(float(loss) / n_data)
    return {"losses": losses, "g1": g1, "p0": p0, "p_end": _clone(params), "first": first}
