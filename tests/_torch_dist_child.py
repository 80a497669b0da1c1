"""One rank of the port's multi-process CPU tests (not a pytest file).

    python tests/_torch_dist_child.py <mode> <rank> <world> <init file> <inputs.npz> <out dir>

Joins a gloo process group through ``file://<init file>``, reads its
inputs from the npz the parent test wrote, runs ``mode`` and writes
``<out dir>/rank<r>.npz``. It imports only the port (no JAX): the tests
compare what it writes with the JAX package in their own process.

Modes:
  dp      — the data-parallel step: each rank its shard of the batch and
            of the injected draws, gradients averaged over the ranks;
            also the broadcast of rank 0's weights.
  blocks  — every spatial building block on the rank's row shard, the
            sharded encoders, and the gradients of a loss through them.
  spatial — the spatial step on a 2 data × 2 space mesh, without and with
            the swap loss, and the 2-rank data-parallel step of ranks 0
            and 2 (one per data shard) with the swap loss.
  bench   — ``train.loop.build_step_fn``'s spatial step on a mesh of
            ``space`` ranks a data shard, from a configuration of the
            benchmark's form and its seeded weights (``h100_bench``), once
            as it is and once with the benchmark's ``no_halo`` fault
            planted; under a CPU profiler where ``profile`` is set, with
            the span registry's snapshot.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from partseg_tpu_torch.augment import AugmentConfig, ColorParams, PairDraws, TPSParams  # noqa: E402
from partseg_tpu_torch.dist import broadcast_parameters, make_mesh, make_spatial_mesh  # noqa: E402
from partseg_tpu_torch.losses import PerceptualLoss, VGG19Features  # noqa: E402
from partseg_tpu_torch.models.encoders import AppearanceEncoder, ShapeEncoder  # noqa: E402
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights  # noqa: E402
from partseg_tpu_torch.parallel import (  # noqa: E402
    halo_exchange,
    sharded_pool_appearance,
    sharded_render_gaussians,
    sharded_soft_argmax_moments,
    sharded_spatial_conv,
    sharded_spatial_softmax,
)
from partseg_tpu_torch.parallel.spatial_model import (  # noqa: E402
    sharded_appearance_encoder,
    sharded_group_norm,
    sharded_shape_encoder,
)
from partseg_tpu_torch.parallel.spatial_train import (  # noqa: E402
    _sharded_stats,
    make_spatial_train_step,
)
from partseg_tpu_torch.models.blocks import GroupNorm  # noqa: E402
from partseg_tpu_torch.train import (  # noqa: E402
    LossConfig,
    OptimConfig,
    TrainConfig,
    create_state,
    make_train_step,
)


# ------------------------------------------------------------------ inputs


def config_to_json(cfg: TrainConfig) -> str:
    d = dataclasses.asdict(cfg)
    d["model"]["dtype"] = str(cfg.model.dtype).split(".")[-1]
    return json.dumps(d)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config_from_json(text: str) -> TrainConfig:
    d = {k: _tuples(v) for k, v in json.loads(text).items()}
    m = {k: _tuples(v) for k, v in d.pop("model").items()}
    m["dtype"] = getattr(torch, m["dtype"])
    sections = {name: {k: _tuples(v) for k, v in d.pop(name).items()}
                for name in ("augment", "loss", "optim")}
    return TrainConfig(model=PartNetConfig(**m), augment=AugmentConfig(**sections["augment"]),
                       loss=LossConfig(**sections["loss"]), optim=OptimConfig(**sections["optim"]),
                       **d)


def state_dict_from(arrays, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(arrays[k]) for k in arrays.files
            if k.startswith(prefix)}


def draws_from(arrays, prefix: str, sl: slice) -> PairDraws:
    """The injected draws of samples ``sl``."""
    def a(name):
        return torch.from_numpy(np.array(arrays[prefix + name][sl]))

    return PairDraws(TPSParams(a("tps")),
                     ColorParams(a("brightness"), a("contrast"), a("saturation"), a("hue")))


def build(arrays, tag: str):
    """(cfg, model, sampler, perceptual) from the parent's config and weights."""
    cfg = config_from_json(str(arrays[f"{tag}config"]))
    model = PartNet(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from(arrays, f"{tag}w/"))
    vgg = VGG19Features(cfg.loss.vgg_layers, cfg.loss.vgg_trim_blocks, dtype=cfg.model.dtype)
    vgg.load_state_dict(state_dict_from(arrays, f"{tag}vgg/"))
    perc = PerceptualLoss(vgg, cfg.loss.vgg_layer_weights, cfg.loss.pixel_weight,
                          cfg.loss.vgg_resolution)
    return cfg, model, cfg.augment.make_sampler(), perc


def step_outputs(prefix: str, state, metrics) -> dict:
    out = {f"{prefix}metric/{k}": v.numpy() for k, v in metrics.items()}
    out.update({f"{prefix}param/{k}": v.numpy() for k, v in state.model.state_dict().items()})
    out.update({f"{prefix}mu/{k}": v.numpy() for k, v in state.opt_state.mu.items()})
    return out


# ------------------------------------------------------------------ modes


def run_dp(arrays, rank: int, world: int) -> dict:
    out = {}
    # create_replicated: a different init per rank, then rank 0's broadcast.
    probe = init_weights(PartNet(config_from_json(str(arrays["config"])).model, device="cpu"),
                         seed=rank)
    broadcast_parameters(probe)
    ref = init_weights(PartNet(probe.cfg, device="cpu"), seed=0).state_dict()
    out["broadcast_max_diff"] = np.float32(max(
        (v - ref[k]).abs().max().item() for k, v in probe.state_dict().items()))

    cfg, model, sampler, perc = build(arrays, "")
    mesh = make_mesh()
    b = cfg.global_batch // mesh.n_data
    sl = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    state = create_state(cfg, model, step=int(arrays["start"]))
    step = make_train_step(cfg, model, sampler, perc, warp_on=True, group=mesh.data_group)
    batch = {"image": torch.from_numpy(arrays["images"][sl]), "aug_id": arrays["aug_id"][sl]}
    state, metrics = step(state, batch, draws=draws_from(arrays, "draws/", sl))
    out.update(step_outputs("", state, metrics))
    return out


def _rows(x: np.ndarray, rank: int, n: int, dim: int = 1) -> torch.Tensor:
    h = x.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(np.take(x, range(rank * h, (rank + 1) * h),
                                                         axis=dim)))


K_DIVIDE = 2          # the divide case's parts: the first 2 of the 3 logit channels
ENCODER_CASES = json.loads("""{
  "block": {"kind": "shape", "depth": 2, "norm": "block", "stem_stride": 2},
  "group": {"kind": "shape", "depth": 2, "norm": "group", "stem_stride": 2},
  "none": {"kind": "shape", "depth": 2, "norm": "none", "stem_stride": 2},
  "stem4": {"kind": "shape", "depth": 1, "norm": "block", "stem_stride": 4},
  "upsample": {"kind": "shape", "depth": 1, "norm": "block", "stem_stride": 4,
               "head_upsample": true},
  "app_upsample": {"kind": "app", "depth": 1, "norm": "block", "stem_stride": 4,
                   "head_upsample": true}
}""")


def encoder(case: dict) -> torch.nn.Module:
    """The port encoder of an ENCODER_CASES entry (features 16, K = 3 + bg,
    or 8 appearance features), f32."""
    kw = dict(depth=case["depth"], features=16, norm=case["norm"],
              stem_stride=case["stem_stride"], head_upsample=case.get("head_upsample", False),
              dtype=torch.float32)
    if case["kind"] == "shape":
        return ShapeEncoder(n_parts=3, background=True, n_stacks=1, **kw)
    return AppearanceEncoder(out_features=8, **kw)


def run_blocks(arrays, rank: int, world: int) -> dict:
    g = dist.group.WORLD
    a = {k: arrays[k] for k in arrays.files}
    h_glob = a["x"].shape[1]
    hs = h_glob // world
    out = {}
    x = _rows(a["x"], rank, world)
    out["halo"] = halo_exchange(x, 1, g).numpy()
    out["conv"] = sharded_spatial_conv(x, torch.from_numpy(a["conv_weight"]), g).numpy()
    out["softmax"] = sharded_spatial_softmax(_rows(a["logits"], rank, world), g).numpy()
    mu, sigma = sharded_soft_argmax_moments(_rows(a["p"], rank, world), h_glob, g)
    out["mu"], out["sigma"] = mu.numpy(), sigma.numpy()
    out["render"] = sharded_render_gaussians(torch.from_numpy(a["render_mu"]), torch.from_numpy(
        a["render_sigma"]), h_glob, a["x"].shape[2], hs, g).numpy()
    out["pool"] = sharded_pool_appearance(_rows(a["feats"], rank, world),
                                          _rows(a["parts"], rank, world), g).numpy()
    head_w = torch.from_numpy(a["head_weight"])
    logits = sharded_spatial_conv(x, head_w, g)
    mu, sig = sharded_soft_argmax_moments(sharded_spatial_softmax(logits, g), h_glob, g)
    out["head"] = sharded_render_gaussians(mu, sig, h_glob, a["x"].shape[2], hs, g).numpy()

    # GroupNorm over the group, forward and the input's and affine gradients.
    gn = GroupNorm(4, 8)
    gn.load_state_dict(state_dict_from(arrays, "gn/"))
    xg = _rows(a["gn_x"], rank, world, dim=2).requires_grad_(True)
    y = sharded_group_norm(xg, gn, g)
    gy = _rows(a["gn_gy"], rank, world, dim=2)
    dx, dw, db = torch.autograd.grad(y, [xg, gn.weight, gn.bias], gy)
    out.update({"gn_y": y.detach().numpy(), "gn_dx": dx.numpy(), "gn_dw": dw.numpy(),
                "gn_db": db.numpy()})

    ex = _rows(a["enc_x"], rank, world)
    for name, case in ENCODER_CASES.items():
        enc = encoder(case)
        enc.load_state_dict(state_dict_from(arrays, f"enc/{name}/"))
        fn = sharded_shape_encoder if case["kind"] == "shape" else sharded_appearance_encoder
        with torch.no_grad():
            out[f"enc/{name}"] = fn(enc, ex, g).numpy()

    # Gradients through the sharded shape encoder, the global softmax and
    # the moments: a loss on the replicated μ and a row-local one.
    enc = encoder(ENCODER_CASES["block"])
    enc.load_state_dict(state_dict_from(arrays, "enc/block/"))
    lg = sharded_shape_encoder(enc, ex, g)
    p = sharded_spatial_softmax(lg[..., :3], g)
    mu, _ = sharded_soft_argmax_moments(p, lg.shape[1] * world, g)
    wts = _rows(a["grad_weights"], rank, world)
    from partseg_tpu_torch.parallel import group_sum

    loss = (mu ** 2).sum() + group_sum((lg * wts).sum().reshape(1), g)[0]
    grads = torch.autograd.grad(loss, list(enc.parameters()))
    out.update({f"grad/{k}": v.numpy() for (k, _), v in zip(enc.named_parameters(), grads)})
    out["grad_loss"] = loss.detach().numpy()
    # The same with remat: the hourglass recomputed in the backward, its
    # collectives repeated in the same order on every rank.
    enc.remat = True
    lg = sharded_shape_encoder(enc.train(), ex, g)
    mu, _ = sharded_soft_argmax_moments(sharded_spatial_softmax(lg[..., :3], g),
                                        lg.shape[1] * world, g)
    loss = (mu ** 2).sum() + group_sum((lg * wts).sum().reshape(1), g)[0]
    grads = torch.autograd.grad(loss, list(enc.parameters()))
    out.update({f"remat_grad/{k}": v.numpy() for (k, _), v in zip(enc.named_parameters(), grads)})

    # spatial_norm="divide": softplus maps over their global sum, moments.
    cfg = PartNetConfig(n_parts=K_DIVIDE, spatial_norm="divide")
    parts, mu, sigma = _sharded_stats(_rows(a["logits"], rank, world), cfg, h_glob, g)
    out.update({"divide_parts": parts.numpy(), "divide_mu": mu.numpy(),
                "divide_sigma": sigma.numpy()})
    return out


def run_spatial(arrays, rank: int, world: int) -> dict:
    out = {}
    mesh = make_spatial_mesh(2)
    images = arrays["images"]
    b = images.shape[0] // mesh.n_data
    sl = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    h = images.shape[1] // mesh.space
    rows = torch.from_numpy(np.ascontiguousarray(
        images[sl, mesh.space_index * h:(mesh.space_index + 1) * h]))
    for tag in ("plain/", "swap/"):
        cfg, model, sampler, perc = build(arrays, tag)
        state = create_state(cfg, model, step=int(arrays["start"]))
        step = make_spatial_train_step(cfg, model, sampler, perc, mesh)
        state, metrics = step(state, {"image": rows, "aug_id": arrays["aug_id"][sl]},
                              draws=draws_from(arrays, "draws/", sl))
        out.update(step_outputs(tag, state, metrics))

    # The 2-rank data-parallel step: ranks 0 and 2, one per data shard.
    dp = dist.new_group([0, 2])
    if mesh.space_index == 0:
        cfg, model, sampler, perc = build(arrays, "swap/")
        state = create_state(cfg, model, step=int(arrays["start"]))
        step = make_train_step(cfg, model, sampler, perc, group=dp)
        state, metrics = step(state, {"image": torch.from_numpy(images[sl]),
                                      "aug_id": arrays["aug_id"][sl]},
                              draws=draws_from(arrays, "draws/", sl))
        out.update(step_outputs("dp/", state, metrics))
    return out


def run_bench(arrays, rank: int, world: int) -> dict:
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile

    from h100_bench import program, weights
    from h100_bench.drivers.spatial_train import no_halo
    from partseg_tpu_torch import tracing
    from partseg_tpu_torch.train import build_perceptual
    from partseg_tpu_torch.train.loop import build_step_fn

    cfg, seed = json.loads(str(arrays["config"])), int(arrays["seed"])
    tc = dataclasses.replace(program.train_config(cfg, "program"), space_shards=int(arrays["space"]))
    mesh = make_spatial_mesh(tc.space_shards)
    images, ids = arrays["images"], arrays["aug_id"]
    b, h = images.shape[0] // mesh.n_data, images.shape[1] // mesh.space
    sl = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    rows = torch.from_numpy(np.ascontiguousarray(
        images[sl, mesh.space_index * h:(mesh.space_index + 1) * h]))
    out = {}
    for tag, fault in (("program/", nullcontext), ("no_halo/", no_halo)):
        model = program.build_model(tc, program.model_weights(cfg, seed, "cpu"), "cpu")
        perceptual = build_perceptual(tc, "cpu")
        weights.load(perceptual.vgg, program.vgg_weights(cfg, seed, "cpu"))
        state = create_state(tc, model)
        step = build_step_fn(tc, model, tc.augment.make_sampler(), perceptual, mesh)
        tracing.reset()
        profiled = profile(activities=[ProfilerActivity.CPU]) if arrays["profile"] else nullcontext()
        with fault(), profiled:
            state, metrics = step(state, ({"image": rows, "aug_id": ids[sl]},), seed)
        out.update(step_outputs(tag, state, metrics))
        snap = tracing.snapshot()
        out[f"{tag}registry"] = np.asarray(json.dumps(
            {"calls": {k: v["calls"] for k, v in snap["spans"].items()},
             "counters": snap["counters"]}))
        if arrays["profile"]:
            break
    return out


MODES = {"dp": run_dp, "blocks": run_blocks, "spatial": run_spatial, "bench": run_bench}


def main() -> None:
    mode, rank, world, init, inputs, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    with np.load(inputs) as arrays:
        out = MODES[mode](arrays, rank, world)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()


def launch(mode: str, world: int, inputs: str, out_dir, timeout: float = 240.0) -> list:
    """Run ``world`` ranks of ``mode`` (this file as a script), joined with
    their own timeout so that a hang fails instead of stalling the suite.
    Returns each rank's output arrays."""
    import os
    import pathlib
    import subprocess

    repo = pathlib.Path(__file__).resolve().parent.parent
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    init = out_dir / "init"
    init.unlink(missing_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(repo) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r), str(world), str(init),
                               str(inputs), str(out_dir)], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [p.returncode for p in procs] + logs
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]
