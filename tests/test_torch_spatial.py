"""Spatial sharding of the port (parallel/spatial*.py, the loop's space
ranks) against the JAX package's sharded ops and the port's unsharded
ones, on the CPU with gloo processes: tests/test_spatial_sharding.py's
cases, each block on 4 space ranks, the full step on 2 data × 2 space.

The ranks are child processes (tests/_torch_dist_child.py) that import
only the port; the JAX references run in this process under shard_map on
the conftest's CPU devices, with the same weights (JAX's init carried
across by ``convert.py``) and inputs.

Tolerances: the blocks those of the JAX test (f32 sums over shards in
another order); gradients through the blocks within 1e-5 of their
largest entry; the full step's loss rtol 2e-5 and its parameters after
one update atol 5e-5 (the JAX test's bounds, at a learning rate of 2e-5
so that a step of either sign on a gradient that is 0 but for rounding
stays within them), and its gradients (Adam's first moments) within 1e-4
of their largest entry.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from partseg_tpu.augment.pair import AugmentConfig as JAugment
from partseg_tpu.models.encoders import AppearanceEncoder as JAppearanceEncoder
from partseg_tpu.models.encoders import ShapeEncoder as JShapeEncoder
from partseg_tpu.models.partnet import PartNetConfig as JModel
from partseg_tpu.parallel import (
    halo_exchange as jax_halo_exchange,
    sharded_pool_appearance as jax_sharded_pool,
    sharded_render_gaussians as jax_sharded_render,
    sharded_soft_argmax_moments as jax_sharded_moments,
    sharded_spatial_conv as jax_sharded_conv,
    sharded_spatial_softmax as jax_sharded_softmax,
)
from partseg_tpu.parallel.spatial_model import (
    sharded_appearance_encoder as jax_sharded_app,
    sharded_shape_encoder as jax_sharded_shape,
)
from partseg_tpu.parallel.spatial_train import build_spatial_step_fn as jax_spatial_step
from partseg_tpu.train import config as jconfig
from partseg_tpu_torch import convert
from partseg_tpu_torch.models.blocks import GroupNorm
from partseg_tpu_torch.models.partnet import PartNet
from partseg_tpu_torch.parallel.spatial_train import sharded_partnet_forward
from partseg_tpu_torch.partops import (
    pool_appearance,
    render_gaussians,
    soft_argmax_moments,
    spatial_softmax,
)
from partseg_tpu_torch.train import create_state
from partseg_tpu_torch.train.step import make_train_step
from _torch_dist_child import ENCODER_CASES, K_DIVIDE, draws_from, encoder, launch
from _torch_dist_jax import KEY, inputs_npz, jax_keyed_draws, jax_moments, jax_setup

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
B, H, W, K, C = 2, 32, 16, 3, 8
SP = 4          # space ranks


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _smap(fn, in_specs, out_specs):
    mesh = JMesh(np.array(jax.devices()[:SP]), ("space",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


ROWS = P(None, "space", None, None)


def _cat(ranks, key, axis=1) -> np.ndarray:
    return np.concatenate([r[key] for r in ranks], axis=axis)


# ------------------------------------------------------------------ blocks


def _jax_encoder(case: dict, key: int, x):
    kw = dict(depth=case["depth"], features=16, norm=case["norm"],
              stem_stride=case["stem_stride"], head_upsample=case.get("head_upsample", False),
              dtype=jnp.float32)
    if case["kind"] == "shape":
        enc = JShapeEncoder(n_parts=3, background=True, n_stacks=1, **kw)
        sharded, root = jax_sharded_shape, "shape_enc"
        skw = dict(n_stacks=1)
    else:
        enc = JAppearanceEncoder(out_features=8, **kw)
        sharded, root = jax_sharded_app, "app_enc"
        skw = {}
    params = enc.init(jax.random.key(key), x)
    skw.update(depth=case["depth"], norm=case["norm"], stem_stride=case["stem_stride"],
               head_upsample=case.get("head_upsample", False))
    got = _smap(lambda xs: sharded(params, xs, **skw), (ROWS,), ROWS)(x)
    return enc.apply(params, x), got, params, root


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    rng = np.random.default_rng(0)
    a = {
        "x": rng.normal(size=(B, H, W, C)).astype(np.float32),
        "conv_weight": (0.1 * rng.normal(size=(5, C, 3, 3))).astype(np.float32),
        "head_weight": (0.2 * rng.normal(size=(K, C, 3, 3))).astype(np.float32),
        "logits": (3.0 * rng.normal(size=(B, H, W, K))).astype(np.float32),
        "render_mu": rng.uniform(-0.5, 0.5, size=(B, K, 2)).astype(np.float32),
        "render_sigma": np.broadcast_to(0.03 * np.eye(2, dtype=np.float32), (B, K, 2, 2)).copy(),
        "feats": rng.normal(size=(B, H, W, C)).astype(np.float32),
        "gn_x": rng.normal(size=(B, 8, H, W)).astype(np.float32) * 2 + 0.5,
        "gn_gy": rng.normal(size=(B, 8, H, W)).astype(np.float32),
        "enc_x": rng.uniform(size=(B, 64, 32, 3)).astype(np.float32),
        "grad_weights": rng.normal(size=(B, 32, 16, 4)).astype(np.float32),
    }
    a["p"] = spatial_softmax(_t(2.0 * rng.normal(size=(B, H, W, K)).astype(np.float32))).numpy()
    a["parts"] = torch.softmax(_t(rng.normal(size=(B, H, W, K)).astype(np.float32)), -1).numpy()
    gn = GroupNorm(4, 8)
    with torch.no_grad():
        gn.weight.copy_(_t(rng.normal(size=8).astype(np.float32)))
        gn.bias.copy_(_t(rng.normal(size=8).astype(np.float32)))
    a.update({f"gn/{k}": v.numpy() for k, v in gn.state_dict().items()})

    ref = {}          # name → (JAX unsharded or Flax, JAX sharded)
    ex = jnp.asarray(a["enc_x"])
    for i, (name, case) in enumerate(ENCODER_CASES.items()):
        want, jgot, params, root = _jax_encoder(case, 50 + i, ex)
        enc = convert.load_flax_params(encoder(case), jax.tree_util.tree_map(np.asarray, params),
                                       root=root)
        a.update({f"enc/{name}/{k}": v.numpy() for k, v in enc.state_dict().items()})
        with torch.no_grad():
            port = enc(_t(a["enc_x"])).numpy()
        ref[f"enc/{name}"] = (np.asarray(want), np.asarray(jgot), port)

    tmp = tmp_path_factory.mktemp("blocks")
    np.savez(tmp / "inputs.npz", **a)
    ranks = launch("blocks", SP, tmp / "inputs.npz", tmp)
    return dict(a=a, ranks=ranks, ref=ref, gn=gn)


def test_halo_exchange_gives_neighbour_rows_and_zero_edges(blocks):
    a, ranks = blocks["a"], blocks["ranks"]
    hs = H // SP
    jgot = _smap(lambda x: jax_halo_exchange(x, 1), (ROWS,), ROWS)(jnp.asarray(a["x"]))
    jslabs = np.asarray(jgot).reshape(B, SP, hs + 2, W, C)
    padded = np.pad(a["x"], ((0, 0), (1, 1), (0, 0), (0, 0)))
    for r in range(SP):
        np.testing.assert_array_equal(ranks[r]["halo"], padded[:, r * hs:r * hs + hs + 2])
        np.testing.assert_array_equal(ranks[r]["halo"], jslabs[:, r])


def test_sharded_conv_matches_the_global_same_conv(blocks):
    a = blocks["a"]
    got = _cat(blocks["ranks"], "conv")
    want = F.conv2d(_t(a["x"]).permute(0, 3, 1, 2), _t(a["conv_weight"]),
                    padding=1).permute(0, 2, 3, 1).numpy()
    kern = jnp.asarray(a["conv_weight"].transpose(2, 3, 1, 0))
    jgot = _smap(lambda x: jax_sharded_conv(x, kern), (ROWS,), ROWS)(jnp.asarray(a["x"]))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jgot), atol=1e-5)


def test_sharded_spatial_softmax_is_the_global_softmax(blocks):
    a = blocks["a"]
    got = _cat(blocks["ranks"], "softmax")
    np.testing.assert_allclose(got, spatial_softmax(_t(a["logits"])).numpy(), atol=1e-6)
    jgot = _smap(jax_sharded_softmax, (ROWS,), ROWS)(jnp.asarray(a["logits"]))
    np.testing.assert_allclose(got, np.asarray(jgot), atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, atol=1e-5)


def test_sharded_moments_match(blocks):
    a, ranks = blocks["a"], blocks["ranks"]
    mu, sigma = soft_argmax_moments(_t(a["p"]))
    jmu, jsig = _smap(lambda p: jax_sharded_moments(p, h_global=H), (ROWS,),
                      (P(), P()))(jnp.asarray(a["p"]))
    for r in ranks:
        np.testing.assert_allclose(r["mu"], mu.numpy(), atol=1e-5)
        np.testing.assert_allclose(r["sigma"], sigma.numpy(), atol=1e-5)
        np.testing.assert_allclose(r["mu"], np.asarray(jmu), atol=1e-5)
        np.testing.assert_allclose(r["sigma"], np.asarray(jsig), atol=1e-5)


def test_sharded_render_matches(blocks):
    a = blocks["a"]
    got = _cat(blocks["ranks"], "render")
    want = render_gaussians(_t(a["render_mu"]), _t(a["render_sigma"]), H, W).numpy()
    jgot = _smap(lambda m, s: jax_sharded_render(m, s, h_global=H, w=W, h_local=H // SP),
                 (P(), P()), ROWS)(jnp.asarray(a["render_mu"]), jnp.asarray(a["render_sigma"]))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jgot), atol=1e-6)


def test_sharded_pooling_matches(blocks):
    a = blocks["a"]
    want = pool_appearance(_t(a["feats"]), _t(a["parts"])).numpy()
    jgot = _smap(jax_sharded_pool, (ROWS, ROWS), P())(jnp.asarray(a["feats"]),
                                                      jnp.asarray(a["parts"]))
    for r in blocks["ranks"]:
        np.testing.assert_allclose(r["pool"], want, atol=1e-6)
        np.testing.assert_allclose(r["pool"], np.asarray(jgot), atol=1e-6)


def test_end_to_end_shape_head_sharded(blocks):
    """conv → spatial softmax → moments → render, all on row shards."""
    a = blocks["a"]
    x = _t(a["x"])
    logits = F.conv2d(x.permute(0, 3, 1, 2), _t(a["head_weight"]), padding=1).permute(0, 2, 3, 1)
    mu, sig = soft_argmax_moments(spatial_softmax(logits))
    want = render_gaussians(mu, sig, H, W).numpy()
    np.testing.assert_allclose(_cat(blocks["ranks"], "head"), want, atol=1e-4)


def test_sharded_group_norm_and_its_gradients(blocks):
    """GroupNorm with statistics over the ranks' rows against the module,
    and its backward (the input's rows, Σ over ranks of the affine
    parameters' gradients) against autograd through the module."""
    a, ranks, gn = blocks["a"], blocks["ranks"], blocks["gn"]
    x = _t(a["gn_x"]).requires_grad_(True)
    y = gn(x)
    dx, dw, db = torch.autograd.grad(y, [x, gn.weight, gn.bias], _t(a["gn_gy"]))
    np.testing.assert_allclose(_cat(ranks, "gn_y", 2), y.detach().numpy(), atol=2e-5)
    np.testing.assert_allclose(_cat(ranks, "gn_dx", 2), dx.numpy(), atol=2e-5)
    np.testing.assert_allclose(sum(r["gn_dw"] for r in ranks), dw.numpy(), atol=1e-3)
    np.testing.assert_allclose(sum(r["gn_db"] for r in ranks), db.numpy(), atol=1e-3)


@pytest.mark.parametrize("name", list(ENCODER_CASES))
def test_sharded_encoder_matches(blocks, name):
    """The whole encoder on row shards (every norm mode, stem_stride 4,
    head_upsample for both encoders) against the Flax forward, JAX's
    sharded forward and the port's module."""
    want, jgot, port = blocks["ref"][f"enc/{name}"]
    got = _cat(blocks["ranks"], f"enc/{name}")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, jgot, atol=2e-4)
    np.testing.assert_allclose(got, port, atol=2e-4)


def test_gradients_through_the_sharded_encoder_sum_to_the_unsharded(blocks):
    """A loss of the replicated μ and of the logits' rows: the ranks'
    parameter gradients, summed and divided by the ranks (each collective's
    backward its adjoint, parallel/spatial.py), equal autograd through the
    unsharded encoder, softmax and moments."""
    a, ranks = blocks["a"], blocks["ranks"]
    enc = encoder(ENCODER_CASES["block"])
    enc.load_state_dict({k[len("enc/block/"):]: _t(v) for k, v in a.items()
                         if k.startswith("enc/block/")})
    lg = enc(_t(a["enc_x"]))
    mu, _ = soft_argmax_moments(spatial_softmax(lg[..., :3]))
    loss = (mu ** 2).sum() + (lg * _t(a["grad_weights"])).sum()
    grads = torch.autograd.grad(loss, list(enc.parameters()))
    for r in ranks:
        np.testing.assert_allclose(r["grad_loss"], loss.item(), rtol=1e-5)
    scale = max(g.abs().max().item() for g in grads)
    for (k, _), g in zip(enc.named_parameters(), grads):
        got = sum(r[f"grad/{k}"] for r in ranks) / SP
        np.testing.assert_allclose(got, g.numpy(), rtol=0, atol=1e-5 * scale, err_msg=k)


def test_remat_gives_the_same_sharded_gradients(blocks):
    """With remat the hourglass is recomputed in the backward, its
    collectives again: the ranks' gradients equal those without, bit for
    bit."""
    for r in blocks["ranks"]:
        for k in r:
            if k.startswith("grad/"):
                np.testing.assert_array_equal(r["remat_" + k], r[k], err_msg=k)


def test_sharded_divide_normalisation_matches(blocks):
    """spatial_norm="divide": softplus maps over their global sum (the
    first K_DIVIDE logit channels, the rest a background), and their
    moments, against the port's unsharded shape_stats."""
    from partseg_tpu_torch.partops.softmax import normalize_maps

    a, ranks = blocks["a"], blocks["ranks"]
    fg = _t(a["logits"])[..., :K_DIVIDE]
    parts = normalize_maps(F.softplus(fg))
    mu, sigma = soft_argmax_moments(parts)
    np.testing.assert_allclose(_cat(ranks, "divide_parts"), parts.numpy(), rtol=1e-5, atol=1e-9)
    for r in ranks:
        np.testing.assert_allclose(r["divide_mu"], mu.numpy(), atol=1e-5)
        np.testing.assert_allclose(r["divide_sigma"], sigma.numpy(), atol=1e-5)


def test_spatial_forward_refuses_act_quant():
    from partseg_tpu_torch.models.partnet import PartNetConfig

    cfg = PartNetConfig(n_parts=3, img_size=32, features=16, depth=1, act_quant="f8")
    with pytest.raises(ValueError, match="act_quant"):
        sharded_partnet_forward(PartNet(cfg, device="cpu"), None, None, None)


# ------------------------------------------------------------------ the step

START = 1
LR = 2e-5           # 2e-4 · 1/10 under the 10-step warmup


def spatial_jax_config(swap_weight: float):
    """tests/test_spatial_sharding.py's config, with a learning rate above 0
    at START."""
    return jconfig.TrainConfig(
        model=JModel(n_parts=3, img_size=32, features=16, depth=1, app_features=8,
                     decoder_scales=2, decoder_features=(16, 8), dtype=jnp.float32),
        augment=JAugment(tps_grid=3, warp_impl="gather"),
        loss=jconfig.LossConfig(vgg_layers=("relu1_2",), vgg_trim_blocks=1,
                                swap_weight=swap_weight),
        optim=jconfig.OptimConfig(lr=2e-4, warmup_steps=10, decay_steps=100),
        global_batch=4,
    )


@pytest.fixture(scope="module")
def spatial_run(tmp_path_factory):
    """JAX's spatial step on a (2 data × 2 space) mesh, the port's on 2 × 2
    ranks (without and with the swap loss), and the port's 2-rank
    data-parallel step with the swap loss."""
    imgs = np.asarray(jax.random.uniform(jax.random.key(1), (4, 32, 32, 3)))
    aug = np.arange(4, dtype=np.int32)
    arrays = {"images": imgs, "aug_id": aug, "start": np.asarray(START)}
    out = {}
    for tag, swap in (("plain/", 0.0), ("swap/", 0.5)):
        jcfg = spatial_jax_config(swap)
        s = jax_setup(jcfg, START)
        arrays.update(inputs_npz(s, tag))
        out[tag] = s
    jcfg = spatial_jax_config(0.0)
    s = out["plain/"]
    draws = jax_keyed_draws(jcfg, s["jsampler"], START, aug)
    arrays.update({f"draws/{k}": v for k, v in draws.items()})
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "space"))
    step = jax_spatial_step(jcfg, s["jsampler"], s["jperc"], mesh)
    jnew, jmetrics = jax.device_get(step(
        jax.device_put(s["jstate"], NamedSharding(mesh, P())),
        {"image": jax.device_put(imgs, NamedSharding(mesh, P("data", "space"))),
         "aug_id": jax.device_put(aug, NamedSharding(mesh, P("data")))},
        jax.random.key(KEY)))
    tmp = tmp_path_factory.mktemp("spatial")
    np.savez(tmp / "inputs.npz", **arrays)
    ranks = launch("spatial", 4, tmp / "inputs.npz", tmp, timeout=300)
    return dict(ranks=ranks, jstate=jnew, jmetrics=jmetrics, setups=out, imgs=imgs,
                draws=draws)


def _unsharded(run, tag: str):
    """The port's one-process step on the whole batch of 4."""
    s = run["setups"][tag]
    pcfg = s["pcfg"]
    from partseg_tpu_torch.losses import PerceptualLoss, VGG19Features

    vgg = VGG19Features(pcfg.loss.vgg_layers, pcfg.loss.vgg_trim_blocks, torch.float32)
    vgg.load_state_dict(s["vgg"])
    model = PartNet(pcfg.model, device="cpu")
    model.load_state_dict(s["weights"])
    state = create_state(pcfg, model, step=START)
    step = make_train_step(pcfg, model, pcfg.augment.make_sampler(),
                           PerceptualLoss(vgg, feature_resolution=pcfg.loss.vgg_resolution))
    draws = {f"draws/{k}": v for k, v in run["draws"].items()}
    return step(state, {"image": _t(run["imgs"])}, draws=draws_from(draws, "draws/", slice(None)))


def test_spatial_step_matches_jax_spatial_step(spatial_run):
    """Every rank against JAX's (2 × 2) spatial step: the loss and the
    other metrics rtol 2e-5, the parameters after one update atol 5e-5,
    the gradients' direction (first moments over their largest entry)
    within 1e-4. JAX's gradients are space_shards times the data shard's
    (ROADMAP Queue 3: its psum over space of gradients that are already
    whole), so its grad_norm is 2× the port's, which equals the unsharded
    step's (the next test)."""
    jm, jstate = spatial_run["jmetrics"], spatial_run["jstate"]
    want_mu = jax_moments(jstate)
    want_scale = max(v.abs().max().item() for v in want_mu.values())
    params = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for r in spatial_run["ranks"]:
        for k, v in jm.items():
            if k != "grad_norm":
                np.testing.assert_allclose(r[f"plain/metric/{k}"], np.asarray(v), rtol=2e-5,
                                           err_msg=k)
        np.testing.assert_allclose(2 * r["plain/metric/grad_norm"], jm["grad_norm"], rtol=2e-5)
        for k, v in params.items():
            np.testing.assert_allclose(r[f"plain/param/{k}"], v.numpy(), atol=5e-5, err_msg=k)
        scale = max(np.abs(r[f"plain/mu/{k}"]).max() for k in want_mu)
        for k, v in want_mu.items():
            np.testing.assert_allclose(r[f"plain/mu/{k}"] / scale, v.numpy() / want_scale,
                                       atol=1e-4, err_msg=k)


def test_spatial_step_matches_the_unsharded_step(spatial_run):
    """Against the port's one-process step on the whole batch: the loss
    rtol 2e-5, every parameter after one update atol 5e-5, the gradients
    (first moments) within 1e-4 of the largest, grad_norm rtol 2e-5."""
    state, metrics = _unsharded(spatial_run, "plain/")
    mu = state.opt_state.mu
    scale = max(v.abs().max().item() for v in mu.values())
    for r in spatial_run["ranks"]:
        for k in ("loss", "grad_norm", "rec", "equiv", "seg"):
            np.testing.assert_allclose(r[f"plain/metric/{k}"], metrics[k].numpy(), rtol=2e-5,
                                       err_msg=k)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(r[f"plain/param/{k}"], v.numpy(), atol=5e-5, err_msg=k)
        for k, v in mu.items():
            np.testing.assert_allclose(r[f"plain/mu/{k}"], v.numpy(), atol=1e-4 * scale,
                                       err_msg=k)


def test_spatial_swap_round_matches_the_two_rank_dp_step(spatial_run):
    """tests/test_spatial_sharding.py:296: with the swap loss, the (2 × 2)
    step rolls the appearance within each data shard, so its swap term and
    loss equal the 2-rank data-parallel step's (ranks 0 and 2), rtol 2e-5;
    so do its gradients, within 1e-4 of the largest."""
    ranks = spatial_run["ranks"]
    dp = ranks[0]
    assert "dp/metric/swap" in dp and "dp/metric/swap" in ranks[2]
    mus = [k for k in dp if k.startswith("dp/mu/")]
    scale = max(np.abs(dp[k]).max() for k in mus)
    for r in ranks:
        for k in ("swap", "loss", "grad_norm"):
            np.testing.assert_allclose(r[f"swap/metric/{k}"], dp[f"dp/metric/{k}"], rtol=2e-5,
                                       err_msg=k)
        for k in mus:
            np.testing.assert_allclose(r["swap/mu/" + k[len("dp/mu/"):]], dp[k], rtol=0,
                                       atol=1e-4 * scale, err_msg=k)


# ------------------------------------------------------------------ the loop


def test_spatial_loop_trains_through_the_cli(tmp_path):
    """celeba256_spatial's path through train(): two ranks (1 data × 2 space)
    for 3 steps through the CLI, one writer; its losses equal the
    one-process unsharded loop's on the same batches and draws (rtol
    2e-5, f32)."""
    from partseg_tpu_torch.train.loop import train

    cfg_file = tmp_path / "tiny.py"
    cfg_file.write_text(SPATIAL_CONFIG)
    init = tmp_path / "init"
    procs = []
    for r in range(2):
        env = {**os.environ, "OMP_NUM_THREADS": "1", "RANK": str(r), "WORLD_SIZE": "2",
               "LOCAL_RANK": str(r)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CLI, "--config", str(cfg_file), "--device", "cpu",
             "--coordinator", f"file://{init}", "--ckpt_dir", str(tmp_path / "sp")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    got = {}
    for line in (tmp_path / "sp" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        assert rec["step"] not in got
        got[rec["step"]] = rec["loss"]
    assert sorted(got) == [0, 1, 2]

    import importlib.util
    import sys as _sys

    spec = importlib.util.spec_from_file_location("tiny_spatial_cfg", cfg_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _sys.modules["torch.utils.tensorboard"] = None
    try:
        cfg = mod.get_config().replace(space_shards=1, ckpt_dir=str(tmp_path / "ref"))
        train(cfg, device="cpu")
    finally:
        del _sys.modules["torch.utils.tensorboard"]
    for line in (tmp_path / "ref" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        np.testing.assert_allclose(got[rec["step"]], rec["loss"], rtol=2e-5, err_msg=rec["step"])


_CLI = ("import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
        "runpy.run_module('partseg_tpu_torch.train.cli', run_name='__main__')")

SPATIAL_CONFIG = '''\
import dataclasses

import torch

from partseg_tpu_torch.train.config import apply_overrides, load_config


def get_config():
    cfg = apply_overrides(load_config("celeba256_spatial"), [
        "model.img_size=32", "model.features=16", "model.depth=1", "model.app_features=8",
        "model.decoder_scales=2", "model.decoder_features=(16, 8)", "model.n_parts=3",
        "loss.vgg_layers=('relu1_2',)", "loss.vgg_trim_blocks=1", "loss.vgg_resolution=16",
        "global_batch=4", "dataset='synthetic'",
        "dataset_kwargs=(('size', 32), ('n_blobs', 3), ('n_examples', 16))", "steps=3",
        "log_every=1", "image_log_every=2", "ckpt_every=1000"])
    return cfg.replace(model=dataclasses.replace(cfg.model, dtype=torch.float32))
'''
