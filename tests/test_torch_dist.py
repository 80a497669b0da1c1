"""Data-parallel training of the port (dist/mesh.py, the step's group, the
loop's ranks and the CLI's --coordinator) against the JAX package, on the
CPU with gloo processes.

The ranks are child processes (tests/_torch_dist_child.py, or the CLI)
that import only the port and read their inputs from an npz written
here; the JAX references run in this process on the conftest's CPU
devices. Both sides start from the same weights (the port's seeded init
carried into Flax's tree) and the same per-sample draws (JAX's, keyed by
(key, step, aug_id) and injected), at a step whose learning rate is
above 0, with zero Adam moments: the first moment after one update is
0.1 × the averaged gradient, so comparing it compares the gradients.

Tolerances (PERF.md §2): the loss and the metrics rtol 1e-4; the
gradients (first moments) within 1e-4 of their largest entry; the
parameters after the update within 1e-4 of each tensor's largest entry
where the gradient stands above rounding noise (|m| > 1e-4 of the
largest), and within 2·lr elsewhere (Adam turns a gradient that is 0
but for rounding into a step of either sign).
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
from jax.sharding import NamedSharding, PartitionSpec as P

from partseg_tpu.augment.pair import AugmentConfig as JAugment
from partseg_tpu.dist.mesh import make_mesh as jax_make_mesh
from partseg_tpu.models.partnet import PartNetConfig as JModel
from partseg_tpu.train import config as jconfig
from partseg_tpu.train.loop import build_step_fn as jax_build_step_fn
from partseg_tpu_torch.dist import Mesh, make_mesh, make_spatial_mesh
from partseg_tpu_torch.losses import PerceptualLoss, VGG19Features
from partseg_tpu_torch.models.partnet import PartNet
from partseg_tpu_torch.train import create_state
from partseg_tpu_torch.train.checkpoint import CheckpointManager
from partseg_tpu_torch.train.loop import aug_ids
from partseg_tpu_torch.train.step import make_train_step
from _torch_dist_child import draws_from, launch
from _torch_dist_jax import KEY, compare_step, inputs_npz, jax_keyed_draws, jax_setup
from _torch_parity import images

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent
START = 5          # lr = 1e-3 · 5/10 under the 10-step warmup
LR = 1e-3 * START / 10


def jax_config(swap_weight: float = 0.5, img: int = 16, batch: int = 8, **model):
    """tests/test_multihost.py's config at f32, swap on, a 10-step warmup."""
    return jconfig.TrainConfig(
        model=JModel(**{**dict(n_parts=3, img_size=img, features=16, depth=1, app_features=8,
                               decoder_scales=2), **model}, dtype=jnp.float32),
        augment=JAugment(tps_grid=3),
        loss=jconfig.LossConfig(vgg_layers=("relu1_2",), vgg_trim_blocks=1,
                                swap_weight=swap_weight),
        optim=jconfig.OptimConfig(lr=1e-3, warmup_steps=10, decay_steps=100),
        global_batch=batch,
    )


# ------------------------------------------------------------------ the step


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """JAX's 2-device shard_map step and the port's 2-rank step, swap on,
    from one state and the same draws."""
    jcfg = jax_config()
    s = jax_setup(jcfg, START)
    b = jcfg.global_batch
    imgs = images(30, b, 16)
    aug = np.arange(b, dtype=np.int32)
    draws = jax_keyed_draws(jcfg, s["jsampler"], START, aug)
    mesh = jax_make_mesh(jax.devices()[:2])
    step = jax_build_step_fn(jcfg, s["jm"], s["jsampler"], s["jperc"], mesh)
    bsh = NamedSharding(mesh, P("data"))
    jnew, jmetrics = step(jax.device_put(s["jstate"], NamedSharding(mesh, P())),
                          {"image": jax.device_put(imgs, bsh), "aug_id": jax.device_put(aug, bsh)},
                          jax.random.key(KEY))
    jnew, jmetrics = jax.device_get((jnew, jmetrics))
    tmp = tmp_path_factory.mktemp("dp")
    arrays = {**inputs_npz(s), "images": imgs, "aug_id": aug, "start": np.asarray(START),
              **{f"draws/{k}": v for k, v in draws.items()}}
    np.savez(tmp / "inputs.npz", **arrays)
    ranks = launch("dp", 2, tmp / "inputs.npz", tmp)
    return dict(ranks=ranks, jstate=jnew, jmetrics=jmetrics, setup=s, imgs=imgs, draws=draws)


def test_dp_step_matches_jax_two_device_step(dp_run):
    """Loss, metrics (the JAX pmean'd ones, grad_norm included), gradients
    and updated parameters of rank 0 against JAX's 2-device step."""
    compare_step(dp_run["ranks"][0], "", dp_run["jmetrics"], dp_run["jstate"], LR)
    assert "swap" in dp_run["jmetrics"]


def test_dp_ranks_hold_the_same_state(dp_run):
    """The averaged update leaves both ranks with the same parameters, bit
    for bit, and the same metrics."""
    r0, r1 = dp_run["ranks"]
    for k in r0:
        if k.startswith(("param/", "metric/", "mu/")):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_broadcast_gives_every_rank_rank_zeros_weights(dp_run):
    """create_replicated's counterpart: rank 1 initialised from another
    seed holds rank 0's weights after broadcast_parameters."""
    assert all(float(r["broadcast_max_diff"]) == 0.0 for r in dp_run["ranks"])


def test_dp_world_one_is_the_plain_step(dp_run):
    """At world size 1 the step has no collective: with the mesh's group it
    equals the step without one, bit for bit."""
    s = dp_run["setup"]
    pcfg = s["pcfg"]
    vgg = VGG19Features(pcfg.loss.vgg_layers, pcfg.loss.vgg_trim_blocks, torch.float32)
    vgg.load_state_dict(s["vgg"])
    perc = PerceptualLoss(vgg, feature_resolution=pcfg.loss.vgg_resolution)
    mesh = make_mesh()
    assert mesh == Mesh(1, 0, 1) and mesh.data_group is None
    arrays = {f"draws/{k}": v for k, v in dp_run["draws"].items()}
    results = []
    for group in (mesh.data_group, "absent"):
        model = PartNet(pcfg.model, device="cpu")
        model.load_state_dict(s["weights"])
        state = create_state(pcfg, model, step=START)
        kw = {} if group == "absent" else {"group": group}
        step = make_train_step(pcfg, model, pcfg.augment.make_sampler(), perc, **kw)
        state, m = step(state, {"image": torch.from_numpy(dp_run["imgs"])},
                        draws=draws_from(arrays, "draws/", slice(None)))
        results.append((m, state.model.state_dict()))
    (m0, p0), (m1, p1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_aug_ids_per_rank_equal_the_jax_loops():
    """The port's ids are partseg_tpu/train/loop.py:384-388's,
    arange(per_host) + process_index·per_host + (fetch_step + sub)·global,
    and the ranks' ids of a step are the one-process ids, split."""
    g, n = 12, 3
    per = g // n
    for fetch_step, sub in ((0, 0), (4, 1), (10, 0)):
        got = [aug_ids(per, d, fetch_step, sub, g) for d in range(n)]
        for d in range(n):
            want = (np.arange(per, dtype=np.int32) + d * per + (fetch_step + sub) * g)
            np.testing.assert_array_equal(got[d], want)
        np.testing.assert_array_equal(np.concatenate(got), aug_ids(g, 0, fetch_step, sub, g))


def test_world_one_refuses_space_shards_as_jax_does():
    """make_spatial_mesh raises, as JAX's does, when the ranks do not divide
    by space_shards; one rank makes the 1 × 1 mesh."""
    from partseg_tpu.dist.mesh import make_spatial_mesh as jax_make_spatial_mesh

    with pytest.raises(ValueError) as jax_err:
        jax_make_spatial_mesh(3, jax.devices()[:1])
    with pytest.raises(ValueError) as port_err:
        make_spatial_mesh(3)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="not divisible by space_shards=2"):
        make_spatial_mesh(2)
    assert make_spatial_mesh(1) == Mesh(1, 0, 1)


# ------------------------------------------------------------------ the loop


_CLI = ("import runpy, sys; sys.modules['torch.utils.tensorboard'] = None; "
        "runpy.run_module('partseg_tpu_torch.train.cli', run_name='__main__')")

LOOP_SETS = [
    "model.img_size=16", "model.features=16", "model.depth=1", "model.app_features=8",
    "model.decoder_scales=2", "model.n_parts=3", "loss.vgg_layers=('relu1_2',)",
    "loss.vgg_trim_blocks=1", "optim.warmup_steps=2", "optim.decay_steps=10",
    "dataset_kwargs=(('size',16),('n_blobs',3),('n_examples',64))", "global_batch=8",
    "steps=8", "log_every=1", "image_log_every=3", "ckpt_every=2",
]


def run_ranks(run_dir, world: int = 2, sets=(), expect_rc: int = 0, timeout: float = 300.0):
    """``world`` CLI processes joined through --coordinator file://…, each
    told its RANK and WORLD_SIZE, on the CPU with gloo."""
    init = pathlib.Path(str(run_dir) + ".init")
    init.unlink(missing_ok=True)
    procs = []
    for r in range(world):
        env = {**os.environ, "OMP_NUM_THREADS": "1", "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": str(world)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CLI, "--config", "synthetic", "--device", "cpu",
             "--coordinator", f"file://{init}", "--ckpt_dir", str(run_dir),
             "--set", *LOOP_SETS, *sets],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [expect_rc] * world, outs
    return outs


def logged(run_dir, one_writer: bool = True) -> dict:
    """{step: record} of metrics.jsonl (a resumed run's later records win);
    ``one_writer``: no step is logged twice (two writers would)."""
    out = {}
    for line in (pathlib.Path(run_dir) / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        assert not (one_writer and rec["step"] in out), f"step {rec['step']} logged twice"
        out[rec["step"]] = rec
    return out


def test_two_rank_kill_and_resume_is_exact_with_one_writer(tmp_path):
    """tests/test_multihost.py::test_two_process_durability, unmarked: two
    ranks through the CLI's --coordinator, killed at step 5 after the
    step-4 checkpoint (both exit 42), relaunched: the resumed steps equal
    the uninterrupted run's bit for bit; one writer of metrics and image
    grids."""
    ref_dir, dur_dir = tmp_path / "ref", tmp_path / "dur"
    outs = run_ranks(ref_dir)
    assert all("backend gloo, device cpu" in o for o in outs), outs
    run_ranks(dur_dir, sets=["fault_injection_step=5"], expect_rc=42)
    assert CheckpointManager(str(dur_dir)).all_steps() == [2, 4]
    outs = run_ranks(dur_dir)
    assert all("restored checkpoint at step 4" in o for o in outs), outs
    ref, dur = logged(ref_dir), logged(dur_dir, one_writer=False)
    assert sorted(ref) == list(range(8)) and max(dur) == 7
    for s in range(4, 8):
        assert dur[s]["loss"] == ref[s]["loss"], s
    imgs = sorted(p.name for p in (ref_dir / "images").glob("input_*.png"))
    assert imgs == ["input_0000000.png", "input_0000003.png", "input_0000006.png"], imgs
    assert ref[0]["img_per_sec_per_chip"] > 0


def test_two_rank_scan_groups_run_the_same_steps(tmp_path):
    """tests/test_multihost.py::test_two_process_scan_groups: two ranks with
    scan_groups = 2 log, per dispatch, the mean of the scan_groups = 1
    run's two per-step losses (the same steps, run eagerly)."""
    seq, scan = tmp_path / "seq", tmp_path / "scan"
    run_ranks(seq, sets=["image_log_every=0"])
    run_ranks(scan, sets=["scan_groups=2", "image_log_every=2"])
    ref, got = logged(seq), logged(scan)
    assert sorted(got) == [0, 2, 4, 6]
    for s in got:
        np.testing.assert_allclose(got[s]["loss"], (ref[s]["loss"] + ref[s + 1]["loss"]) / 2,
                                   rtol=1e-6, err_msg=str(s))
    assert sorted((scan / "images").glob("input_*.png"))


def test_cli_refuses_nccl_for_ranks_that_share_a_card():
    from partseg_tpu_torch.train.cli import rank_device

    with pytest.raises(SystemExit, match="--dist_backend gloo"):
        rank_device("cuda:0", None, 2, 0, 1)
    with pytest.raises(SystemExit, match="no card of its own"):
        rank_device(None, None, 2, 1, 1)
    assert rank_device("cuda:0", "gloo", 2, 1, 1) == ("cuda:0", "gloo")
    assert rank_device(None, None, 2, 1, 2) == ("cuda:1", "nccl")
    assert rank_device("cpu", None, 2, 1, 0) == ("cpu", "gloo")
