"""The port's train loop (partseg_tpu_torch/train/loop.py), its
checkpoints, metrics and CLI, on the CPU at the sizes of
tests/test_fault_resume.py: 16 px, features 16, depth 1, K = 3, B = 8.

The loop runs eagerly, so the checks the JAX package can make only to
cross-executable roundoff hold bit for bit here: a resumed run equals the
uninterrupted one, scan_groups > 1 runs the same steps as scan_groups = 1,
and device_data trains on the same images as streaming. The schedule's
alignment errors are held to the JAX loop's, case for case.

The loop's TensorBoard import is stubbed out (as if not installed) in
every test but the logger's own: where TensorFlow is installed, that
import loads it, about 15 s per process.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from partseg_tpu_torch import tracing
from partseg_tpu_torch.augment import AugmentConfig
from partseg_tpu_torch.data import SyntheticBlobs, make_loader
from partseg_tpu_torch.models.partnet import PartNetConfig
from partseg_tpu_torch.train import LossConfig, OptimConfig, TrainConfig
from partseg_tpu_torch.train.checkpoint import CheckpointManager
from partseg_tpu_torch.train.metrics import MetricLogger
from partseg_tpu_torch.train import loop as loop_mod
from partseg_tpu_torch.train.loop import train

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent

DATA = dict(size=16, n_blobs=3, n_examples=64)
TINY = TrainConfig(
    model=PartNetConfig(n_parts=3, img_size=16, features=16, depth=1, app_features=8,
                        decoder_scales=2, dtype=torch.float32),
    augment=AugmentConfig(tps_grid=3),
    loss=LossConfig(vgg_layers=("relu1_2",), vgg_trim_blocks=1),
    optim=OptimConfig(lr=1e-3, warmup_steps=10, decay_steps=100),
    dataset="synthetic",
    dataset_kwargs=tuple(DATA.items()),
    global_batch=8,
    steps=3,
    log_every=1,
    image_log_every=0,
    ckpt_every=1000,
)
PERIOD2 = dataclasses.replace(TINY.augment, warp_every=2)
TENSORBOARD = "torch.utils.tensorboard"


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, TENSORBOARD, None)


def run(cfg, tmp_path, tag, **kw):
    """train() on the CPU in tmp_path/tag; (state, {step: logged metrics})."""
    cfg = cfg.replace(ckpt_dir=str(tmp_path / tag))
    state = train(cfg, device="cpu", **kw)
    logged = {}
    for line in (tmp_path / tag / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        logged[rec["step"]] = rec
    return state, logged


def params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def assert_same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def counting_loader(cfg, pulls, u8=False):
    ds = SyntheticBlobs(**DATA)
    for b in make_loader(ds, cfg.global_batch, seed=cfg.seed):
        pulls.append(1)
        yield {"image": np.round(b["image"] * 255).astype(np.uint8)} if u8 else b


def test_loss_decreases(tmp_path):
    """A few dozen steps on 8 blobs images: the loss falls, every logged
    value is finite and the logged throughput positive."""
    cfg = TINY.replace(
        steps=30, optim=OptimConfig(lr=3e-3, warmup_steps=2, decay_steps=100),
        dataset_kwargs=(("size", 16), ("n_blobs", 3), ("n_examples", 8)))
    state, logged = run(cfg, tmp_path, "run")
    assert state.step == 30 and sorted(logged) == list(range(30))
    losses = [logged[s]["loss"] for s in range(30)]
    assert np.mean(losses[-5:]) < 0.9 * np.mean(losses[:5]), losses
    assert all(np.isfinite(v) for rec in logged.values() for v in rec.values()
               if not isinstance(v, str))
    assert all(rec["img_per_sec_per_chip"] > 0 for rec in logged.values())
    assert {rec["vgg_mode"] for rec in logged.values()} == {"random-torch"}


def test_warp_every_schedule(tmp_path):
    """warp_every = 2: one period (two batches, sub-step 0 warped) per
    dispatch, checkpoints at period boundaries, an aligned resume; a step
    budget that is not a period multiple is refused."""
    cfg = TINY.replace(steps=4, ckpt_every=2, augment=PERIOD2)
    state, logged = run(cfg, tmp_path, "run")
    assert state.step == 4 and sorted(logged) == [0, 2]
    assert {"loss_warp_on", "loss_warp_off"} <= set(logged[0])
    assert CheckpointManager(str(tmp_path / "run")).all_steps() == [2, 4]
    state2, logged2 = run(cfg.replace(steps=6), tmp_path, "run")
    assert state2.step == 6 and sorted(logged2) == [0, 2, 4]
    with pytest.raises(ValueError, match="multiple of"):
        run(cfg.replace(steps=7), tmp_path, "run2")


def test_data_echo_takes_one_batch_per_group(tmp_path):
    pulls = []
    cfg = TINY.replace(steps=4, data_echo=2)
    state, _ = run(cfg, tmp_path, "run", data_iter=counting_loader(cfg, pulls))
    assert state.step == 4 and sum(pulls) == 2
    with pytest.raises(ValueError, match="multiple of"):
        run(cfg.replace(steps=5), tmp_path, "run2")


def test_resume_seeks_the_data_iterator(tmp_path, monkeypatch):
    """Under data_echo = 2 a resume seeks the loader to step // 2."""
    starts = []
    real = loop_mod.make_loader

    def spy(*a, **kw):
        starts.append(kw.get("start_batch", 0))
        return real(*a, **kw)

    monkeypatch.setattr(loop_mod, "make_loader", spy)
    cfg = TINY.replace(steps=4, ckpt_every=2, data_echo=2)
    run(cfg, tmp_path, "run")
    state, _ = run(cfg.replace(steps=8), tmp_path, "run")
    assert state.step == 8 and starts == [0, 2]


@pytest.mark.parametrize("schedule", [
    dict(augment=PERIOD2, ckpt_every=4),
    dict(augment=PERIOD2, data_echo=2, scan_groups=2, ckpt_every=8),
])
def test_resumed_training_equals_uninterrupted(tmp_path, schedule):
    """Stopped at a checkpoint and resumed, a run ends with the same
    parameters and logs the same losses, bit for bit, as one that ran
    through: the state, the data seek and the per-sample draws are all
    restored."""
    cfg = TINY.replace(steps=16, **schedule)
    full, full_log = run(cfg, tmp_path, "full")
    run(cfg.replace(steps=8), tmp_path, "split")
    resumed, log = run(cfg, tmp_path, "split")
    assert resumed.step == full.step == 16
    assert resumed.opt_state.count == full.opt_state.count == 16
    assert_same_params(params(resumed), params(full))
    for s in log:
        assert log[s]["loss"] == full_log[s]["loss"], s


def test_scan_groups_runs_the_same_steps(tmp_path):
    """scan_groups = 2: each call runs two fetch groups (with echo), the
    same batches, steps and updates as scan_groups = 1, so the parameters
    are bit-identical and each call's loss is the mean of the steps it ran;
    misaligned budgets are refused."""
    for echo in (1, 2):
        pulls_scan, pulls_seq = [], []
        cfg = TINY.replace(steps=8, ckpt_every=8, data_echo=echo, augment=PERIOD2)
        s_scan, l_scan = run(cfg.replace(scan_groups=2), tmp_path, f"scan{echo}",
                             data_iter=counting_loader(cfg, pulls_scan))
        s_seq, l_seq = run(cfg, tmp_path, f"seq{echo}", data_iter=counting_loader(cfg, pulls_seq))
        assert sum(pulls_scan) == sum(pulls_seq) == 8 // echo
        assert_same_params(params(s_scan), params(s_seq))
        span = 4 * echo
        assert sorted(l_scan) == list(range(0, 8, span)) and sorted(l_seq) == [0, 2, 4, 6]
        for s in l_scan:
            want = np.mean([l_seq[x]["loss"] for x in range(s, s + span, 2)])
            np.testing.assert_allclose(l_scan[s]["loss"], want, rtol=1e-6)


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_device_data_equals_streaming(tmp_path, u8):
    """device_data keeps the whole dataset on the device and gathers each
    batch there by index: the same batches as streaming, bit for bit; with
    device_data_u8 the table holds round(x·255) as uint8, as a uint8 host
    loader ships them. Alone and with scan_groups."""
    for scan in (1, 2):
        cfg = TINY.replace(steps=8, ckpt_every=8, augment=PERIOD2, scan_groups=scan)
        s_dev, l_dev = run(cfg.replace(device_data=True, device_data_u8=u8), tmp_path,
                           f"dev{scan}")
        s_str, l_str = run(cfg, tmp_path, f"str{scan}", data_iter=counting_loader(cfg, [], u8))
        assert_same_params(params(s_dev), params(s_str))
        assert {s: r["loss"] for s, r in l_dev.items()} == {s: r["loss"] for s, r in l_str.items()}


def test_device_data_refuses_what_it_cannot_do(tmp_path):
    with pytest.raises(ValueError, match="device_data"):
        run(TINY.replace(device_data=True, loader_backend="native"), tmp_path, "bad1")
    with pytest.raises(ValueError, match="device_data"):
        run(TINY.replace(device_data=True), tmp_path, "bad2", data_iter=iter([]))
    with pytest.raises(ValueError, match="too large"):
        loop_mod._device_dataset_table(SyntheticBlobs(**DATA), torch.device("cpu"),
                                       limit_bytes=1000)


# The JAX loop's alignment checks (partseg_tpu/train/loop.py): each case
# is a config change, and the port must refuse what JAX's train() refuses,
# with the same message, and take what it takes.
ALIGNMENT_CASES = {
    "scan_steps": dict(steps=6, ckpt_every=4, scan_groups=2, warp_every=2),
    "scan_ckpt": dict(steps=8, ckpt_every=6, scan_groups=2, warp_every=2),
    "scan_fault": dict(steps=8, ckpt_every=8, scan_groups=2, warp_every=2,
                       fault_injection_step=3),
    "period_steps": dict(steps=5, ckpt_every=2, warp_every=2),
    "period_ckpt": dict(steps=4, ckpt_every=3, warp_every=2),
    "echo_steps": dict(steps=6, ckpt_every=4, data_echo=4),
    "aligned": dict(steps=0, ckpt_every=8, scan_groups=2, warp_every=2, data_echo=2),
}


@pytest.fixture
def jax_train(monkeypatch):
    """The JAX loop's train() at the same tiny sizes, its checks the JAX
    code itself. What it builds before them and the checks do not read is
    stubbed, so that nothing is compiled: the replicated state and key, the
    perceptual loss, the checkpoint manager and the logger (which would
    import TensorFlow)."""
    import types

    import partseg_tpu.train.loop as jloop
    from partseg_tpu.augment.pair import AugmentConfig as JAugment
    from partseg_tpu.models.partnet import PartNetConfig as JModel
    from partseg_tpu.train import config as jconfig

    class Stub:
        def __init__(self, *a, **kw):
            self.vgg_mode = "stub"

        def restore_latest(self, state):
            return None

        def __getattr__(self, name):
            return lambda *a, **kw: None

    monkeypatch.setattr(jloop, "create_replicated", lambda fn, mesh: None)
    monkeypatch.setattr(jloop, "build_perceptual", Stub)
    monkeypatch.setattr(jloop, "CheckpointManager", Stub)
    monkeypatch.setattr(jloop, "MetricLogger", Stub)
    base = jconfig.TrainConfig(
        model=JModel(n_parts=3, img_size=16, features=16, depth=1, app_features=8,
                     decoder_scales=2),
        augment=JAugment(tps_grid=3),
        loss=jconfig.LossConfig(vgg_layers=("relu1_2",), vgg_trim_blocks=1),
        dataset_kwargs=tuple(DATA.items()), global_batch=8, log_every=1, image_log_every=0)
    return types.SimpleNamespace(base=base, train=jloop.train)


@pytest.mark.parametrize("case", list(ALIGNMENT_CASES))
def test_alignment_errors_match_jax(case, tmp_path, jax_train):
    jbase, jtrain = jax_train.base, jax_train.train
    over = dict(ALIGNMENT_CASES[case])
    every = over.pop("warp_every", 1)
    outcomes = []
    for side, base in (("jax", jbase), ("port", TINY)):
        cfg = base.replace(ckpt_dir=str(tmp_path / side),
                           augment=dataclasses.replace(base.augment, warp_every=every), **over)
        try:
            if side == "jax":
                jtrain(cfg)
            else:
                train(cfg, device="cpu")
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    jax_msg, port_msg = outcomes
    assert (jax_msg is None) == (case == "aligned")
    if jax_msg is not None:
        # The messages agree up to the one phrase that names JAX's compile.
        assert port_msg.split("(")[0] == jax_msg.split("(")[0], (port_msg, jax_msg)


# ``python -m partseg_tpu_torch.train.cli`` with TensorBoard stubbed out.
_CLI = (f"import runpy, sys; sys.modules[{TENSORBOARD!r}] = None; "
        "runpy.run_module('partseg_tpu_torch.train.cli', run_name='__main__')")


def _cli(args, env=None):
    return subprocess.run([sys.executable, "-c", _CLI, *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def test_fault_injection_then_resume_through_the_cli(tmp_path):
    """tests/test_fault_resume.py through the port's CLI: a hard kill at
    step 12 exits 42 after the step-10 checkpoint; a rerun restores it and
    trains to the end."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    run_dir = str(tmp_path / "run")
    sets = [
        "model.img_size=16", "model.features=16", "model.depth=1",
        "model.app_features=8", "model.decoder_scales=2", "model.n_parts=3",
        "dataset_kwargs=(('size',16),('n_blobs',3),('n_examples',64))",
        "global_batch=8", "ckpt_every=5", "log_every=5", "image_log_every=10",
        "loss.vgg_layers=('relu1_2',)", "loss.vgg_trim_blocks=1",
    ]
    common = ["--config", "configs/synthetic.py", "--ckpt_dir", run_dir, "--device", "cpu",
              "--steps", "20"]
    r1 = _cli(common + ["--set"] + sets + ["fault_injection_step=12"], env)
    assert r1.returncode == 42, (r1.returncode, r1.stdout[-2000:], r1.stderr[-2000:])
    assert CheckpointManager(run_dir).all_steps() == [5, 10]
    r2 = _cli(common + ["--set"] + sets, env)
    assert r2.returncode == 0, (r2.stdout[-2000:], r2.stderr[-2000:])
    assert "restored checkpoint at step 10" in r2.stdout
    steps = [json.loads(line)["step"]
             for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert max(steps) == 19 and CheckpointManager(run_dir).all_steps() == [10, 15, 20]
    assert sorted(os.listdir(tmp_path / "run" / "images"))[0] == "input_0000000.png"


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """What the CLI cannot do it refuses before it starts: NCCL for ranks
    that share one card (before joining the process group), and a dataset
    that is not there."""
    from partseg_tpu_torch.train import cli

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(SystemExit, match="--dist_backend gloo"):
        cli.main(["--config", "synthetic", "--device", "cuda:0", "--dist_backend", "nccl",
                  "--coordinator", "localhost:1234"])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit) as exit_:
        cli.main(["--config", "celeba", "--check_data", "--set",
                  "dataset_kwargs=(('size',16),)"])
    assert exit_.value.code == 1                       # no CelebA on this machine


def test_checkpoint_manager_keeps_orbax_semantics(tmp_path):
    """Interval saves, forced saves, keep-N, restore-latest; each written
    under a temporary name and renamed."""
    from partseg_tpu_torch.models.partnet import PartNet, init_weights
    from partseg_tpu_torch.train import create_state

    model = init_weights(PartNet(TINY.model, device="cpu"), seed=0)
    state = create_state(TINY, model)
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=4)
    assert mgr.restore_latest(state) is None
    saved = [mgr.save(s, state) for s in (2, 4, 6, 8)]
    assert saved == [False, True, False, True]
    assert mgr.save(8, state, force=True) is False       # already the latest
    state.step, state.opt_state.count = 9, 9
    state.opt_state.mu[next(iter(state.opt_state.mu))].fill_(0.5)
    assert mgr.save(9, state, force=True) is True
    assert mgr.save(8, state) is False                   # older than the latest
    mgr.wait()
    assert mgr.all_steps() == [8, 9]
    assert not list((tmp_path / "checkpoints").glob("*.tmp"))
    fresh = create_state(TINY, init_weights(PartNet(TINY.model, device="cpu"), seed=1))
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(fresh)
    assert step == 9 and restored.step == 9 and restored.opt_state.count == 9
    assert_same_params(params(restored), params(state))
    for name in ("mu", "nu"):
        for k, v in getattr(state.opt_state, name).items():
            assert torch.equal(getattr(restored.opt_state, name)[k], v)


def test_metric_logger_writes_jsonl_pngs_and_tensorboard(tmp_path, capsys, monkeypatch):
    monkeypatch.delitem(sys.modules, TENSORBOARD)
    log = MetricLogger(str(tmp_path))
    log.log(3, {"loss": torch.tensor(1.5), "vgg_mode": "random-torch"})
    log.log_images(3, {"recon": np.random.default_rng(0).uniform(size=(2, 8, 8, 3))})
    log.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["vgg_mode"] == "random-torch"
    assert json.loads(capsys.readouterr().out.strip()) == rec
    assert (tmp_path / "images" / "recon_0000003.png").exists()
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))


def test_metric_logger_without_tensorboard_writes_jsonl_only(tmp_path):
    """Where torch.utils.tensorboard does not import (stubbed here), the
    logger still writes its JSON lines, and makes no tb/ directory."""
    log = MetricLogger(str(tmp_path))
    log.log(0, {"loss": 2.0})
    log.close()
    assert json.loads((tmp_path / "metrics.jsonl").read_text())["loss"] == 2.0
    assert not (tmp_path / "tb").exists()


def test_profile_window_and_debug_nans(tmp_path, monkeypatch):
    """profile_steps traces its window with torch.profiler into
    <run dir>/profile, with the program's spans in it; debug_nans trains
    under anomaly detection and checks the loss. Each metrics line carries
    the hand kernels' launches per step from the registry's counters (here
    a counter the CPU's plain versions leave at 0, counted by a wrapped
    step)."""
    build = loop_mod.build_step_fn

    def counting(*args, **kwargs):
        step_fn = build(*args, **kwargs)

        def step(*a):
            tracing.count("kernel.render_assemble.launches", 3)
            return step_fn(*a)

        return step

    monkeypatch.setattr(loop_mod, "build_step_fn", counting)
    cfg = TINY.replace(steps=4, profile_steps=(1, 2))
    state, logged = run(cfg, tmp_path, "run", debug_nans=True)
    assert state.step == 4
    assert [p.name for p in (tmp_path / "run" / "profile").iterdir()] == ["trace_0000002.json"]
    trace = (tmp_path / "run" / "profile" / "trace_0000002.json").read_text()
    assert all(f'"{name}"' in trace for name in ("loop.fetch", "train.step", "train.backward"))
    assert [rec["kernel.render_assemble.launches_per_step"] for rec in logged.values()] == [3.0] * 4
