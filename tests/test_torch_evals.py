"""Port parity for the evaluation path: partseg_tpu_torch.evals (landmarks,
segmentation, the infer/transfer/eval CLIs) and the synthetic validation
tools, against the JAX package's evals and tests/test_evals.py, case for
case, on the CPU.

The protocol tests mirror tests/test_evals.py. The parity tests run the
JAX model (use_pallas=False: its plain reference) and the port on the
same converted f32 parameters and the same synthetic split: μ within
1e-5 of its scale (tens of f32 layers in another sum order), the
regression's error within 1e-4 relative, and segmentation metrics equal,
after checking that no pixel's two largest part probabilities lie closer
than twice the frameworks' largest difference in them (so no argmax can
flip between the two).
The CLI tests run on a tiny checkpoint that the port's loop writes.
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from partseg_tpu.data.loader import make_loader as jax_make_loader
from partseg_tpu.data.synthetic import SyntheticBlobs as JaxSyntheticBlobs
from partseg_tpu.evals.landmarks import collect_mu as jax_collect_mu
from partseg_tpu.evals.landmarks import evaluate_landmarks as jax_evaluate_landmarks
from partseg_tpu.evals.segmentation import evaluate_segmentation as jax_evaluate_segmentation
from partseg_tpu_torch.data import SyntheticBlobs, make_loader
from partseg_tpu_torch.evals import (
    collect_mu,
    evaluate_landmarks,
    evaluate_segmentation,
    fit_landmark_regressor,
    landmark_error,
    segmentation_iou,
)
from partseg_tpu_torch.evals.segmentation import match_parts_to_classes, nn_resize_labels
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from _torch_parity import TINY_TRAIN_CONFIG, jax_partnet, torch_partnet

torch.set_num_threads(1)

# tests/test_evals.py's model, at f32.
SMALL = PartNetConfig(n_parts=3, img_size=16, features=16, depth=1, app_features=8,
                      decoder_scales=2, dtype=torch.float32)


def small_model():
    return init_weights(PartNet(SMALL, device="cpu"), seed=0).eval()


def loader(ds, batch, cls=make_loader):
    return cls(ds, batch, shuffle=False, num_epochs=1, drop_remainder=False)


# ------------------------------------------------- tests/test_evals.py, case for case

def test_regressor_recovers_linear_relation():
    rng = np.random.default_rng(0)
    K, L, n = 6, 5, 500
    mu = rng.uniform(-1, 1, size=(n, K, 2))
    W_true = rng.normal(size=(2 * K, 2 * L))
    gt = (mu.reshape(n, -1) @ W_true).reshape(n, L, 2)
    W = fit_landmark_regressor(mu[:400], gt[:400])
    err = landmark_error(W, mu[400:], gt[400:])
    assert err < 1e-6, err


def test_regressor_error_normalized_by_iod():
    rng = np.random.default_rng(1)
    n, K, L = 200, 4, 5
    mu = rng.uniform(-1, 1, size=(n, K, 2))
    gt = rng.uniform(-1, 1, size=(n, L, 2))
    W = fit_landmark_regressor(mu, gt)
    e1 = landmark_error(W, mu, gt, iod_fn=lambda g: np.ones(len(g)))
    e2 = landmark_error(W, mu, gt, iod_fn=lambda g: 2 * np.ones(len(g)))
    np.testing.assert_allclose(e1, 2 * e2, rtol=1e-6)


def test_segmentation_iou_perfect_and_disjoint():
    gt = np.zeros((1, 8, 8), np.int64)
    gt[0, :4, :] = 1
    m = segmentation_iou(gt, gt, n_classes=2)
    assert m["miou"] == 1.0 and m["fg_iou"] == 1.0
    m2 = segmentation_iou(1 - gt, gt, n_classes=2)
    assert m2["miou"] == 0.0 and m2["fg_iou"] == 0.0


def test_segmentation_iou_ignore_index():
    gt = np.zeros((1, 4, 4), np.int64)
    gt[0, 0, :] = 255
    pred = np.zeros((1, 4, 4), np.int64)
    assert segmentation_iou(pred, gt, n_classes=2, ignore_index=255)["miou"] == 1.0


def test_match_parts_majority_vote():
    gt = np.zeros((1, 4, 4), np.int64)
    gt[0, :, 2:] = 3
    pred = np.zeros((1, 4, 4), np.int64)
    pred[0, :, 2:] = 1          # part 1 overlaps class 3
    mapping = match_parts_to_classes(pred, gt, n_parts=2, n_classes=4)
    assert mapping[0] == 0 and mapping[1] == 3
    assert segmentation_iou(mapping[pred], gt, n_classes=4)["miou"] == 1.0


def test_eval_sees_whole_split_with_remainder():
    # drop_remainder=False + pad/trim: every example is scored (22 % 8 = 6).
    ds = SyntheticBlobs(size=16, n_blobs=3, n_examples=22)
    m = evaluate_landmarks(small_model(), loader(ds, 8), loader(ds, 8))
    assert m["n_train"] == 22.0 and m["n_test"] == 22.0, m


def test_segmentation_eval_upsamples_predictions():
    ds = SyntheticBlobs(size=16, n_blobs=3, n_examples=10, with_masks=True)
    m = evaluate_segmentation(small_model(), loader(ds, 4), n_classes=4)
    assert 0.0 <= m["miou"] <= 1.0 and 0.0 <= m["fg_iou"] <= 1.0


def test_nn_resize_labels_arbitrary_ratio():
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 5, size=(2, 8, 6))
    out = nn_resize_labels(seg, 13, 10)
    assert out.shape == (2, 13, 10)
    for y in range(13):
        for x in range(10):
            sy = min(int((y + 0.5) * 8 / 13), 7)
            sx = min(int((x + 0.5) * 6 / 10), 5)
            assert (out[:, y, x] == seg[:, sy, sx]).all()
    up = nn_resize_labels(seg, 16, 12)
    np.testing.assert_array_equal(up, seg.repeat(2, axis=1).repeat(2, axis=2))


def test_segmentation_eval_noninteger_label_resolution():
    ds = SyntheticBlobs(size=16, n_blobs=3, n_examples=8, with_masks=True)

    def odd_masks(it):
        for b in it:
            b = dict(b)
            b["mask"] = nn_resize_labels(np.asarray(b["mask"]), 23, 23)
            yield b

    m = evaluate_segmentation(small_model(), odd_masks(loader(ds, 4)), n_classes=4)
    assert 0.0 <= m["miou"] <= 1.0 and 0.0 <= m["fg_iou"] <= 1.0


# ------------------------------------------------------------ parity against JAX

@pytest.fixture(scope="module")
def pair():
    jm, jp = jax_partnet(use_pallas=False)
    return jm, jp, torch_partnet(jp)


def split(cls, n, **kw):
    return cls(size=32, n_blobs=3, n_examples=n, with_masks=True, **kw)


def test_collect_mu_and_landmarks_match_jax(pair):
    """A 22-example split at batch 8, remainder included, through both."""
    jm, jp, tm = pair
    got_mu, got_gt = collect_mu(tm, loader(split(SyntheticBlobs, 22), 8))
    want_mu, want_gt = jax_collect_mu(jm, jp, loader(split(JaxSyntheticBlobs, 22), 8,
                                                     jax_make_loader))
    assert got_mu.shape == (22, 4, 2)
    np.testing.assert_array_equal(got_gt, want_gt)
    np.testing.assert_allclose(got_mu, want_mu, atol=1e-5 * np.abs(want_mu).max())
    got = evaluate_landmarks(tm, loader(split(SyntheticBlobs, 22, seed=1), 8),
                             loader(split(SyntheticBlobs, 22, seed=2), 8))
    want = jax_evaluate_landmarks(
        jm, jp, loader(split(JaxSyntheticBlobs, 22, seed=1), 8, jax_make_loader),
        loader(split(JaxSyntheticBlobs, 22, seed=2), 8, jax_make_loader))
    assert got["n_train"] == want["n_train"] == got["n_test"] == 22.0
    np.testing.assert_allclose(got["landmark_error_pct_iod"], want["landmark_error_pct_iod"],
                               rtol=1e-4)


def test_evaluate_segmentation_matches_jax(pair):
    """Metrics equal. Argmax ties: every pixel's two largest part
    probabilities differ by more than twice the largest gap between the two
    frameworks' probabilities, so no label can flip between them."""
    from partseg_tpu.models.partnet import PartNet as JaxPartNet

    jm, jp, tm = pair
    ds = split(SyntheticBlobs, 10)
    x = np.stack([ds[i]["image"] for i in range(10)])
    with torch.no_grad():
        probs = tm.segmentation(tm.encode_shape(torch.from_numpy(x))).numpy()
    logits = jm.apply(jp, x, method=JaxPartNet.encode_shape)
    want_probs = np.asarray(jm.apply(jp, logits, method=JaxPartNet.segmentation))
    top2 = np.sort(probs, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 2 * np.abs(probs - want_probs).max()
    got = evaluate_segmentation(tm, loader(ds, 4), n_classes=4)
    want = jax_evaluate_segmentation(jm, jp, loader(split(JaxSyntheticBlobs, 10), 4,
                                                    jax_make_loader), n_classes=4)
    assert got == want


# ------------------------------------------------------ CLIs on a port checkpoint

@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A config file and the port loop's checkpoint at step 2 in one directory."""
    from partseg_tpu_torch.train.config import load_config
    from partseg_tpu_torch.train.loop import train

    d = tmp_path_factory.mktemp("run")
    (d / "tiny_cfg.py").write_text(TINY_TRAIN_CONFIG)
    cfg = load_config(str(d / "tiny_cfg.py")).replace(ckpt_dir=str(d))
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        train(cfg, device="cpu")
    finally:
        mp.undo()
    return d


@pytest.fixture
def pngs(tmp_path):
    import cv2

    rng = np.random.default_rng(5)
    paths = []
    for i, size in enumerate((20, 24)):
        p = str(tmp_path / f"in{i}.png")
        cv2.imwrite(p, rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
        paths.append(p)
    return paths


def test_infer_cli_on_a_port_checkpoint(run_dir, pngs, tmp_path, capsys):
    import cv2

    from partseg_tpu_torch.evals import infer

    out = str(tmp_path / "viz.png")
    infer.main(["--config", str(run_dir / "tiny_cfg.py"), "--ckpt_dir", str(run_dir),
                "--image", pngs[0], "--out", out, "--cpu"])
    assert "[infer] restored step 2" in capsys.readouterr().out
    assert cv2.imread(out).shape == (16, 16, 3)


def test_transfer_cli_decodes_at_full_size(run_dir, pngs, tmp_path, capsys):
    import cv2

    # The package's name ``transfer`` is the function; the CLI is the module's.
    transfer_cli = importlib.import_module("partseg_tpu_torch.evals.transfer")
    out = str(tmp_path / "t.png")
    transfer_cli.main(["--config", str(run_dir / "tiny_cfg.py"), "--ckpt_dir", str(run_dir),
                   "--shape", pngs[0], "--appearance", pngs[1], "--out", out, "--cpu"])
    assert "[infer] restored step 2" in capsys.readouterr().out
    # Trained with decoder_out_size=8; the CLI decodes at the image size.
    assert cv2.imread(out).shape == (16, 16, 3)


def test_eval_cli_dumps_the_whole_test_split(run_dir, tmp_path, capsys):
    from partseg_tpu_torch.evals import cli

    dump = tmp_path / "mu.npz"
    cli.main(["--config", str(run_dir / "tiny_cfg.py"), "--ckpt_dir", str(run_dir),
              "--batch", "8", "--dump", str(dump), "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    metrics = json.loads(lines[-1])
    # 20 examples at batch 8: the 4-example tail is scored too.
    assert metrics["n_train"] == metrics["n_test"] == 20.0
    assert np.isfinite(metrics["landmark_error_pct_iod"])
    with np.load(dump) as data:
        assert data["mu"].shape == (20, 5, 2) and data["landmarks"].shape == (20, 3, 2)


def test_validate_tools_print_the_jax_keys(tmp_path, capsys, monkeypatch):
    from partseg_tpu_torch.tools import validate_segmentation, validate_synthetic

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    sets = ["model.img_size=16", "model.features=16", "model.depth=1", "model.app_features=8",
            "loss.vgg_layers=('relu1_2',)", "loss.vgg_trim_blocks=1", "global_batch=8",
            "dataset_kwargs=(('size', 16), ('n_blobs', 5), ('n_examples', 64))"]
    out = str(tmp_path / "val")
    r = validate_synthetic.main(4, out, sets, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-2]) == r and printed[-1] in ("VALIDATION PASS", "VALIDATION FAIL")
    assert set(r) == {"equiv_first", "equiv_last", "equiv_reduction",
                      "landmark_err_pct_diag_trained", "landmark_err_pct_diag_random",
                      "steps", "ok"}
    assert r["steps"] == 4 and all(np.isfinite(v) for k, v in r.items() if k != "ok")
    s = validate_segmentation.main(out, sets, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-2]) == s
    assert set(s) == {"miou_trained", "fg_iou_trained", "miou_random", "fg_iou_random", "ok"}


def test_turns_runs_the_checkouts_in_turns(tmp_path, capsys):
    from partseg_tpu_torch.tools import turns

    base = tmp_path / "base"
    base.mkdir()
    script = ("import json, os; print('noise'); "
              "print(json.dumps({'cwd': os.getcwd(), 'run': int('{run}'), 'x': 2.5}))")
    rc = turns.main(["--baseline", str(base), "--out", str(tmp_path / "out"), "--",
                     sys.executable, "-c", script])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert rc == 0 and [r["tree"] for r in lines[:4]] == list(turns.ORDER)
    assert [r["last"]["run"] for r in lines[:4]] == [1, 2, 3, 4]
    assert {r["last"]["cwd"] for r in lines[:4] if r["tree"] == "baseline"} == {str(base)}
    assert {r["last"]["cwd"] for r in lines[:4] if r["tree"] == "this"} == {
        str(Path(turns.__file__).resolve().parents[2])}
    summary = lines[4]["turns"]
    assert summary["baseline"]["x"] == summary["this"]["x"] == 2.5
    assert summary["this"]["run"] == 2.5 and summary["baseline"]["run"] == 2.5
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "baseline1.txt", "baseline2.txt", "this1.txt", "this2.txt"]
