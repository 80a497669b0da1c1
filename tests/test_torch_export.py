"""The port's serving export (partseg_tpu_torch/evals/export.py), case for
case with tests/test_export.py: the ``torch.export`` program round-trips
through save/load and reproduces the direct forward at batch sizes not
seen at export (symbolic batch); a static batch refuses another size;
background is label 0. Beside those: the exported graph holds the
registered kernel op ``partseg::softmax_moments`` (no plain softmax over
the pixels, no einsum), the program agrees with the JAX package's
make_infer_fn on the same converted parameters, and the export CLI.

Tolerances: the program against the eager forward on the CPU, 1e-5 (the
same ops; they agree exactly here); against JAX, as tests/test_torch_serving.py
(logits 1e-4, heatmaps, landmarks and sigma 1e-5, seg labels equal).
"""

import numpy as np
import pytest
import torch

from partseg_tpu.evals.export import make_infer_fn as jax_make_infer_fn
from partseg_tpu_torch.evals.export import export_infer, load_exported, main, make_infer_fn
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from _torch_parity import TINY_TRAIN_CONFIG, images, jax_partnet, n, torch_partnet

torch.set_num_threads(1)

# tests/test_export.py's model, at f32.
CFG = PartNetConfig(n_parts=3, img_size=16, features=16, depth=1, app_features=8,
                    decoder_scales=2, dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    return init_weights(PartNet(CFG, device="cpu"), seed=0).eval()


@pytest.fixture(scope="module")
def symbolic(model):
    return export_infer(model, img_size=16, batch=None)


def _rand(batch):
    return torch.from_numpy(images(0, batch, 16))


def test_export_roundtrip_symbolic_batch(model, symbolic, tmp_path):
    path = str(tmp_path / "infer.pt2")
    torch.export.save(symbolic, path)
    reloaded = load_exported(path)
    direct = make_infer_fn(model)
    for b in (1, 5):                    # two batch sizes through one program
        x = _rand(b)
        got, want = reloaded.module()(x), direct(x)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
        assert got["seg"].shape == (b, 8, 8)
        assert got["landmarks"].shape == (b, 3, 2)


def test_export_static_batch_rejects_other_batch(model):
    program = export_infer(model, img_size=16, batch=2)
    program.module()(_rand(2))          # the exported batch works
    with pytest.raises(Exception):
        program.module()(_rand(3))


def test_export_seg_labels_background_zero(symbolic):
    seg = symbolic.module()(_rand(2))["seg"]
    # bg relabelled to 0, parts 1..K, int32.
    assert seg.dtype == torch.int32
    assert int(seg.min()) >= 0 and int(seg.max()) <= CFG.n_parts


def test_exported_graph_holds_the_kernel_op(symbolic):
    calls = [node for node in symbolic.graph.nodes if node.op == "call_function"]
    names = [str(node.target) for node in calls]
    assert names.count("partseg.softmax_moments.default") == 1
    assert not any("einsum" in name for name in names)
    # The one softmax left is the per-pixel part softmax over the channels.
    softmaxes = [node for node in calls if "softmax" in str(node.target)
                 and "partseg" not in str(node.target)]
    assert len(softmaxes) == 1 and softmaxes[0].args[1] in (-1, 3)


def test_exported_program_holds_no_span(model, symbolic):
    """The infer path's spans (``serve.infer`` is the eager callable's; the
    forward runs ``partnet.shape_encoder``) read the profiler's flag, which
    is off while exporting: no profiler node enters the graph, and the
    program still equals the eager forward."""
    names = [str(node.target) for node in symbolic.graph.nodes if node.op == "call_function"]
    assert not any("profiler" in name or "record_function" in name for name in names)
    x = _rand(3)
    got, want = symbolic.module()(x), make_infer_fn(model)(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_exported_program_matches_jax():
    jm, jp = jax_partnet(use_pallas=False)
    tm = torch_partnet(jp)
    program = export_infer(tm, img_size=32)
    x = images(7, 3, 32)
    want = jax_make_infer_fn(jm, jp)(x)
    got = program.module()(torch.from_numpy(x))
    for key, atol in {"logits": 1e-4, "heatmaps": 1e-5, "landmarks": 1e-5,
                      "sigma": 1e-5}.items():
        np.testing.assert_allclose(n(got[key]), np.asarray(want[key]), atol=atol, err_msg=key)
    np.testing.assert_array_equal(n(got["seg"]), np.asarray(want["seg"]))


@pytest.mark.parametrize("batch", [None, 2])
def test_export_cli_writes_and_verifies(tmp_path, capsys, batch):
    cfg = tmp_path / "tiny_cfg.py"
    cfg.write_text(TINY_TRAIN_CONFIG)
    out = tmp_path / "infer.pt2"
    argv = ["--config", str(cfg), "--out", str(out), "--cpu", "--verify"]
    main(argv + ([] if batch is None else ["--batch", str(batch)]))
    printed = capsys.readouterr().out
    assert "[export] verify OK" in printed and out.exists()
    assert f"in_shape=({batch or 'b'}, 16, 16, 3)" in printed
