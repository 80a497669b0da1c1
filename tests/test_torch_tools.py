"""The port's tools (partseg_tpu_torch/tools/) on the CPU, against the JAX
package's tools/ where both can run: trace_step (its categories and a
tiny trace whose category sums equal the total), profile_components
(every JAX row, timed), bench_infer (both paths, the exported program
equal to eager), feed_bench (the thread-pool backend's keys; a backend
that cannot run fails the tool), nan_bisect (a NaN injected at a known
step found from the checkpoint before it, the faulting module named),
probe_warp_parity and convert_penn_action (the same npz arrays as the
JAX tool's). The tools import nothing of JAX, of partseg_tpu, of tools/
or of configs/.
"""

import ast
import importlib.util
import io
import json
import math
import os
import shutil
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from partseg_tpu_torch.data import synthetic
from partseg_tpu_torch.data.loader import batch_indices
from partseg_tpu_torch.models.partnet import PartNetConfig
from partseg_tpu_torch.tools import (
    bench_infer,
    convert_penn_action,
    feed_bench,
    nan_bisect,
    probe_warp_parity,
    profile_components,
    trace_step,
)

REPO = Path(__file__).resolve().parents[1]
TOOLS = ("quality_study", "trace_step", "profile_components", "bench_infer", "feed_bench",
         "nan_bisect", "probe_warp_parity", "convert_penn_action")
TINY = ["model.img_size=16", "model.features=16", "model.depth=1", "model.app_features=8",
        "model.decoder_scales=2", "model.n_parts=3", "loss.vgg_layers=('relu1_2',)",
        "loss.vgg_trim_blocks=1"]

torch.set_num_threads(2)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_tools_are_ported_and_import_nothing_of_the_reference():
    port = REPO / "partseg_tpu_torch" / "tools"
    for name in TOOLS:
        assert (port / f"{name}.py").is_file() and (REPO / "tools" / f"{name}.py").is_file()
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "grain", "tensorflow",
              "partseg_tpu", "tools", "configs"}
    for path in sorted(port.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = {node.module.split(".")[0]}
            else:
                continue
            assert not names & banned, f"{path.name} imports {sorted(names & banned)}"


# ------------------------------------------------------------------ trace_step

# Kernel names of the card's profiles (PERF.md §5) and the category each
# belongs to; the first matching category wins.
CATEGORISED = [
    ("void softmax_moments_kernel<true>(SoftmaxMomentsArgs)", "softmax_moments"),
    ("void render_assemble_kernel<8, 4>(RenderArgs)", "render_assemble"),
    ("void render_assemble_bwd_kernel(...)", "other"),
    ("void tps_warp_kernel<__nv_bfloat16, false>(TpsArgs)", "tps_warp"),
    ("void bilinear_sample_kernel<float, 3, false>(...)", "bilinear_sample"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<c10::BFloat16>",
     "group_norm"),
    ("void at::native::(anonymous namespace)::ComputeFusedParamsCUDAKernel<float>",
     "group_norm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv_matmul"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", "conv_matmul"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16", "conv_matmul"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>",
     "optimizer_foreach"),
    ("void at::native::index_elementwise_kernel<128, 4, ...>", "scatter_index"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>",
     "softmax_argmax"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "softmax_argmax"),
    ("void at::native::(anonymous namespace)::upsample_nearest2d_nhwc_out_frame",
     "pool_upsample_cat"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>", "pool_upsample_cat"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add>",
     "elementwise_copy"),
    ("void at::native::elementwise_kernel<128, 2, ...>", "elementwise_copy"),
    ("Memcpy HtoD (Pinned -> Device)", "other"),
    ("Memset (Device)", "other"),
]


@pytest.mark.parametrize("name,want", CATEGORISED, ids=[w + str(i) for i, (_, w)
                                                        in enumerate(CATEGORISED)])
def test_trace_categories(name, want):
    assert trace_step.category(name) == want


def test_chip_smoke_takes_the_categories_from_trace_step():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    assigned = {t.id for node in tree.body if isinstance(node, ast.Assign)
                for t in node.targets if isinstance(t, ast.Name)}
    assert not {n for n in assigned if "CATEGORIES" in n or n == "BACKWARD_NODES"}
    imports = {(node.module, a.name) for node in ast.walk(tree)
               if isinstance(node, ast.ImportFrom) for a in node.names}
    assert ("partseg_tpu_torch.tools", "trace_step") in imports
    uses = {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "trace_step"}
    assert {"profile_window", "summarize"} <= uses


def test_trace_step_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("TRACE_BATCH", "2")
    monkeypatch.setenv("TRACE_CONFIG", "synthetic")
    monkeypatch.setenv("TRACE_SET", " ".join(TINY + ["augment.warp_every=2"]))
    monkeypatch.setattr(trace_step, "TRACE_DIR", str(tmp_path / "trace"))
    out = io.StringIO()
    with redirect_stdout(out):
        result = trace_step.main(device="cpu")
    assert Path(result["trace"]).is_file() and Path(result["trace"]).stat().st_size > 0
    assert result["sub_steps"] == 4 and result["batch"] == 2
    cats = result["by_category_ms_per_step"]
    assert math.isclose(sum(cats.values()), result["device_ms_per_step"], rel_tol=1e-9)
    assert result["device_ms_per_step"] > 0 and 0 <= result["idle_share"] < 1
    assert "conv_matmul" in cats and "group_norm" in cats
    assert len(result["top_kernels"]) == 30
    text = out.getvalue()
    assert "== categories ==" in text and _json_lines(text)[-1] == json.loads(json.dumps(result))


# ---------------------------------------------------------- profile_components

def test_profile_components_prints_every_jax_row(monkeypatch, capsys):
    tree = ast.parse((REPO / "tools" / "profile_components.py").read_text())
    jax_rows = [node.args[0].value for node in ast.walk(tree)
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "bench" and node.args
                and isinstance(node.args[0], ast.Constant)]
    assert len(jax_rows) == 12
    monkeypatch.setattr(profile_components, "B", 2)
    monkeypatch.setattr(profile_components, "S", 32)
    monkeypatch.setattr(profile_components, "CFG", PartNetConfig(
        n_parts=3, img_size=32, features=16, depth=2, app_features=8, decoder_scales=2,
        decoder_features=(16, 8)))
    rows = profile_components.main(device="cpu")
    assert [r["name"] for r in rows] == jax_rows
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 and r["batch"] == 2 for r in rows)
    out = capsys.readouterr().out
    for name in jax_rows:
        assert sum(line.startswith(name + " ") for line in out.splitlines()) == 1, name
    assert [r["name"] for r in _json_lines(out)] == jax_rows


# ------------------------------------------------------------------ bench_infer

JAX_INFER_KEYS = {"metric", "path", "value", "unit", "batch", "img_size", "config"}


def test_bench_infer_both_paths(capsys):
    result = bench_infer.main(["--cpu", "--batch", "2", "--steps", "1", "--config", "synthetic"])
    lines = _json_lines(capsys.readouterr().out)
    assert [line["path"] for line in lines] == ["eager", "exported"]
    for line in lines:
        assert JAX_INFER_KEYS <= set(line) and line["metric"] == "infer_throughput"
        assert line["unit"] == "img/s/chip" and line["batch"] == 2 and line["img_size"] == 64
        assert line["value"] > 0
    assert set(lines[0]) == JAX_INFER_KEYS
    errs = lines[1]["max_abs_vs_eager"]
    assert set(errs) == {"heatmaps", "logits", "landmarks", "sigma", "seg"}
    assert all(v == 0.0 for v in errs.values()), errs
    assert result["exported"] == lines[1]


# ------------------------------------------------------------------- feed_bench

JAX_FEED_KEYS = {"backend", "dtype", "batches_per_s", "img_per_s", "src_wh", "scaled_decode",
                 "metric", "unit", "demand_img_per_s", "vs_demand", "host_cores",
                 "img_per_s_per_core", "cores_needed_at_this_rate", "n_images", "batch",
                 "workers"}


def _feed_args(tmp_path, backends):
    return ["--dir", str(tmp_path / "jpegs"), "--n_images", "16", "--src_wh", "40x48",
            "--size", "32", "--batch", "4", "--batches", "4", "--warmup", "1",
            "--workers", "2", "--demand", "250", "--chips", "2", "--backends", backends]


def test_feed_bench_thread_pool(tmp_path, capsys):
    rows = feed_bench.main(_feed_args(tmp_path, "grain"))
    (line,) = _json_lines(capsys.readouterr().out)
    assert line == rows[0] and set(line) == JAX_FEED_KEYS
    assert line["backend"] == "grain" and line["dtype"] == "float32"
    assert line["demand_img_per_s"] == 500.0
    assert line["vs_demand"] == round(line["img_per_s"] / 500.0, 3)
    assert len(list((tmp_path / "jpegs" / "40x48").glob("*.jpg"))) == 16
    with pytest.raises(SystemExit):      # --demand has no default
        feed_bench.main(_feed_args(tmp_path, "grain")[:-6] + ["--backends", "grain"])


def test_feed_bench_backend_that_cannot_run_fails_the_tool(tmp_path, capsys, monkeypatch):
    import partseg_tpu_torch.data.native as native

    def no_library():
        raise OSError("libjpeg.so.8: cannot open shared object file")

    monkeypatch.setattr(native, "_load_lib", no_library)
    with pytest.raises(SystemExit) as exit_:
        feed_bench.main(_feed_args(tmp_path, "native,grain"))
    assert exit_.value.code not in (0, None)
    native_line, pool_line = _json_lines(capsys.readouterr().out)
    assert native_line["backend"] == "native" and "libjpeg" in native_line["error"]
    assert "img_per_s" not in native_line and "error" not in pool_line


# ------------------------------------------------------------------- nan_bisect

NAN_RUN = TINY + ["dataset_kwargs=(('size',16),('n_blobs',3),('n_examples',256))",
                  "global_batch=4", "steps=40", "optim.warmup_steps=2"]
NAN_STEP = 23          # the batch that carries NaN images (first epoch: 64 batches of 4)


def test_nan_bisect_finds_the_first_faulting_module(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    poisoned = set(next(b for i, b in enumerate(batch_indices(256, 4, seed=0))
                        if i == NAN_STEP).tolist())
    render = synthetic.SyntheticBlobs.__getitem__

    def getitem(self, idx):
        out = render(self, idx)
        if self.seed == 0 and int(idx) in poisoned:       # the train split only
            out = {**out, "image": np.full_like(out["image"], np.nan)}
        return out

    monkeypatch.setattr(synthetic.SyntheticBlobs, "__getitem__", getitem)
    run = str(tmp_path / "run")
    nan_bisect.phase_card(run, NAN_RUN, device="cpu")
    hist = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [h["step"] for h in hist] == [0, 10, 20, 30, 39]
    assert all(math.isfinite(h["loss"]) for h in hist[:3]) and math.isnan(hist[3]["loss"])
    capsys.readouterr()
    with pytest.raises(FloatingPointError, match=r"module model\.shape_enc\.stem\.conv "):
        nan_bisect.phase_cpu(run, NAN_RUN)
    out = capsys.readouterr().out
    assert "first NaN logged at step 30; restoring step 20" in out
    assert "=== NaN raised at step 23 ===" in out
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert [s.split(":")[0] for s in steps] == ["step 20", "step 21", "step 22"]
    # The restored step repeats the logged one.
    assert abs(float(steps[0].split()[-1]) - hist[2]["loss"]) <= 1e-5


def test_nan_bisect_refuses_a_warp_period(tmp_path):
    with pytest.raises(SystemExit, match="per-step granularity"):
        nan_bisect.phase_cpu(str(tmp_path), ["augment.warp_every=2"])


# ------------------------------------------------------------ probe_warp_parity

def test_probe_warp_parity_on_the_cpu(capsys):
    result = probe_warp_parity.main(device="cpu")
    out = capsys.readouterr().out
    for head in ("smooth: max", "worst at (b,y,x,c):", "interior max:", "row max profile",
                 "col max profile", "explicit-flow fused vs gather: max"):
        assert head in out
    assert result["tps_warp"]["interior_max"] <= 1e-5 and result["tps_warp"]["max"] <= 1e-5
    assert result["bilinear_sample"]["max"] == 0.0
    assert _json_lines(out)[-1] == result


# ---------------------------------------------------------- convert_penn_action

def test_convert_penn_action_matches_jax(tmp_path):
    from scipy.io import savemat

    rng = np.random.default_rng(0)
    src = tmp_path / "src" / "labels"
    src.mkdir(parents=True)
    for seq, t in (("0001", 5), ("0002", 7)):
        savemat(src / f"{seq}.mat", {
            "x": rng.uniform(0, 480, (t, 13)), "y": rng.uniform(0, 270, (t, 13)),
            "visibility": rng.uniform(size=(t, 13)) > 0.2, "train": np.array([[t % 2]]),
            "bbox": rng.uniform(0, 200, (t, 4))})
    roots = {}
    for side in ("jax", "port"):
        roots[side] = tmp_path / side
        shutil.copytree(tmp_path / "src", roots[side])
    jax_tool = _load(REPO / "tools" / "convert_penn_action.py", "jax_convert_penn_action")
    assert jax_tool.convert(roots["jax"]) == convert_penn_action.convert(roots["port"]) == 2
    for seq in ("0001", "0002"):
        with np.load(roots["jax"] / "labels" / f"{seq}.npz") as want, \
                np.load(roots["port"] / "labels" / f"{seq}.npz") as got:
            assert sorted(got.files) == sorted(want.files) == ["train", "visibility", "x", "y"]
            for k in want.files:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                assert got[k].tobytes() == want[k].tobytes(), (seq, k)
    assert not os.path.exists(roots["port"] / "labels" / "0003.npz")
