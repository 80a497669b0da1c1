"""The port's quality study (partseg_tpu_torch/tools/quality_study.py)
against the JAX tool (tools/quality_study.py), on the CPU.

The arithmetic: both modules' ``run_variant`` replaced by one
deterministic fake that makes a row from (name, steps), then ``main_128``
(flagship and warp_every = 2 rungs; --scan 4; --seeds 2; an anchor whose
base_steps match and one whose do not), ``main_64`` and
``_aggregate_seeds`` run on both with the same rates: the step budgets,
the calls, the verdicts, ``fastest_passing_variant``, ``gate_pass`` and
the rows are equal (rows and result without the port's own keys: the
measured rates and the card). Rates measured through a fake bench child;
no rate taken on a TPU anywhere in the port; the study parent imports no
torch; and the study end to end on the CPU with two tiny variants, every
child real.
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from partseg_tpu_torch.tools import quality_study as pq

REPO = Path(__file__).resolve().parents[1]
PORT_ONLY_ROW_KEYS = {"img_s_chip_runs", "rate_source", "steps_at_rate_extremes", "wall_s"}
PORT_ONLY_RESULT_KEYS = {"card", "rate_protocol", "wall_s"}
JAX_RESULT_KEYS = {"mode", "base_steps", "seeds", "rows", "pass_at_equal_wallclock",
                   "fastest_passing_variant", "gate_pass"}


def _jax_study():
    spec = importlib.util.spec_from_file_location("jax_quality_study",
                                                  REPO / "tools" / "quality_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jq = _jax_study()


def fake_row(name: str, steps: int) -> dict:
    """A deterministic row from (name, steps): metrics that improve with
    steps, scattered by the name, so that verdicts go both ways (and the
    replicas of speed128_r5_wf25d32 do not learn: with --seeds 2 the
    fastest variant fails)."""
    u = np.random.default_rng(zlib.crc32(name.encode())).uniform(size=5)
    gain = math.log1p(steps / 100.0)
    return {
        "steps": steps,
        "landmark_err_pct_diag": round(1.2 - 0.15 * gain + 0.1 * u[0], 4),
        "equiv_last": round(0.01 / (1.0 + gain) + 0.001 * u[1], 5),
        "miou": round(0.1 + 0.04 * gain + 0.03 * u[2], 4),
        "fg_iou": round(0.1 + 0.05 * gain + 0.1 * u[3], 4),
        "learned": bool(u[4] > 0.15) and not name.startswith("speed128_r5_wf25d32_s"),
        "seg_abs_pass": bool(u[3] > 0.5),
    }


def patch_run_variant(monkeypatch, mod) -> list:
    calls = []

    def run_variant(name, overrides, steps, base_dir, **kw):
        calls.append((name, list(overrides), steps))
        return fake_row(name, steps)

    monkeypatch.setattr(mod, "run_variant", run_variant)
    return calls


def strip_port(result: dict) -> dict:
    out = {k: v for k, v in result.items() if k not in PORT_ONLY_RESULT_KEYS}
    out["rows"] = {n: {k: v for k, v in r.items() if k not in PORT_ONLY_ROW_KEYS}
                   for n, r in result["rows"].items()}
    return out


RUNGS = ["flagship", "speed128_r4", "speed128_r5_d32", "speed128_r5_wf25d32"]
RATES = {"flagship": 931.5, "speed128_r4": 1410.25, "speed128_r5_d32": 1702.0,
         "speed128_r5_wf25d32": 2222.75, "speed128": 1300.0, "speed128_r4_we3": 1500.5}


def test_variant_lists_equal_the_jax_tool():
    assert pq.VARIANTS_64 == jq.VARIANTS_64
    assert pq.PX128_BASE == jq.PX128_BASE
    assert (pq.FLAGSHIP_128, pq.SPEED128) == (jq.FLAGSHIP_128, jq.SPEED128)
    assert list(pq.VARIANTS_128) == list(jq.VARIANTS_128)
    for name, (overrides, _) in jq.VARIANTS_128.items():
        assert pq.VARIANTS_128[name] == overrides, name


@pytest.mark.parametrize("case", ["rungs_we2", "scan4", "seeds2", "we3_scan4"])
def test_main_128_matches_jax(case, monkeypatch, tmp_path):
    variants = RUNGS + (["speed128_r4_we3"] if case == "we3_scan4" else [])
    kw = {"rungs_we2": {}, "scan4": {"scan": 4}, "seeds2": {"seeds": 2},
          "we3_scan4": {"scan": 4}}[case]
    rates = {n: RATES[n] for n in variants}
    jax_calls = patch_run_variant(monkeypatch, jq)
    port_calls = patch_run_variant(monkeypatch, pq)
    want = jq.main_128(800, str(tmp_path / "jax"), variants, dict(rates), **kw)
    got = pq.main_128(800, str(tmp_path / "port"), variants, dict(rates), cpu=True, **kw)
    assert port_calls == jax_calls and len(jax_calls) == len(variants) * kw.get("seeds", 1)
    assert {n: r["steps"] for n, r in got["rows"].items()} == {
        n: r["steps"] for n, r in want["rows"].items()}
    assert strip_port(got) == want
    assert set(got) == JAX_RESULT_KEYS | PORT_ONLY_RESULT_KEYS and got["card"] is None
    assert all(got["rows"][n]["rate_source"] == "--rate" for n in variants)
    on_disk = json.loads((tmp_path / "port" / "result.json").read_text())
    assert strip_port(on_disk) == json.loads((tmp_path / "jax" / "result.json").read_text())
    # The budgets: a dispatch span's multiple, and the rate ratio rounded up to it.
    span = {"scan4": 4, "we3_scan4": 4}.get(case, 1)
    for n in variants:
        s = pq.dispatch_span(pq.VARIANTS_128[n], span)
        assert got["rows"][n]["steps"] % s == 0
        assert 0 <= got["rows"][n]["steps"] - 800 * rates[n] / rates["flagship"] < s + 0.5


@pytest.mark.parametrize("anchor_steps", [800, 600])
def test_main_128_anchor_matches_jax(anchor_steps, monkeypatch, tmp_path):
    patch_run_variant(monkeypatch, jq)
    anchor = tmp_path / "anchor"
    jq.main_128(anchor_steps, str(anchor), ["flagship", "speed128"],
                {"flagship": RATES["flagship"], "speed128": RATES["speed128"]})
    variants = ["speed128_r4", "speed128_r5_wf25d32"]
    rates = {n: RATES[n] for n in variants}
    jax_calls = patch_run_variant(monkeypatch, jq)
    port_calls = patch_run_variant(monkeypatch, pq)
    args = dict(anchor_json=str(anchor / "result.json"))
    if anchor_steps != 800:
        with pytest.raises(SystemExit) as want:
            jq.main_128(800, str(tmp_path / "jax"), variants, dict(rates), **args)
        with pytest.raises(SystemExit) as got:
            pq.main_128(800, str(tmp_path / "port"), variants, dict(rates), cpu=True, **args)
        assert str(got.value) == str(want.value) and "not comparable" in str(got.value)
        assert port_calls == jax_calls == []
        return
    want = jq.main_128(800, str(tmp_path / "jax"), variants, dict(rates), **args)
    got = pq.main_128(800, str(tmp_path / "port"), variants, dict(rates), cpu=True, **args)
    assert port_calls == jax_calls and [c[0] for c in port_calls] == variants
    assert strip_port(got) == want
    assert set(got["rows"]) == {"flagship", "speed128", *variants}


def test_main_64_matches_jax(monkeypatch, tmp_path):
    jax_calls = patch_run_variant(monkeypatch, jq)
    port_calls = patch_run_variant(monkeypatch, pq)
    want = jq.main_64(300, str(tmp_path / "jax"))
    got = pq.main_64(300, str(tmp_path / "port"))
    assert got == want and port_calls == jax_calls and len(port_calls) == 2


def test_aggregate_seeds_matches_jax():
    per_seed = {s: fake_row(f"speed128_r4_s{s}", 1000 + 16 * s) for s in range(3)}
    assert pq._aggregate_seeds(dict(per_seed)) == jq._aggregate_seeds(dict(per_seed))


FAKE_BENCH = """
import json, pathlib, sys
log = pathlib.Path(sys.argv[1])
n = len(log.read_text().splitlines()) if log.exists() else 0
with log.open("a") as f:
    f.write(" ".join(sys.argv[2:]) + "\\n")
print("warm-up chatter")
print(json.dumps({"metric": "train_throughput_128px", "value": float(sys.argv[2]) + 10 * n}))
"""


def test_rates_are_measured_in_turns_by_bench_children(monkeypatch, tmp_path):
    """Each variant without --rate is measured by bench children, round
    by round in turns; the median is its rate and the row keeps the
    rounds. The card is recorded."""
    script = tmp_path / "fake_bench.py"
    script.write_text(FAKE_BENCH)
    log = tmp_path / "bench.log"
    base = {"flagship": 500.0, "speed128_r5_wf25d32": 1000.0}
    commands = []
    real_command = pq.bench_command

    def bench_command(overrides):
        commands.append(real_command(overrides))
        name = next(n for n, ov in pq.VARIANTS_128.items() if ov == list(overrides))
        return [sys.executable, str(script), str(log), str(base[name])]

    monkeypatch.setattr(pq, "bench_command", bench_command)
    monkeypatch.setattr(pq, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    calls = patch_run_variant(monkeypatch, pq)
    variants = ["flagship", "speed128_r5_wf25d32", "speed128_r4"]
    got = pq.main_128(40, str(tmp_path / "study"), variants, {"speed128_r4": 777.0})
    # Rounds in turns: flagship, wf25d32, flagship, wf25d32, ...
    assert [line.split()[0] for line in log.read_text().splitlines()] == ["500.0", "1000.0"] * 3
    flag, fast = got["rows"]["flagship"], got["rows"]["speed128_r5_wf25d32"]
    assert flag["img_s_chip_runs"] == [500.0, 520.0, 540.0] and flag["img_s_chip"] == 520.0
    assert fast["img_s_chip_runs"] == [1010.0, 1030.0, 1050.0] and fast["img_s_chip"] == 1030.0
    assert flag["rate_source"] == fast["rate_source"] == "measured"
    assert got["rows"]["speed128_r4"]["rate_source"] == "--rate"
    assert "img_s_chip_runs" not in got["rows"]["speed128_r4"]
    assert flag["steps_at_rate_extremes"] == [pq.step_budget(40, 500.0, 540.0, 1),
                                              pq.step_budget(40, 540.0, 500.0, 1)]
    assert fast["steps"] == pq.step_budget(40, 1030.0, 520.0, 2) == 80
    assert fast["steps_at_rate_extremes"] == [pq.step_budget(40, 1010.0, 540.0, 2),
                                              pq.step_budget(40, 1050.0, 500.0, 2)]
    assert got["rows"]["speed128_r4"]["steps"] == pq.step_budget(40, 777.0, 520.0, 2)
    assert [c[0] for c in calls] == variants
    assert got["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert got["rate_protocol"]["batch"] == 64 and got["rate_protocol"]["rounds"] == 3
    # The real command: the port's bench on the synthetic preset at the study's batch.
    cmd = commands[0]
    assert cmd[1:9] == ["-m", "partseg_tpu_torch.bench", "--config", "synthetic",
                        "--batch", "64", "--steps", "20"]
    assert cmd[cmd.index("--set") + 1:] == pq.PX128_BASE + pq.VARIANTS_128["flagship"]


def test_cpu_study_needs_every_rate(monkeypatch, tmp_path):
    calls = patch_run_variant(monkeypatch, pq)
    with pytest.raises(SystemExit, match="--rate"):
        pq.main_128(40, str(tmp_path), ["flagship", "speed128"], {"flagship": 1.0}, cpu=True)
    assert calls == []


def test_no_tpu_rate_in_the_port():
    """The JAX tool's TPU rates (and those of its archived studies) appear
    in no file of the port; every VARIANTS_128 entry is an override list."""
    for path in (REPO / "partseg_tpu_torch").rglob("*"):
        if path.is_file() and path.suffix in {".py", ".cu", ".cuh", ".md", ".json"}:
            text = path.read_text()
            for number in ("824.6", "2818", "21242", "21,242", "24780", "24,780"):
                assert number not in text, f"{path.relative_to(REPO)} holds {number}"
    assert all(isinstance(v, list) for v in pq.VARIANTS_128.values())


def test_study_parent_imports_no_torch():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, partseg_tpu_torch.tools.quality_study; "
                               "print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "False"


TINY_BASE = [
    "model.img_size=16",
    "model.n_parts=3",
    "dataset_kwargs=(('size',16),('n_blobs',3),('n_examples',256))",
    "global_batch=8",
    "optim.decay_steps=200",
    "optim.warmup_steps=2",
]
TINY_FLAGSHIP = [
    "model.features=16", "model.app_features=8", "model.depth=1", "model.decoder_scales=2",
    "model.decoder_features=(16,8)", "loss.vgg_layers=('relu1_2',)", "loss.vgg_trim_blocks=1",
]


def test_study_end_to_end_on_the_cpu(monkeypatch, tmp_path):
    """Two tiny variants (16 px, K = 3, depth 1) through real children: the
    train CLI, validate_synthetic --eval_only and validate_segmentation,
    each with --cpu / --device cpu. TensorBoard is stubbed out of the
    children (a sitecustomize on their PYTHONPATH), as the loop's tests do."""
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(stub), str(REPO)]))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(pq, "PX128_BASE", TINY_BASE)
    monkeypatch.setattr(pq, "VARIANTS_128", {
        "flagship": TINY_FLAGSHIP, "fast": TINY_FLAGSHIP + ["augment.warp_every=2"]})
    base = tmp_path / "study"
    rc = pq.main(["--variants", "flagship,fast", "--base_steps", "8", "--cpu",
                  "--base_dir", str(base), "--rate", "flagship=100", "--rate", "fast=150"])
    result = json.loads((base / "result.json").read_text())
    assert JAX_RESULT_KEYS <= set(result) and result["card"] is None
    assert rc == (0 if result["gate_pass"] else 1)
    assert {n: r["steps"] for n, r in result["rows"].items()} == {"flagship": 8, "fast": 12}
    for name, row in result["rows"].items():
        assert isinstance(row["learned"], bool) and isinstance(row["seg_abs_pass"], bool)
        for k in ("landmark_err_pct_diag", "equiv_last", "miou", "fg_iou", "img_s_chip"):
            assert math.isfinite(row[k]), (name, k, row[k])
        assert (base / name / "checkpoints" / f"{row['steps']}.pt").exists()
        assert row["wall_s"]["train"] > 0 and row["wall_s"]["evaluate"] > 0
    assert set(result["pass_at_equal_wallclock"]) == {"fast"}
