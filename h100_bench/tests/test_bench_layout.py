"""The benchmark's files: BENCHMARK.json against the contract's shape, every
name found as a file, a cell, a mix, a configuration and a metric added as
files and found with no edit, and no import of JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import run as bench

BENCH_DIR = bench.BENCH_DIR
ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = spec_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["h100_bench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    used = {c["config"] for c in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith("h100_bench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", [c["name"] for c in spec_json()["workloads"]])
def test_every_cell_resolves_to_files(cell):
    spec = bench.load_spec(cell)
    assert (BENCH_DIR / "drivers" / f"{spec.traffic['driver']}.py").is_file()
    assert all(v is not None for v in spec.limits["limits"].values()), "a limit is not set"
    reported = bench.cell_metrics(spec, trace=False)
    assert {"setup_s"} < {m["name"] for m in reported}
    layer = bench.cell_metrics(spec, trace=True)
    assert layer and all((BENCH_DIR / "metrics" / f"{m['name']}.py").is_file() for m in layer)
    assert any("mfu" in m["name"] for m in layer)


ADDED = '''
import json, sys
sys.path.insert(0, sys.argv[1])
from h100_bench import run as bench
from h100_bench.tests import tiny
spec = bench.load_spec("added_cell")
tiny.shrink(spec)
r = bench.run("added_cell", 7, 0.5, True, device="cpu", spec=spec)
print(json.dumps(r["metrics"]))
'''


def test_cell_mix_config_and_metric_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell and
    a per-layer metric by new files and new entries of BENCHMARK.json alone;
    a run of the new cell finds them all."""
    shutil.copytree(BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec_json()
    cfg = json.loads((BENCH_DIR / "configs" / "celeba.json").read_text())
    cfg["name"] = "added_config"
    (tmp_path / "h100_bench/configs/added_config.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH_DIR / "traffic" / "infer_b256.json").read_text())
    (tmp_path / "h100_bench/traffic/added_mix.json").write_text(json.dumps(traffic))
    (tmp_path / "h100_bench/workloads/added_cell.json").write_text(json.dumps(
        {"limits": {k: 1.0 for k in ("landmark_err", "heatmap_err", "sigma_err")}}))
    (tmp_path / "h100_bench/metrics/added_metric.serve.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    b["configs"].append({"name": "added_config", "source": "a test", "reduced": ["vgg_weights"],
                         "file": "h100_bench/configs/added_config.json", "why": "a test"})
    b["workloads"].append({"name": "added_cell", "config": "added_config", "traffic": "added_mix",
                           "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] in ("infer_img_per_s", "serve_p95_ms"):
            m["workloads"].append("added_cell")
    b["per_layer"].append({"name": "added_metric.serve", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "serve_p95_ms",
                           "workloads": ["added_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    out = subprocess.run([sys.executable, "-c", ADDED, str(tmp_path)], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["added_metric.serve"]["value"] == 42.0


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_and_a_reference_apart_from_the_program():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & set(bench.FORBIDDEN), path
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert "partseg_tpu_torch" not in _imports(path), path


def test_runtime_guard_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "partseg_tpu_torch_fake", sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "partseg_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert bench.forbidden_modules() == ["jax"]
