"""The benchmark of partseg_tpu_torch on NVIDIA H100s.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. A cell of ``BENCHMARK.json`` names a
configuration (``h100_bench/configs/<config>.json``) and a traffic mix
(``h100_bench/traffic/<traffic>.json``); the mix names its driver
(``h100_bench/drivers/<driver>.py``), and the cell's correctness limits are
in ``h100_bench/workloads/<cell>.json``. Each per-layer metric is read by
``h100_bench/metrics/<metric>.py``. Adding a cell, a mix or a metric is
adding those files.

A run builds the program with weights and inputs made on the device from
``--seed``, warms up every shape (the set-up), measures for ``--seconds``,
and prints one JSON line last: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1`` (torch.profiler over
a short sub-window at the end of the measured window). Once the window has
closed, the program's state is freed and the benchmark's plain reference
checks what the timed path produced; the numbers compared and their limits
are the last lines on standard error and the last key of the result.

``--variant`` (not for the benchmark's own runs) swaps the program for its
float8 control (``control``) or plants a fault (``frozen_state``,
``half_batch``, ``altered_answer``), to show that the check fails them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # the process's start, as near as Python gets: set-up counts from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "partseg_tpu")
VARIANTS = ("program", "control", "frozen_state", "half_batch", "altered_answer")


class NoDevice(RuntimeError):
    pass


def process_age() -> float:
    """Seconds since this process started (the kernel's start time; ``T0``
    where /proc cannot tell)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T0


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so that
    only a checkout's first run builds (the program's CUDA kernels go to
    ``build/kernels`` beside its package, by its own rule)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("VGG19_NPZ", None)


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark must not load,
    compared whole (``partseg_tpu_torch`` is not ``partseg_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_file(path: Path):
    """The module in ``path`` (a driver or a metric reader), loaded by path."""
    spec = importlib.util.spec_from_file_location(f"h100_bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Spec:
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    limits: dict


def load_spec(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Spec:
    bench = json.loads(bench_path.read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path.name}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "workloads" / f"{workload}.json").read_text())
    return Spec(bench, cell, config, traffic, limits)


def cell_metrics(spec: Spec, trace: bool) -> list[dict]:
    """The metrics this cell reports: end-to-end with trace off, per-layer with it on."""
    name = spec.cell["name"]
    e2e = [m for m in spec.bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec.bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


class LayerCtx:
    """What a per-layer reader may read: the cell, the untraced part of the
    window, the profiled sub-window, the host's dispatch times and the FLOPs
    of the cell's work."""

    def __init__(self, spec: Spec, window: dict, traced, host_ms: list, flops_per_image: float,
                 chips: int):
        self.config, self.traffic, self.chips = spec.config, spec.traffic, chips
        self.window, self.traced, self.host_ms = window, traced, host_ms
        self.flops_per_image = flops_per_image

    def mfu(self) -> float:
        """% of the chips' bf16 peak that the window's images/s reaches on the reference's FLOPs."""
        from h100_bench.peaks import BF16_FLOPS_PER_S

        rate = self.window["images"] / self.window["seconds"]
        return 100.0 * rate * self.flops_per_image / (self.chips * BF16_FLOPS_PER_S)

    def roofline(self, kernels, bound_ms_per_unit: float) -> float | None:
        """% of the bound that the named kernels' device time per unit reaches."""
        ms = self.traced.ms_per_unit(kernels)
        return None if ms is None else 100.0 * bound_ms_per_unit / ms

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.traced.busy_s / self.traced.wall_s)


def nvidia_smi() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(workload: str, seed: int, seconds: float, trace: bool, variant: str = "program",
        device: str | None = None, spec: Spec | None = None) -> dict:
    """One run of ``workload``; returns the result line as a dict. ``device``
    None means the CUDA card (raising NoDevice without enough of them); the
    tests pass "cpu" with a ``spec`` at a tiny size."""
    import torch

    spec = spec or load_spec(workload)
    chips = int(spec.cell["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"{workload} needs {chips} CUDA device(s); "
                           f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    driver = load_file(BENCH_DIR / "drivers" / f"{spec.traffic['driver']}.py")
    before = process_age()
    state = driver.setup(spec, seed, device, variant)
    setup_s = process_age()
    parts = {"start_and_imports": before, **state.parts.seconds}
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"the benchmark's process holds {bad} after set-up")
    metrics_spec = cell_metrics(spec, trace)
    traced_units = int(spec.traffic["trace_units"]) if trace else 0
    window = driver.window(state, seconds, traced_units)
    host_ms = driver.host_dispatch(state, int(spec.traffic["host_dispatch_calls"])) if trace else []
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    driver.release(state)
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"the benchmark's process holds {bad} once the window has closed")
    values = {"setup_s": setup_s}
    breakdown, device_extra = None, {}
    if trace:
        from h100_bench import flops

        traced = window.pop("traced")
        ctx = LayerCtx(spec, window, traced, host_ms,
                       flops.per_image(spec.config, spec.traffic["entry"], device), chips)
        for m in metrics_spec:
            value = load_file(BENCH_DIR / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                values[m["name"]] = value
        breakdown = {"device_ops": traced.top_ops(), "idle_gaps": traced.gaps}
        device_extra = {"busy_s": traced.busy_s, "window_s": traced.wall_s}
    else:
        values.update(window["end_to_end"])
    checks = driver.check(state)
    limits = spec.limits["limits"]
    compared = {k: {"value": checks.get(k, math.nan), "limit": lim} for k, lim in limits.items()}
    correct = all(lim is not None and math.isfinite(c["value"]) and c["value"] <= lim
                  for c, lim in zip(compared.values(), limits.values())) and window["failed"] == 0
    result = {
        "correct": correct,
        "attempted": window["attempted"],
        "failed": window["failed"],
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in metrics_spec if m["name"] in values},
        "device": {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
                   "count": chips, "memory_peak_bytes": int(peak), **device_extra},
        "power_limit": nvidia_smi() if device == "cuda" else "none",
        "variant": variant,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["detail"] = {k: v for k, v in checks.items() if k not in limits}
    result["setup_parts_s"] = parts
    result["checks"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", default="program", choices=VARIANTS)
    args = ap.parse_args(argv)
    set_cache_dirs()
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), args.variant)
    except NoDevice as e:
        print(f"[h100_bench] {e}", file=sys.stderr)
        return 3
    except ImportError as e:
        print(f"[h100_bench] {e}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
