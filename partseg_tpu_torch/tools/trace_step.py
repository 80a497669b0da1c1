"""Trace the train step with torch.profiler and print where the device
time goes, the port's twin of tools/trace_step.py.

    TRACE_BATCH=128 TRACE_CONFIG=speed128 python -m partseg_tpu_torch.tools.trace_step [--cpu]

The JAX tool's environment: TRACE_BATCH (default 64), TRACE_CONFIG (a
preset of ``partseg_tpu_torch/configs.py``, or a config file; default the
flagship 128 px model, ``PartNetConfig(n_parts=10, img_size=128)`` with
every other field at its default) and TRACE_SET (space-separated
``KEY=VAL`` overrides). The period is ``bench.build_trainer``'s: seeded
random weights, one device-resident batch of random images per sub-step.
After one warm-up period, 2 dispatches (3 when ``warp_every == 1``) run
under ``torch.profiler`` with CPU and CUDA activities and
``with_flops=True``; the Chrome trace goes to
``<temp dir>/partseg_trace/trace.json``.

``print_trace_breakdown`` reads the profile and prints, per optimizer
sub-step (the window's totals divided by dispatches × warp_every): the
total device ms, ms by kernel category (``CATEGORIES``, first match
wins), the top 30 kernels (ms per step, %, calls), the idle share
(1 − device time / wall time of the window; one stream, so kernels do
not overlap) and the top host ops by self CPU time. torch.profiler
records no bytes per kernel, so there is no GB/s column; it counts FLOPs
for the host ops that launch convolutions and matrix products, and for
those the host-op table gives TF/s (their FLOPs over the device time of
the kernels they launched). With --cpu there are no CUDA kernels: the
CPU ops' self times take their place. The program's spans are on in the
window (``tracing``); the span table follows: name, calls, device ms per
call. The last line is the breakdown as JSON.

``chip_smoke.py``'s phase ``profile`` aggregates its windows with
``summarize`` and the same categories.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from partseg_tpu_torch import tracing

CATEGORIES = (   # (category, lower-case kernel-name substrings), first match wins
    ("softmax_moments", ("softmax_moments_kernel",)),
    ("render_assemble", ("render_assemble_kernel",)),
    ("tps_warp", ("tps_warp_kernel",)),
    ("bilinear_sample", ("bilinear_sample_kernel",)),
    ("group_norm", ("rowwisemoments", "fusedparams", "groupnorm", "group_norm",
                    "compute_internal_gradients", "gamma_beta")),
    ("conv_matmul", ("conv", "xmma", "gemm", "cutlass", "fprop", "dgrad", "wgrad", "cudnn",
                     "sm90_", "sm80_")),
    ("optimizer_foreach", ("foreach", "multi_tensor")),
    ("scatter_index", ("index", "scatter", "gather")),
    ("softmax_argmax", ("softmax", "argmax", "reduce")),
    ("pool_upsample_cat", ("pool", "upsample", "cat")),
    ("elementwise_copy", ("elementwise", "copy", "cast", "vectorized")),
)

# The kernel wrappers' backward nodes: softmax_moments' is the one autograd
# generates for the registered op; the others are autograd Functions.
BACKWARD_NODES = ("GeneratedBackwardFor_partseg_softmax_moments_defaultBackward",
                  "_RenderAssembleBackward", "_TPSWarpBackward", "_BilinearSampleBackward")

TRACE_DIR = os.path.join(tempfile.gettempdir(), "partseg_trace")


def category(name: str) -> str:
    """The category of a kernel (or, on the CPU, an op) by its name."""
    low = name.lower()
    return next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")


def on_device(e) -> bool:
    """A kernel, memset or copy on the card; not an annotation (a span of
    ``tracing`` or NCCL's range), which the profiler lists on the card's
    timeline over the kernels it covers."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def device_us(prof) -> float:
    """The self time of every CUDA kernel, memset and copy in a window, µs."""
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if on_device(e))


def profile_window(fn, calls: int, cuda: bool, with_flops: bool = False, windows: int = 3):
    """(prof, wall ms): ``calls`` calls of ``fn`` under torch.profiler,
    ending in a synchronisation on the card. CUPTI now and then delivers a
    window with no device activity at all: on the card such a window is
    taken again, up to ``windows`` in all, and the last one is returned
    whatever it holds (``device_us`` tells)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(windows if cuda else 1):
        with profile(activities=acts, with_flops=with_flops) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if not cuda or device_us(prof) > 0:
            break
    return prof, wall_ms


def summarize(prof, wall_ms: float, cuda: bool, top_kernels: int = 10,
              top_host: int = 10) -> dict:
    """The window's totals: device ms (the kernels' self time; on the CPU,
    the ops'), the idle share, kernel launches, ms by category, the top
    kernels, the top host ops by self CPU time (with FLOPs and TF/s where
    the profiler counted them) and the kernel wrappers' backward nodes."""
    events = prof.key_averages()
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    if cuda:
        kernels = [e for e in events if on_device(e)]
        own = {id(e): getattr(e, "self_device_time_total", 0.0) for e in kernels}
    else:
        kernels = host
        own = {id(e): e.self_cpu_time_total for e in kernels}
    busy = {}
    for e in kernels:
        cat = category(e.key)
        busy[cat] = busy.get(cat, 0.0) + own[id(e)] / 1e3
    total = sum(busy.values())
    top = sorted(kernels, key=lambda e: -own[id(e)])[:top_kernels]
    host_rows = []
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top_host]:
        row = {"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
        if e.flops and cuda and e.device_time_total > 0:
            row.update(gflop=e.flops / 1e9,
                       tf_per_s=e.flops / (e.device_time_total * 1e-6) / 1e12)
        host_rows.append(row)
    return {
        "device_ms": total,
        "idle_share": (1 - total / wall_ms) if wall_ms > 0 else None,
        "kernel_launches": sum(e.count for e in kernels),
        "by_category_ms": dict(sorted(busy.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "ms": own[id(e)] / 1e3, "calls": e.count}
                        for e in top],
        "top_host_ops": host_rows,
        "backward_nodes": {e.key: {"cpu_ms": e.cpu_time_total / 1e3, "calls": e.count}
                           for e in host if e.key in BACKWARD_NODES},
    }


def print_trace_breakdown(prof, wall_ms: float, n_steps: float, cuda: bool) -> dict:
    """Print the window's breakdown per sub-step (totals / ``n_steps``) and
    return it: device and wall ms per step, the idle share, ms per step by
    category, the top 30 kernels and the top host ops."""
    s = summarize(prof, wall_ms, cuda, top_kernels=30, top_host=15)
    total = s["device_ms"]
    what = "device" if cuda else "CPU-op"
    print(f"total {what} time: {total:.3f} ms ({total / n_steps:.3f} ms/step); wall "
          f"{wall_ms / n_steps:.3f} ms/step; idle share {s['idle_share']:.4f}")
    print("== categories ==")
    for name, ms in s["by_category_ms"].items():
        print(f"{ms / n_steps:9.3f} ms/step {100 * ms / total:5.1f}%  {name}")
    print("== top kernels ==" if cuda else "== top CPU ops (self time) ==")
    for k in s["top_kernels"]:
        print(f"{k['ms'] / n_steps:9.3f} ms/step {100 * k['ms'] / total:5.1f}% "
              f"{k['calls'] / n_steps:7.1f} calls/step  {k['name']}")
    print("== top host ops (self CPU; TF/s where the profiler counts FLOPs) ==")
    for h in s["top_host_ops"]:
        rate = f"{h['tf_per_s']:7.2f} TF/s" if "tf_per_s" in h else " " * 12
        print(f"{h['self_cpu_ms'] / n_steps:9.3f} ms/step {rate} "
              f"{h['calls'] / n_steps:7.1f} calls/step  {h['name']}")
    return {
        "device_ms_per_step": total / n_steps,
        "wall_ms_per_step": wall_ms / n_steps,
        "idle_share": s["idle_share"],
        "kernel_launches_per_step": s["kernel_launches"] / n_steps,
        "by_category_ms_per_step": {k: v / n_steps for k, v in s["by_category_ms"].items()},
        "top_kernels": [{**k, "ms": k["ms"] / n_steps, "calls": k["calls"] / n_steps}
                        for k in s["top_kernels"]],
        "top_host_ops": s["top_host_ops"],
    }


def print_spans() -> dict:
    """Print the registry's spans (``tracing``: name, calls, device ms per
    call; on the CPU no device time) and return them. Spans run only under
    the profiler, so in a process that profiled nothing before they are the
    window's."""
    spans = tracing.snapshot()["spans"]
    print("== spans (device ms per call) ==")
    for name, s in sorted(spans.items()):
        ms = s["device_ms"]
        per = "no device" if ms is None else f"{ms / s['calls']:9.3f} ms"
        print(f"{per:>12} {s['calls']:7d} calls  {name}")
    return {name: {"calls": s["calls"],
                   "device_ms_per_call": None if s["device_ms"] is None
                   else s["device_ms"] / s["calls"]}
            for name, s in spans.items()}


def trace_config():
    """The traced config and batch, from TRACE_BATCH, TRACE_CONFIG, TRACE_SET."""
    from partseg_tpu_torch.models.partnet import PartNetConfig
    from partseg_tpu_torch.train.config import TrainConfig, apply_overrides, load_config

    batch = int(os.environ.get("TRACE_BATCH", "64"))
    if os.environ.get("TRACE_CONFIG"):
        cfg = load_config(os.environ["TRACE_CONFIG"]).replace(global_batch=batch)
    else:
        cfg = TrainConfig(model=PartNetConfig(n_parts=10, img_size=128), global_batch=batch)
    if os.environ.get("TRACE_SET"):
        cfg = apply_overrides(cfg, os.environ["TRACE_SET"].split())
    return cfg, batch


def main(device=None) -> dict:
    from partseg_tpu_torch.bench import build_trainer
    from partseg_tpu_torch.device import default_device

    dev = default_device(device)
    cuda = dev.type == "cuda"
    cfg, batch = trace_config()
    state, period, batches, _ = build_trainer(cfg, batch, device=str(dev))
    # warp_every > 1: one dispatch is a whole period of wp sub-steps; the
    # breakdown divides by sub-steps so numbers stay per optimizer step.
    wp = cfg.augment.warp_every

    def dispatch():
        nonlocal state
        state, _ = period(state, batches, cfg.seed)

    dispatch()
    if cuda:
        torch.cuda.synchronize()
    n_disp = 3 if wp == 1 else 2
    prof, wall_ms = profile_window(dispatch, n_disp, cuda, with_flops=True)
    os.makedirs(TRACE_DIR, exist_ok=True)
    trace = os.path.join(TRACE_DIR, "trace.json")
    prof.export_chrome_trace(trace)
    out = print_trace_breakdown(prof, wall_ms, n_disp * wp, cuda)
    spans = print_spans()
    result = {"metric": "train_step_trace", "config": os.environ.get("TRACE_CONFIG", "flagship128"),
              "batch": batch, "sub_steps": n_disp * wp, "device": str(dev), "trace": trace,
              **out, "spans": spans}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="trace on the CPU (plain versions)")
    main(device="cpu" if ap.parse_args().cpu else None)
