"""Reading a torch.profiler window: device time by kernel and by category,
busy time, and the host's activity in the device's idle gaps.

``CATEGORIES``, ``category``, ``device_us`` and ``profile_window`` (its retry
of a window in which CUPTI delivered no device activity) are copies of the
program's ``tools/trace_step.py`` as it stood when the benchmark was made,
except that the device's time leaves out annotations (``on_device``).
"""

from __future__ import annotations

import bisect
import time

import torch

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

CUDA = torch.autograd.DeviceType.CUDA


def category(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")


def on_device(e) -> bool:
    """A kernel, memset or copy on the card; not an annotation (a
    ``record_function`` span or NCCL's ``nccl:*`` range), which the profiler
    lists on the card's timeline over the kernels it covers."""
    return e.device_type == CUDA and not getattr(e, "is_user_annotation", False)


def device_us(prof) -> float:
    """The self time of every CUDA kernel, memset and copy in a window, µs."""
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if on_device(e))


def profile_window(fn, calls: int, windows: int = 3):
    """(prof, wall s): ``calls`` calls of ``fn`` under torch.profiler, ending in a
    synchronisation; a window with no device activity is taken again, up to
    ``windows`` in all."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(windows if cuda else 1):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if device_us(prof) > 0:
            break
    return prof, wall


def kernel_us(prof) -> dict[str, float]:
    """Device µs of each kernel, memset and copy of the window, by name."""
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if on_device(e):
            out[e.key] = out.get(e.key, 0.0) + getattr(e, "self_device_time_total", 0.0)
    return out


def idle_gaps(prof, top: int = 10, scan: int = 400) -> list[list]:
    """[[host op, seconds], ...]: the device's idle gaps between consecutive
    device operations, summed by the innermost host op running at each gap's
    middle ("host code" where none is), the largest ``top``."""
    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end) for e in events if on_device(e))
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type != CUDA)
    starts = [h[0] for h in host]
    sums: dict[str, float] = {}
    end = dev[0][1] if dev else 0.0
    for s, e in dev[1:]:
        if s > end:
            mid = 0.5 * (s + end)
            i = bisect.bisect_right(starts, mid)
            covering = [h for h in host[max(0, i - scan):i] if h[1] >= mid]
            name = min(covering, key=lambda h: h[1] - h[0])[2] if covering else "host code"
            sums[name] = sums.get(name, 0.0) + (s - end) * 1e-6
        end = max(end, e)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


class Window:
    """What a profiled sub-window holds, for the per-layer readers: device µs by
    kernel name, busy and wall seconds, the idle gaps by host op, over
    ``units`` steps or requests."""

    def __init__(self, kernels: dict, busy_s: float, wall_s: float, gaps: list, units: int):
        self.kernels, self.busy_s, self.wall_s = kernels, busy_s, wall_s
        self.gaps, self.units = gaps, units

    @classmethod
    def of(cls, prof, wall_s: float, units: int) -> "Window":
        kernels = kernel_us(prof)
        return cls(kernels, sum(kernels.values()) * 1e-6, wall_s, idle_gaps(prof), units)

    def ms_per_unit(self, names) -> float | None:
        """Device ms per unit of the kernels whose names contain one of ``names``;
        None where none ran."""
        us = [v for k, v in self.kernels.items() if any(n in k for n in names)]
        return sum(us) / 1e3 / self.units if us else None

    def category_ms(self, cats) -> float | None:
        us = [v for k, v in self.kernels.items() if category(k) in cats]
        return sum(us) / 1e3 / self.units if us else None

    def top_ops(self, top: int = 10) -> list[list]:
        return [[k, v * 1e-6] for k, v in sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]]
