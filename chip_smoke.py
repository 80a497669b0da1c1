#!/usr/bin/env python3
"""Drive partseg_tpu_torch's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits non-zero):
  1. device   — require CUDA; print nvidia-smi's name and power limit.
  2. build    — build the CUDA kernels from partseg_tpu_torch/csrc (nvcc).
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the CelebA serving shapes (B = 256), f32, TF32 off.
  4. serving  — the CelebA model (full width, bf16, seeded random weights,
                use_pallas=True) answers B = 256 inference and transfer
                requests; the kernels' launch counters show the path went
                through both kernels.
  5. parity   — the same weights at f32, B = 2: the port on the card
                (kernels, cuDNN) against the port on the CPU (plain
                versions).
  6. timing   — CUDA-event medians of each kernel, its plain version and
                the end-to-end requests; bounds from the H100's peaks.
  7. profile  — torch.profiler device time by kernel family over one
                infer and one transfer request, and the device's idle share.
Then the kernels line, nvidia-smi's line, and the final status line.

Imports nothing of JAX: it needs only this checkout, PyTorch and nvcc.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

from partseg_tpu_torch.configs import model_config
from partseg_tpu_torch.evals import make_infer_fn, transfer_batch
from partseg_tpu_torch.models.partnet import PartNet, init_weights
from partseg_tpu_torch.partops.kernels import (
    _build,
    render_assemble,
    render_assemble_plain,
    reset_launch_counts,
    softmax_moments,
    softmax_moments_plain,
)
from partseg_tpu_torch.partops.moments import precision_from_cov

BATCH = 256
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TIMING_RUNS = 20
KERNEL_INNER = 10             # back-to-back launches per timed run of one kernel


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, inner: int = 1, runs: int = TIMING_RUNS, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, by CUDA events: ``runs``
    timings of ``inner`` back-to-back calls each, divided by ``inner``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / inner for s, e in pairs)


# ----------------------------------------------------------------- inputs

def serving_logits(gen: torch.Generator, k: int, size: int, delta: bool = False):
    """The foreground slice [..., :K] of [B, size, size, K+1] f32 head-like
    logits, as PartNet.shape_stats passes it. ``delta`` puts one dominant
    pixel in every part map (near-singular Σ)."""
    logits = 3.0 * torch.randn((BATCH, size, size, k + 1), generator=gen, device="cuda")
    if delta:
        ys = torch.randint(0, size, (BATCH, k), generator=gen, device="cuda")
        xs = torch.randint(0, size, (BATCH, k), generator=gen, device="cuda")
        bi = torch.arange(BATCH, device="cuda")[:, None].expand(BATCH, k)
        ki = torch.arange(k, device="cuda")[None, :].expand(BATCH, k)
        logits[bi, ys, xs, ki] = 60.0
    return logits[..., :k]


def render_cases(cfg, mu, sigma, gen):
    """(name, mu, lam, app, res) at each decoder scale of ``cfg``."""
    lam = precision_from_cov(sigma).contiguous()
    cases = []
    n = cfg.decoder_scales
    for i, f in enumerate(cfg.decoder_features):
        res = cfg.img_size // 2 ** (n - 1 - i)
        app = torch.randn((BATCH, cfg.n_parts, f), generator=gen, device="cuda").to(torch.bfloat16)
        cases.append((f"{res}x{f}", mu, lam, app, res))
    return cases


# ------------------------------------------------------------------ bounds

def softmax_moments_bound(b, h, w, k):
    elems = b * h * w * k
    bytes_ = 4 * elems + 4 * elems + 4 * b * k * 5     # logits in, parts + raw out
    flops = 17 * elems                                  # max; exp+sum; exp, div, 5 fma
    return bytes_, flops


def render_assemble_bound(b, k, f, res):
    bytes_ = 4 * b * k * 2 + 4 * b * k * 4 + 2 * b * k * f + 4 * b * res * res * f
    flops = b * res * res * k * (2 * f + 12)            # φ (~12) + Σ_k φ·a (2 per channel)
    return bytes_, flops


def bound_ms(bytes_, flops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases

def phase_device() -> str:
    check(torch.cuda.is_available(), "CUDA is not available: chip_smoke needs one CUDA card")
    smi = nvidia_smi_line()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "build.log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln] if log.exists() else []
    emit("build", seconds=seconds, nvcc=_build.nvcc_path(), ptxas=ptxas)


def phase_kernels(cfg) -> dict:
    """Kernel vs plain on the card, f32. Tolerances come from the sum order:
    parts rtol 1e-5 (one exp and one division per element, sums of 4096
    terms); μ, Σ atol 1e-5 (5 sums of 4096 f32 products in another
    order); render out atol 1e-5·max|out| (K = 10 products per output)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k, size = cfg.n_parts, cfg.map_size
    errs = {"softmax_moments": 0.0, "render_assemble": 0.0}
    report = []
    for delta in (False, True):
        fg = serving_logits(gen, k, size, delta)
        got = softmax_moments(fg)
        want = softmax_moments_plain(fg)
        torch.cuda.synchronize()
        p_rel = ((got[0] - want[0]).abs() / want[0].abs().clamp_min(1e-30)).max().item()
        e_mu, e_sig = max_err(got[1], want[1]), max_err(got[2], want[2])
        report.append({"kernel": "softmax_moments", "delta": delta, "parts_max_rel": p_rel,
                       "mu_max_abs": e_mu, "sigma_max_abs": e_sig})
        check(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-30),
              f"softmax_moments parts disagree (delta={delta}): max rel {p_rel}")
        check(e_mu <= 1e-5 and e_sig <= 1e-5,
              f"softmax_moments mu/sigma disagree (delta={delta}): {e_mu}, {e_sig}")
        errs["softmax_moments"] = max(errs["softmax_moments"], max_err(got[0], want[0]), e_mu, e_sig)
        for name, mu, lam, app, res in render_cases(cfg, got[1], got[2], gen):
            for kind in ("gauss", "heavy_tail"):
                out = render_assemble(mu, lam, app, res, res, kind)
                ref = render_assemble_plain(mu, lam, app, res, res, kind)
                torch.cuda.synchronize()
                e = max_err(out, ref)
                scale = ref.abs().max().item()
                finite = bool(torch.isfinite(out).all())
                report.append({"kernel": "render_assemble", "case": name, "kind": kind,
                               "delta": delta, "max_abs": e, "max_abs_out": scale,
                               "finite": finite})
                check(finite, f"render_assemble {name} {kind} delta={delta}: non-finite output")
                check(e <= 1e-5 * scale,
                      f"render_assemble {name} {kind} delta={delta}: {e} > 1e-5·{scale}")
                errs["render_assemble"] = max(errs["render_assemble"], e)
    emit("kernels", cases=report, tolerances={
        "softmax_moments": "parts rtol 1e-5; mu, sigma atol 1e-5",
        "render_assemble": "atol 1e-5 * max|plain output|"})
    return errs


def phase_serving(cfg) -> dict:
    """The serving path at full width, counting kernel launches."""
    model = init_weights(PartNet(cfg), seed=SEED).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x_s = torch.rand((BATCH, cfg.img_size, cfg.img_size, 3), generator=gen, device="cuda")
    x_a = torch.rand((BATCH, cfg.img_size, cfg.img_size, 3), generator=gen, device="cuda")
    infer = make_infer_fn(model)

    torch.cuda.synchronize()
    reset_launch_counts()
    out = infer(x_s)
    after_infer = {"softmax_moments": softmax_moments.launches,
                   "render_assemble": render_assemble.launches}
    recon = transfer_batch(model, x_s, x_a)
    torch.cuda.synchronize()
    launches = {"softmax_moments": softmax_moments.launches,
                "render_assemble": render_assemble.launches}

    m, k = cfg.map_size, cfg.n_parts
    shapes = {"heatmaps": (BATCH, m, m, k), "logits": (BATCH, m, m, k + 1),
              "landmarks": (BATCH, k, 2), "sigma": (BATCH, k, 2, 2), "seg": (BATCH, m, m)}
    for name, shape in shapes.items():
        check(tuple(out[name].shape) == shape, f"infer {name}: shape {tuple(out[name].shape)}")
        check(bool(torch.isfinite(out[name].float()).all()), f"infer {name}: non-finite values")
    seg = out["seg"]
    check(seg.dtype == torch.int32 and seg.min().item() >= 0 and seg.max().item() <= k,
          f"seg labels outside [0, {k}]")
    sums = out["heatmaps"].sum(dim=(1, 2))
    check(torch.allclose(sums, torch.ones_like(sums), atol=1e-4), "heatmaps do not sum to 1")
    check(tuple(recon.shape) == (BATCH, cfg.img_size, cfg.img_size, 3),
          f"transfer shape {tuple(recon.shape)}")
    check(bool(torch.isfinite(recon.float()).all()) and recon.min().item() >= 0
          and recon.max().item() <= 1, "transfer output not finite in [0, 1]")
    check(after_infer == {"softmax_moments": 1, "render_assemble": 0},
          f"infer launches {after_infer}, expected softmax_moments 1, render_assemble 0")
    check(launches == {"softmax_moments": 3, "render_assemble": 4},
          f"infer + transfer launches {launches}, expected softmax_moments 3, render_assemble 4")
    emit("serving", batch=BATCH, dtype=str(cfg.dtype), launches_after_infer=after_infer,
         launches=launches, seg_labels=sorted(torch.unique(seg).tolist()),
         recon_mean=recon.float().mean().item())
    return {"model": model, "x_s": x_s, "x_a": x_a, "launches": launches}


def phase_parity(cfg) -> None:
    """Card (kernels, cuDNN f32, TF32 off) against CPU (plain versions),
    same f32 weights, B = 2. Tolerances: the two run the same f32 math in
    another sum order through ~60 convolutions; 1e-4 of each output's
    scale leaves room for that and none for a wrong layout or kernel."""
    f32 = model_config("celeba", use_pallas=True, dtype=torch.float32)
    cpu = init_weights(PartNet(f32, device="cpu"), seed=SEED).eval()
    gpu = PartNet(f32)
    gpu.load_state_dict(cpu.state_dict())
    gpu.eval()
    gen = torch.Generator().manual_seed(SEED + 2)
    x_s = torch.rand((2, f32.img_size, f32.img_size, 3), generator=gen)
    x_a = torch.rand((2, f32.img_size, f32.img_size, 3), generator=gen)

    want = make_infer_fn(cpu)(x_s)
    want["recon"] = transfer_batch(cpu, x_s, x_a)
    got = make_infer_fn(gpu)(x_s.cuda())
    got["recon"] = transfer_batch(gpu, x_s.cuda(), x_a.cuda())
    errs, scales = {}, {}
    for name in ("logits", "heatmaps", "landmarks", "sigma", "recon"):
        errs[name] = max_err(got[name].cpu(), want[name])
        scales[name] = want[name].abs().max().item()
    seg_agree = (got["seg"].cpu() == want["seg"]).float().mean().item()
    emit("parity", max_abs_err=errs, max_abs=scales, seg_agreement=seg_agree)
    for name, e in errs.items():
        check(e <= 1e-4 * max(scales[name], 1.0) if name != "heatmaps"
              else e <= 1e-4 * scales[name], f"card vs CPU {name}: {e} (scale {scales[name]})")
    check(seg_agree >= 0.999, f"card vs CPU seg agreement {seg_agree}")


_CATEGORIES = (   # (category, lower-case kernel-name substrings), first match wins
    ("softmax_moments", ("softmax_moments_kernel",)),
    ("render_assemble", ("render_assemble_kernel",)),
    ("group_norm", ("rowwisemoments", "fusedparams", "groupnorm", "group_norm")),
    ("conv_matmul", ("conv", "xmma", "gemm", "cutlass", "fprop", "cudnn")),
    ("softmax_argmax", ("softmax", "argmax", "reduce")),
    ("pool_upsample_cat", ("pool", "upsample", "cat")),
    ("elementwise_copy", ("elementwise", "copy", "cast", "vectorized")),
)


def phase_profile(served: dict) -> None:
    """Device time by kernel over one infer + one transfer request at B,
    from torch.profiler; idle share = 1 − kernel time / wall time (one
    stream, so kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    model, x_s, x_a = served["model"], served["x_s"], served["x_a"]
    infer = make_infer_fn(model)
    for name, fn in (("infer", lambda: infer(x_s)),
                     ("transfer", lambda: transfer_batch(model, x_s, x_a))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = {}
        for e in kernels:
            us = getattr(e, "self_device_time_total", 0.0)
            cat = next((c for c, keys in _CATEGORIES
                        if any(k in e.key.lower() for k in keys)), "other")
            busy[cat] = busy.get(cat, 0.0) + us / 1e3
        total = sum(busy.values())
        top = sorted(kernels, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]
        emit("profile", request=name, batch=x_s.shape[0], wall_ms=wall_ms,
             device_ms=total, idle_share=(1 - total / wall_ms) if wall_ms > 0 else None,
             by_category_ms=dict(sorted(busy.items(), key=lambda kv: -kv[1])),
             top_kernels=[{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                           "calls": e.count} for e in top])


def phase_timing(cfg, served: dict, errs: dict, smi: str) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    k, size = cfg.n_parts, cfg.map_size
    fg = serving_logits(gen, k, size)
    sm_ms = event_ms(lambda: softmax_moments(fg), inner=KERNEL_INNER)
    sm_plain = event_ms(lambda: softmax_moments_plain(fg), inner=KERNEL_INNER)
    sm_bound, sm_by = bound_ms(*softmax_moments_bound(BATCH, size, size, k))

    _, mu, sigma = softmax_moments(fg)
    scales = []
    for name, mu_, lam, app, res in render_cases(cfg, mu, sigma, gen):
        f = app.shape[-1]
        ms = event_ms(lambda: render_assemble(mu_, lam, app, res, res, cfg.render_kernel),
                      inner=KERNEL_INNER)
        plain = event_ms(lambda: render_assemble_plain(mu_, lam, app, res, res, cfg.render_kernel),
                         inner=KERNEL_INNER)
        b_ms, by = bound_ms(*render_assemble_bound(BATCH, k, f, res))
        scales.append({"scale": name, "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by})
    emit("timing_render_assemble_scales", batch=BATCH, scales=scales, nvidia_smi=smi)

    model, x_s, x_a = served["model"], served["x_s"], served["x_a"]
    infer = make_infer_fn(model)
    torch.cuda.reset_peak_memory_stats()
    infer_ms = event_ms(lambda: infer(x_s), warmup=2)
    transfer_ms = event_ms(lambda: transfer_batch(model, x_s, x_a), warmup=2)
    emit("timing_end_to_end", batch=BATCH, dtype=str(cfg.dtype),
         infer_ms=infer_ms, infer_img_per_s=BATCH / infer_ms * 1e3,
         transfer_ms=transfer_ms, transfer_img_per_s=BATCH / transfer_ms * 1e3,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)

    ra_by = "bytes" if all(s["bound_by"] == "bytes" for s in scales) else "operations"
    return [
        {"name": "softmax_moments", "route": "cuda",
         "source": "partseg_tpu_torch/csrc/softmax_moments.cu",
         "replaces": "partseg_tpu/partops/pallas/softmax_moments.py:73",
         "launches": served["launches"]["softmax_moments"],
         "max_abs_err": errs["softmax_moments"], "ms": sm_ms, "plain_ms": sm_plain,
         "bound_ms": sm_bound, "bound_by": sm_by, "library_ms": None,
         "per": f"one call, logits [{BATCH},{size},{size},{k}] of [..,{k + 1}]"},
        {"name": "render_assemble", "route": "cuda",
         "source": "partseg_tpu_torch/csrc/render_assemble.cu",
         "replaces": "partseg_tpu/partops/pallas/render_assemble.py:121",
         "launches": served["launches"]["render_assemble"],
         "max_abs_err": errs["render_assemble"],
         "ms": sum(s["ms"] for s in scales), "plain_ms": sum(s["plain_ms"] for s in scales),
         "bound_ms": sum(s["bound_ms"] for s in scales), "bound_by": ra_by,
         "library_ms": None, "per": f"one decode: {len(scales)} launches at B={BATCH}"},
    ]


def main() -> int:
    smi = phase_device()
    phase_build()
    cfg = model_config("celeba", use_pallas=True)
    errs = phase_kernels(cfg)
    served = phase_serving(cfg)
    phase_parity(cfg)
    kernels = phase_timing(cfg, served, errs, smi)
    phase_profile(served)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
