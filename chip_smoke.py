#!/usr/bin/env python3
"""Drive partseg_tpu_torch's serving, training and evaluation paths on
one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR   # kernels against another checkout's

Phases (one JSON line each; any failure exits non-zero):
  1. device       — require CUDA; print nvidia-smi's name and power limit.
  2. build        — build the CUDA kernels from partseg_tpu_torch/csrc (nvcc).
  3. kernels      — each kernel against its plain PyTorch version on the
                    card, f32 with TF32 off (bf16 too for the warps): the
                    serving kernels at the CelebA serving shapes (B = 256),
                    the warp kernels (phase kernels_warp) at the speed128
                    training shapes.
  4. backward     — each kernel wrapper's autograd backward against
                    torch.autograd.grad through its plain version, f32;
                    render_assemble's backward kernel also against its
                    closed form (render_assemble_vjp), f32 and bf16.
  5. serving      — the CelebA model (full width, bf16, seeded random
                    weights, use_pallas=True) answers B = 256 inference and
                    transfer requests; the launch counters show the path
                    went through softmax_moments and render_assemble.
  6. parity       — the same weights at f32, B = 2: the port on the card
                    (kernels, cuDNN) against the port on the CPU (plain
                    versions).
  7. train        — speed128 (full width, bf16, B = 128, seeded random
                    weights, the port's random VGG) trains a few periods on
                    device-resident images; exact launches per period; the
                    period's peak device memory with model.remat off and on
                    (fresh trainers). Then
                    train_zeros_padding: the same with the warp's
                    padding_mode "zeros", which goes through bilinear_sample.
  8. train_parity — the same config at f32, B = 2, one period from the same
                    state and draws: card against CPU, gradients included;
                    the metrics within 1e-4 plus their spread on the CPU
                    over periods whose weights are nudged by one ulp.
     train_k16    — deepfashion (K = 16, full width, bf16, B = 64, seeded
                    weights, the port's random VGG, device-resident images)
                    through make_train_period: exact launches per period
                    (render_assemble's backward at every scale a group of
                    16 parts), period ms, device ms, peak memory; the
                    16-part forward's device ms on each scale's inputs
                    from the period, beside its bound.
     train_loop   — speed128 at full width and B = 128 through the train
                    loop (train/loop.py): the synthetic dataset, the
                    loader, scan_groups = 8, checkpoints. 32 steps; 16 and
                    a resume to 32 (bit for bit, deterministic algorithms);
                    the CLI killed at step 5 by fault injection (exit 42)
                    and resumed; device_data against streaming; 32 steps
                    with the default algorithms.
     dp           — two ranks on the card (gloo; NCCL as well where the host
                    has two cards): speed128 at full width, 128 per rank;
                    one data-parallel step held to the one-process step run
                    per shard and averaged; launches per period, img/s, the
                    gradient all-reduce's ms; then the train CLI under
                    torchrun killed at step 5 and resumed (bit for bit, one
                    writer).
     spatial      — two ranks splitting the image rows (gloo on cuda:0):
                    bf16 collectives; a narrow f32 spatial step against the
                    unsharded step; celeba256_spatial at full width through
                    the loop (32 images per data shard): img/s, peak memory
                    per rank, the halo and reduction device ms of a step
                    from their spans under torch.profiler.
     evals        — the landmark and segmentation protocols with the
                    CelebA model (bf16, B = 256) over a 600-example
                    synthetic split, remainder batch included; card at f32
                    against the CPU on its tail; μ-collection img/s.
     export       — the CelebA infer forward exported with a symbolic
                    batch: the graph holds partseg::softmax_moments; saved,
                    loaded and served at B = 256 and 37 against eager; a
                    static batch refuses 37; exported against eager img/s.
     golden       — the port at bf16 against tests/golden/golden.npz.
     validate     — tools.validate_synthetic (the synthetic preset, 600
                    steps through the loop) under the reference's pass
                    rule, then tools.validate_segmentation.
     cli          — the infer, transfer, eval and export CLIs on validate's
                    checkpoint (infer and transfer as arrays without cv2).
     trace        — tools.trace_step on speed128 at B = 128: device ms
                    per optimizer step by kernel category, top kernels,
                    idle share.
     components   — tools.profile_components at its flagship 128 px config,
                    B = 64: each stage's ms by CUDA events.
     bench_infer  — tools.bench_infer on celeba at B = 256: eager and
                    exported img/s; the exported outputs against eager's.
     probe_warp   — tools.probe_warp_parity: tps_warp and the explicit-flow
                    bilinear_sample against the plain gather warp.
     quality      — one period of each of the study variants flagship and
                    speed128_r5_wf25d32 (128 px, B = 64) in this process,
                    then the reduced quality study through its CLI (40
                    flagship steps, rates measured on the card by bench
                    children): result.json well formed, rates from the
                    card, the study's parent never on the card.
     path_kernels — softmax_moments, render_assemble (forward; backward
                    kernel where the path trained) and tps_warp against
                    their plain versions on the inputs the evals, export,
                    golden, validate, cli, train_k16 and quality paths
                    gave them (the first call of each shape, kept while the
                    path ran; quality's flagship 16²×256 is the backward's
                    case of two channel chunks, train_k16's K = 16 decode
                    its group of 16 parts at every scale).
  9. timing       — each kernel's device time per call (torch.profiler,
                    host excluded) and its wrapper's CUDA-event median
                    (host included), at the serving and the training
                    shapes; its plain version, its backward and the
                    library call where there is one; the end-to-end
                    requests and train period; bounds from the H100's
                    peaks.
     timing_wide_decodes — render_assemble forward and backward at the
                    flagship's 16²×256 and deepfashion's K = 16 scales
                    (B = 64), against their bounds.
     feed         — tools.feed_bench over 2,000 JPEGs at 178×218 against
                    the demand of timing_train's speed128 rate: the thread
                    pool, and the native pool where it builds on the host.
     tools_seconds — the seconds of each phase that drives a tool (trace to
                    quality, timing_wide_decodes, feed) and their sum.
     tps_wide     — tps_warp on the wide path, its basis through a ring of
                    chunks (grid 20, and grid 15 banded): against the plain
                    sample, and timed beside its bound and its library
                    pair (tps_flow + F.grid_sample).
 10. profile      — torch.profiler device time by kernel family over one
                    infer, one transfer request and one train period, and
                    the device's idle share (aggregated by tools.trace_step).
     profiler     — the device-time calls whose three profiler windows held
                    no device time (CUPTI sometimes delivers none): each
                    device_ms then came from CUDA events, and a profile
                    breakdown reads "not measured".
Then the kernels line (each kernel's launches on the train period, and
on each later path in launches_by_path), nvidia-smi's line, and the
final status line.

With --baseline DIR (DIR holds another checkout of the repo, such as a
`git archive` of an earlier commit unpacked into a gitignored directory)
it runs only device, build, kernels_warp, turns, tps_wide,
timing_wide_decodes and train_k16: both checkouts' csrc/ built into two
libraries; tps_warp's output held bit for bit to the baseline's at the
training warp and at every tps_warp case of the card tests (and to the
plain version as above); each kernel's C entry point of both called on
the same inputs, device time per call in the order baseline, this, this,
baseline (render_assemble's forward, bit for bit the baseline's, and
backward also at the wide decodes' scales, with sweeps of this checkout's
tiles; the backward bit for bit the baseline's at K <= 12 and C <= 128);
the wide tps_warp bases, the wide decodes' forward and the K = 16 period
under both libraries in turns (the wrappers' launch rules in Python are
this checkout's, so the baseline is the parent commit).

Imports nothing of JAX: it needs only this checkout, PyTorch and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The train_loop phase runs with deterministic algorithms, which need this
# cuBLAS workspace setting before the first cuBLAS handle exists.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from partseg_tpu_torch.augment import (
    AugmentConfig,
    ColorParams,
    PairDraws,
    TPSParams,
    TPSSampler,
    keyed_pair_draws,
)
from partseg_tpu_torch import tracing
from partseg_tpu_torch.bench import build_trainer
from partseg_tpu_torch.configs import model_config, train_config
from partseg_tpu_torch.data import SyntheticBlobs, make_loader
from partseg_tpu_torch.evals import (
    collect_mu,
    evaluate_segmentation,
    export_infer,
    infer_image,
    load_exported,
    load_model_and_params,
    make_infer_fn,
    transfer,
    transfer_batch,
)
from partseg_tpu_torch.evals.infer import render_overlay
from partseg_tpu_torch.evals.transfer import full_size_decoder
from partseg_tpu_torch.models.partnet import PartNet, PartNetConfig, init_weights
from partseg_tpu_torch.partops import bilinear_sample
from partseg_tpu_torch.partops.kernels import (
    _build,
    bilinear_sample_fused,
    bilinear_sample_plain,
    render_assemble,
    render_assemble_backward,
    render_assemble_plain,
    render_assemble_vjp,
    softmax_moments,
    softmax_moments_plain,
    tps_warp,
    tps_warp_plain,
)
from partseg_tpu_torch.partops.kernels.bilinear_sample import sample_with_grads
from partseg_tpu_torch.partops.kernels.render_assemble import (
    CHUNK_CHANNELS,
    NARROW_PARTS,
    backward_chunks,
    backward_groups,
    backward_partial_rows,
    backward_tile,
)
from partseg_tpu_torch.partops.kernels.tps_warp import (
    band_config,
    kernel_order_flow,
    launch_plan,
    pad_columns,
    tps_flow,
    tps_sample_plain,
)
from partseg_tpu_torch.partops.moments import precision_from_cov
from partseg_tpu_torch.tools import trace_step
from partseg_tpu_torch.tools.quality_study import PX128_BASE, STUDY_BATCH, VARIANTS_128
from partseg_tpu_torch.train import (
    LossConfig, OptimConfig, TrainConfig, build_perceptual, compose_period, create_state,
    make_loss_fn, make_train_period, make_train_step,
)
from partseg_tpu_torch.train.state import trainable, warmup_cosine

ROOT = Path(__file__).resolve().parent
BATCH = 256                   # serving requests
TRAIN_BATCH = 128             # speed128's per-card batch
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
TIMING_RUNS = 20
KERNEL_INNER = 10             # back-to-back launches per timed run of one kernel
PROFILE_CALLS = 20            # calls per torch.profiler window of one kernel


class SmokeError(RuntimeError):
    pass


def _load_module(path: Path, name: str | None = None):
    """The module in the file ``path``, loaded under ``name`` (its stem by default)."""
    spec = importlib.util.spec_from_file_location(name or path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


PROFILER_FALLBACKS: list = []   # device_ms calls whose profiler windows held no device time


def device_ms(fn, calls: int = PROFILE_CALLS, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the self time of every kernel,
    memset and copy it runs on the card, from torch.profiler (CUPTI), over
    ``calls`` calls after a warm-up. The host's time is not in it. Where
    three profiler windows in a row hold no device time, CUDA events time
    ``calls`` back-to-back calls instead (the host's launch gaps then
    count): a ``device_ms_by_events`` line says so, and phase
    ``profiler`` counts such calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    prof, _ = trace_step.profile_window(fn, calls, cuda=True)
    us = trace_step.device_us(prof)
    if us > 0:
        return us / calls / 1e3
    ms = event_ms(fn, inner=calls, runs=3, warmup=0)
    PROFILER_FALLBACKS.append({"device_ms_by_events": ms, "calls": calls})
    emit("device_ms_by_events", reason="torch.profiler recorded no device time in three "
                                       "windows", calls=calls, ms=ms)
    return ms


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


def train_render_inputs(gen, app_dtype=torch.float32, batch=TRAIN_BATCH):
    """speed128's decoder inputs: f32 logits [B, 32, 32, K+1], μ and Λ from
    their moments, and one appearance [B, K, f] per decoder scale, as
    (logits, mu, lam, [(res, app)])."""
    cfg = train_config("speed128").model
    m, k = cfg.map_size, cfg.n_parts
    logits = 3.0 * torch.randn((batch, m, m, k + 1), generator=gen, device="cuda")
    _, mu, sigma = softmax_moments_plain(logits[..., :k])
    lam = precision_from_cov(sigma).contiguous()
    scales = []
    for i, f in enumerate(cfg.decoder_features):
        res = cfg.decoder_out_size // 2 ** (cfg.decoder_scales - 1 - i)
        app = 0.5 * torch.randn((batch, k, f), generator=gen, device="cuda")
        scales.append((res, app.to(app_dtype)))
    return logits, mu.contiguous(), lam, scales


def serving_render_inputs(gen, cfg, app_dtype):
    """The celeba serving decoder's inputs at B = 256: μ and Λ from the
    moments of serving logits, and one appearance per decoder scale, as
    (mu, lam, [(res, app)])."""
    _, mu, sigma = softmax_moments_plain(serving_logits(gen, cfg.n_parts, cfg.map_size))
    cases = render_cases(cfg, mu.contiguous(), sigma, gen)
    return mu.contiguous(), cases[0][2], [(res, app.to(app_dtype)) for *_, app, res in cases]


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


def wide_decode_cases(gen):
    """(label, K, mu, lam, app, res, g, kind) at every decoder scale with
    K > 12 or C > 128 (the backward shapes of more than one part group of
    12 or channel chunk), at the study's B = 64: the flagship 128 px
    decode's 16²×256 (phase quality's flagship period) and each scale of
    the K = 16 deepfashion decode (phase train_k16). μ, Λ from the moments
    of random logits at the model's map size; bf16 appearance as the bf16
    step passes it; an f32 cotangent g."""
    batch = STUDY_BATCH
    cases = []
    for label, m in (("flagship", study_config("flagship").model),
                     ("deepfashion", train_config("deepfashion").model)):
        k = m.n_parts
        logits = 3.0 * torch.randn((batch, m.map_size, m.map_size, k), generator=gen,
                                   device="cuda")
        _, mu, sigma = softmax_moments_plain(logits)
        lam = precision_from_cov(sigma).contiguous()
        for i, f in enumerate(m.decoder_features[:m.decoder_scales]):
            res = (m.decoder_out_size or m.img_size) // 2 ** (m.decoder_scales - 1 - i)
            if k <= NARROW_PARTS and f <= CHUNK_CHANNELS:
                continue
            app = 0.5 * torch.randn((batch, k, f), generator=gen, device="cuda")
            app = app.to(torch.bfloat16)
            g = torch.randn((batch, res, res, f), generator=gen, device="cuda")
            cases.append((label, k, mu.contiguous(), lam, app, res, g, m.render_kernel))
    return cases


def backward_plan(k: int, c: int, res: int, b: int) -> dict:
    """The backward kernel's launch for one decoder scale, by the wrapper's
    rule: pixels per tile, rows of partials (0: one cluster per image and
    part group), part groups and channel chunks."""
    tile = backward_tile(k, c, res * res)
    return {"scale": f"{res}x{c}", "k": k, "tile": tile,
            "rows": backward_partial_rows(k, c, res * res, b, tile),
            "groups": backward_groups(k), "chunks": backward_chunks(c)}


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


def render_backward_bound(b, k, f, res):
    # Read μ, Λ, a (bf16) and the f32 cotangent g once; write d_μ, d_Λ, d_a.
    bytes_ = (4 * b * k * 6 + 2 * b * k * f + 4 * b * res * res * f
              + 4 * b * k * 6 + 2 * b * k * f)
    flops = b * res * res * k * (4 * f + 24)   # g_φ and d_a: 2 per channel each; φ, g_d, 5 sums
    return bytes_, flops


def tps_warp_bound(b, h, w, c, m, elt):
    bytes_ = 2 * elt * b * h * w * c + 4 * b * m * 2 + 4 * h * w * m   # image, out; w; basis
    flops = b * h * w * (4 * m + 10 * c)                                # flow dot; 4-tap lerp
    return bytes_, flops


def tps_warp_backward_bound(b, h, w, c, m, elt):
    """Read the image, its cotangent, the weights and the basis once; write
    d_image and d_weights. The flow (4M), the tap slopes (14C + 12), d_coords
    (4C) and d_weights (4M) per pixel."""
    bytes_ = 3 * elt * b * h * w * c + 2 * 4 * b * m * 2 + 4 * h * w * m
    flops = b * h * w * (8 * m + 18 * c + 12)
    return bytes_, flops


def bilinear_bound(b, n, c, elt, hw, grads=False):
    """The primal writes [B, N, C] in the image dtype; the grads variant
    writes three f32 arrays [B, C, N] (the sample and its y and x slopes)
    and does 4 more flops per channel for the slopes."""
    out = 3 * 4 * b * n * c if grads else elt * b * n * c
    bytes_ = elt * b * hw * c + 8 * b * n + out                         # image, coords, out
    flops = b * n * (12 + (14 if grads else 10) * c)
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
             if "registers" in ln or "Compiling entry" in ln
             or ("spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln)
             ] if log.exists() else []
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
        again = softmax_moments(fg)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"softmax_moments repeat differs (delta={delta})")
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
    tlogits = train_render_inputs(gen)[0]
    tfg = tlogits[..., :k]
    got, want, again = softmax_moments(tfg), softmax_moments_plain(tfg), softmax_moments(tfg)
    torch.cuda.synchronize()
    e_mu, e_sig = max_err(got[1], want[1]), max_err(got[2], want[2])
    report.append({"kernel": "softmax_moments", "shape": list(tfg.shape), "mu_max_abs": e_mu,
                   "sigma_max_abs": e_sig, "parts_max_abs": max_err(got[0], want[0])})
    check(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-30) and e_mu <= 1e-5
          and e_sig <= 1e-5, f"softmax_moments disagrees at the training shape: {e_mu}, {e_sig}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "softmax_moments repeat differs at the training shape")
    errs["softmax_moments"] = max(errs["softmax_moments"], max_err(got[0], want[0]), e_mu, e_sig)
    emit("kernels", cases=report, tolerances={
        "softmax_moments": "parts rtol 1e-5; mu, sigma atol 1e-5",
        "render_assemble": "atol 1e-5 * max|plain output|"})
    return errs



def warp_inputs(gen, dtype=torch.float32):
    """The speed128 warp shapes: the warp_fraction head of a B = 128 batch
    of 128² images (32 images), its spline weights, the static basis, and
    the 16384 sample coords per image that tps_warp's backward gives
    bilinear_sample."""
    cfg = train_config("speed128")
    sampler = cfg.augment.make_sampler()
    nw = math.ceil(TRAIN_BATCH * cfg.augment.warp_fraction)
    s = cfg.model.img_size
    img = torch.rand((nw, s, s, 3), generator=gen, device="cuda").to(dtype)
    weights = sampler.sample(gen, nw).weights.contiguous()
    basis = sampler.flow_basis(s, s, "cuda")
    coords = torch.einsum("nm,bmk->bnk", basis, weights).contiguous()
    return img, weights, basis, coords


TPS_LIBRARY_PAIR = ("tps_flow (f32 einsum) and F.grid_sample (border) on the flow cast to the "
                    "image dtype: two library calls and a cast, no single call computes tps_warp")


def tps_library_pair(img, weights, basis):
    """tps_warp's yardstick: the flow by tps_flow, then F.grid_sample on it.
    The weights are flipped once beforehand, so the flow comes out as the
    (x, y) pairs grid_sample takes."""
    nchw = img.permute(0, 3, 1, 2)
    w_xy = weights.flip(-1).contiguous()
    return lambda: F.grid_sample(nchw, tps_flow(w_xy, basis)[:, None].to(img.dtype),
                                 mode="bilinear", padding_mode="border", align_corners=False)


def _with_band(kh: int, var: str = "PARTSEG_WARP_BAND"):
    """Set $PARTSEG_WARP_BAND (or ``var``; 0 clears it); returns the old value."""
    old = os.environ.pop(var, None)
    if kh:
        os.environ[var] = str(kh)
    return old


def _tps_launch(lib, im, weights, basis, band, tile) -> torch.Tensor:
    """One call of a library's tps_warp entry point (this checkout's or a
    baseline's) on the same inputs."""
    out = torch.empty_like(im)
    b, h, w, c = im.shape
    _build.launch("partseg_tps_warp", im.device, im.data_ptr(), int(im.dtype == torch.bfloat16),
                  weights.data_ptr(), basis.data_ptr(), out.data_ptr(), b, h, w, c,
                  weights.shape[1], tile, band, lib=lib)
    return out


def card_test_tps_cases():
    """Every tps_warp case of the card tests (tests/test_torch_cuda.py
    TPS_SHAPES, loaded by path) as (name, band, tile, inputs maker)."""
    mod = _load_module(ROOT / "tests" / "test_torch_cuda.py", "card_tests")
    cuda = torch.device("cuda")
    for name, (b, h, w, c, grid, band, tile, extreme, nan, odd) in mod.TPS_SHAPES.items():
        yield name, band, tile, (lambda dtype, a=(b, h, w, c, grid, extreme, nan, odd):
                                 mod._tps_case(cuda, dtype, *a))


def phase_warp_kernels(baseline=None) -> dict:
    """tps_warp (unbanded, and banded at kh = 56 and a tight 40) and
    bilinear_sample (primal and grads variant; border and zeros) against
    their plain versions at the training shapes. Tolerances: f32 tps_warp
    1e-4 (the flow is a 28-term f32 dot summed in another order; its ulps
    move the taps, and neighbouring pixels differ by up to 1); bf16 against
    the plain version computed in f32 from the same bf16 image and cast
    once: one bf16 ulp at values ≤ 1 (2⁻⁸) plus 1e-4; f32 bilinear_sample
    1e-6 (the same taps and weights, lerp products maybe fused). tps_warp's
    repeats must give the same bits, and with a ``baseline`` library (an
    earlier checkout's kernels) so must its output, here and at every
    tps_warp case of the card tests: the same flow chain, index rounding,
    taps and lerp."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    img, weights, basis, coords = warp_inputs(gen)
    report, errs = [], {"tps_warp": 0.0, "bilinear_sample": 0.0}
    old = os.environ.get("PARTSEG_WARP_BAND")
    try:
        for kh in (0, 56, 40):
            _with_band(kh)
            for dtype in (torch.float32, torch.bfloat16):
                im = img.to(dtype)
                band, tile = band_config(dtype, im.shape[1], im.shape[2])
                got = tps_warp(im, weights, basis)
                again = tps_warp(im, weights, basis)
                want = tps_warp_plain(im.float(), weights, basis, band, tile).to(dtype)
                torch.cuda.synchronize()
                e = max_err(got, want)
                tol = 1e-4 if dtype == torch.float32 else 2 ** -8 + 1e-4
                row = {"kernel": "tps_warp", "band": band, "tile": tile, "dtype": str(dtype),
                       "max_abs": e}
                check(band == kh, f"tps_warp band {band}, expected {kh}")
                check(got.dtype == dtype and e <= tol,
                      f"tps_warp kh={kh} {dtype}: {e} > {tol}")
                check(torch.equal(got, again), f"tps_warp kh={kh} {dtype}: repeat differs")
                if baseline is not None:
                    prior = _tps_launch(baseline, im, weights, basis, band, tile)
                    torch.cuda.synchronize()
                    row["baseline_max_abs"] = max_err(got, prior)
                    check(torch.equal(got, prior),
                          f"tps_warp kh={kh} {dtype}: differs from the baseline's kernel")
                report.append(row)
                if dtype == torch.float32:
                    errs["tps_warp"] = max(errs["tps_warp"], e)
        _with_band(0)
        for name, kh, tile_env, make in card_test_tps_cases() if baseline is not None else ():
            _with_band(kh)
            tile_prior = _with_band(tile_env, "PARTSEG_WARP_TILE")
            for dtype in (torch.float32, torch.bfloat16):
                x, w_, bs = make(dtype)
                band, tile = band_config(dtype, x.shape[1], x.shape[2])
                got = tps_warp(x, w_, bs)   # this tree's wrapper: a wide basis padded as it pads it
                prior = _tps_launch(baseline, x, w_, bs, band, tile)
                torch.cuda.synchronize()
                report.append({"kernel": "tps_warp", "case": name, "dtype": str(dtype),
                               "m": w_.shape[1], "band": band,
                               "chunk": launch_plan(x.shape[0], x.shape[1], x.shape[2],
                                                    w_.shape[1], band, tile).chunk,
                               "baseline_max_abs": max_err(got, prior)})
                check(torch.equal(got, prior),
                      f"tps_warp case {name} {dtype}: differs from the baseline's kernel")
            _with_band(0, "PARTSEG_WARP_TILE")
            if tile_prior is not None:
                os.environ["PARTSEG_WARP_TILE"] = tile_prior
    finally:
        _with_band(0)
        if old is not None:
            os.environ["PARTSEG_WARP_BAND"] = old
    if baseline is not None:
        emit("kernels_warp", cases=report, compared="bit for bit with the baseline's tps_warp")
        return errs
    # Coordinates beyond the border too, for the clamp and the zeros fade.
    wide = (coords * 1.15).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        im = img.to(dtype)
        for mode in ("border", "zeros"):
            got = bilinear_sample(im, wide, mode, impl="fused")
            want = bilinear_sample(im.float(), wide, mode, impl="gather").to(dtype)
            torch.cuda.synchronize()
            e = max_err(got, want)
            tol = 1e-6 if dtype == torch.float32 else 2 ** -8 + 1e-6
            report.append({"kernel": "bilinear_sample", "mode": mode, "dtype": str(dtype),
                           "max_abs": e})
            check(e <= tol, f"bilinear_sample {mode} {dtype}: {e} > {tol}")
            if dtype == torch.float32:
                errs["bilinear_sample"] = max(errs["bilinear_sample"], e)
    grads = sample_with_grads(img, wide)
    plain = bilinear_sample_plain(img, wide, with_grads=True)
    torch.cuda.synchronize()
    e = max(max_err(a, b) for a, b in zip(grads, plain))
    report.append({"kernel": "bilinear_sample", "variant": "grads", "max_abs": e})
    check(e <= 1e-6, f"bilinear_sample grads variant: {e} > 1e-6")
    errs["bilinear_sample"] = max(errs["bilinear_sample"], e)
    emit("kernels_warp", cases=report, tolerances={
        "tps_warp": "f32 1e-4; bf16 2^-8 + 1e-4 against the f32 plain version cast once",
        "bilinear_sample": "f32 1e-6; bf16 2^-8 + 1e-6"})
    return errs


def _scaled_err(got, want) -> float:
    return max_err(got, want) / max(want.abs().max().item(), 1e-30)


def backward_cases(gen, batch=TRAIN_BATCH):
    """(name, fn, inputs, cotangent-shaped output) at the speed128 training
    shapes: each fn maps the inputs (requiring grad) to its outputs."""
    k = train_config("speed128").model.n_parts
    logits, mu, lam, render = train_render_inputs(gen, batch=batch)
    img, weights, basis, coords = warp_inputs(gen)
    return {
        "softmax_moments": (lambda x: softmax_moments(x[..., :k]),
                            lambda x: softmax_moments_plain(x[..., :k]), [logits]),
        "render_assemble": (
            lambda mu_, lam_, *apps: [render_assemble(mu_, lam_, a, r, r) for (r, _), a in
                                      zip(render, apps)],
            lambda mu_, lam_, *apps: [render_assemble_plain(mu_, lam_, a, r, r) for (r, _), a in
                                      zip(render, apps)],
            [mu, lam] + [a for _, a in render]),
        "tps_warp": (lambda im, w: tps_warp(im, w, basis),
                     lambda im, w: tps_warp_plain(im, w, basis), [img, weights]),
        "bilinear_sample": (bilinear_sample_fused, lambda im, c: bilinear_sample_plain(im, c),
                            [img, coords]),
    }


def _strided_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with its strides (``clone`` makes a strided slice,
    such as the foreground logits, contiguous)."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device).copy_(x)


def _graph(fn, inputs, seed):
    """(outputs, inputs requiring grad, seeded cotangents) of fn."""
    xs = [_strided_copy(x.detach()).requires_grad_() for x in inputs]
    outs = fn(*xs)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    g = torch.Generator(device=xs[0].device).manual_seed(seed)
    cots = [torch.randn(o.shape, generator=g, device=o.device).to(o.dtype) for o in outs]
    return outs, xs, cots


def _grads(fn, inputs, seed):
    outs, xs, cots = _graph(fn, inputs, seed)
    return torch.autograd.grad(outs, xs, cots)


def phase_backward(cfg) -> dict:
    """Each Function's backward on the card against torch.autograd.grad
    through its plain version, f32, TF32 off, at the training shapes.
    Tolerance 1e-4 of each cotangent's largest entry: the backwards sum
    over H·W (and channels) in another order — with atomics in no fixed
    order for the image cotangents of the warps. Then render_assemble's
    backward kernel against its closed form on the same cotangents, f32
    and bf16 appearance, at the speed128 decoder's scales (one cluster per
    image) and the celeba decoder's (partial sums: 64², 128²; two channel
    chunks: C = 256): 1e-5 of each cotangent's largest (the same f32
    products summed in another order); a bf16 d_app may round to the
    neighbouring bf16 value (one ulp: rtol 2⁻⁷). Repeats must give the
    same bits."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    report = {}
    for name, (fn, plain, inputs) in backward_cases(gen).items():
        before = tracing.counter(BACKWARD_LAUNCHES)
        got = _grads(fn, inputs, SEED + 12)
        launched = tracing.counter(BACKWARD_LAUNCHES) - before
        want = _grads(plain, inputs, SEED + 12)
        torch.cuda.synchronize()
        errs = [_scaled_err(a, b) for a, b in zip(got, want)]
        report[name] = errs
        check(all(math.isfinite(e) and e <= 1e-4 for e in errs),
              f"{name} backward disagrees with autograd through the plain version: {errs}")
        if name == "render_assemble":
            check(launched == len(inputs) - 2,
                  f"render_assemble backward kernel launched {launched} times, expected "
                  f"{len(inputs) - 2} (one per scale)")
    kind = train_config("speed128").model.render_kernel
    closed = {}
    for dtype in (torch.float32, torch.bfloat16):
        _, mu, lam, scales = train_render_inputs(gen, app_dtype=dtype)
        smu, slam, sscales = serving_render_inputs(gen, cfg, dtype)
        for mu, lam, res, app in ([(mu, lam, r, a) for r, a in scales]
                                  + [(smu, slam, r, a) for r, a in sscales]):
            g = torch.randn((app.shape[0], res, res, app.shape[-1]), generator=gen, device="cuda")
            got = render_assemble_backward(mu, lam, app, res, res, kind, g)
            want = render_assemble_vjp(mu, lam, app, res, res, kind, g)
            again = render_assemble_backward(mu, lam, app, res, res, kind, g)
            torch.cuda.synchronize()
            errs = [_scaled_err(a, b) for a, b in zip(got, want)]
            closed[f"B{app.shape[0]} {res}x{app.shape[-1]} {str(dtype)[6:]}"] = errs
            check(all(math.isfinite(e) for e in errs) and max(errs[:2]) <= 1e-5,
                  f"render_assemble backward kernel vs closed form {res} {dtype}: {errs}")
            scale = want[2].float().abs().max().item()
            check(torch.allclose(got[2].float(), want[2].float(), atol=1e-5 * scale,
                                 rtol=0 if dtype == torch.float32 else 2 ** -7),
                  f"render_assemble backward kernel d_app {res} {dtype}: {errs[2]}")
            check(got[2].dtype == dtype and all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"render_assemble backward kernel {res} {dtype}: dtype or repeat differs")
    report["render_assemble_kernel_vs_closed_form"] = closed
    emit("backward", scaled_max_abs_err=report, tolerance="1e-4 of each cotangent's max",
         tolerance_kernel_vs_closed_form="1e-5 of each cotangent's max; bf16 d_app rtol 2^-7")
    return report


def serving_launches() -> dict:
    return {k: launch_counts()[k] for k in ("softmax_moments", "render_assemble")}


def phase_serving(cfg) -> dict:
    """The serving path at full width, counting kernel launches."""
    model = init_weights(PartNet(cfg), seed=SEED).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x_s = torch.rand((BATCH, cfg.img_size, cfg.img_size, 3), generator=gen, device="cuda")
    x_a = torch.rand((BATCH, cfg.img_size, cfg.img_size, 3), generator=gen, device="cuda")
    infer = make_infer_fn(model)

    torch.cuda.synchronize()
    tracing.reset()
    out = infer(x_s)
    after_infer = serving_launches()
    recon = transfer_batch(model, x_s, x_a)
    torch.cuda.synchronize()
    launches = serving_launches()
    spans = tracing.snapshot()["spans"]
    check(spans == {}, f"the serving path ran spans with no profiler on: {spans}")

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



BACKWARD_LAUNCHES = "kernel.render_assemble.backward_launches"
TRAIN_LAUNCHES = {"tps_warp": 1, "softmax_moments": 4, "render_assemble": 6,
                  "bilinear_sample": 0, "render_assemble_backward": 6}


def launch_counts() -> dict:
    """The hand kernels' launches since the registry's last reset (``tracing``)."""
    return {"softmax_moments": tracing.counter("kernel.softmax_moments.launches"),
            "render_assemble": tracing.counter("kernel.render_assemble.launches"),
            "tps_warp": tracing.counter("kernel.tps_warp.launches"),
            "bilinear_sample": tracing.counter("kernel.bilinear_sample.launches"),
            "render_assemble_backward": tracing.counter(BACKWARD_LAUNCHES)}


def phase_train() -> dict:
    """speed128 at B = 128, bf16: warm-up periods (the first at lr = 0),
    then one counted period after which the params must have moved."""
    cfg = train_config("speed128")
    state, period, batches, perceptual = build_trainer(cfg, TRAIN_BATCH, seed=SEED)
    for _ in range(2):
        state, metrics = period(state, batches, cfg.seed)
    torch.cuda.synchronize()
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    lr = warmup_cosine(cfg.optim)(state.opt_state.count)
    tracing.reset()
    state, metrics = period(state, batches, cfg.seed)
    torch.cuda.synchronize()
    launches = launch_counts()
    values = {k: v.item() for k, v in metrics.items()}
    moved = max((v - before[k]).abs().max().item() for k, v in state.model.state_dict().items())
    check(all(math.isfinite(v) for v in values.values()), f"train metrics not finite: {values}")
    check(lr > 0 and moved > 0, f"params did not move (lr {lr}, max |Δ| {moved})")
    check(launches == TRAIN_LAUNCHES, f"train period launches {launches}, expected {TRAIN_LAUNCHES}")
    peak = period_peak_bytes(cfg)
    emit("train", config="speed128", batch=TRAIN_BATCH, dtype=str(cfg.model.dtype),
         vgg_mode=perceptual.vgg_mode, step=state.step, lr=lr, metrics=values,
         max_abs_param_change=moved, launches=launches, period_peak_bytes=peak)
    return {"cfg": cfg, "state": state, "period": period, "batches": batches,
            "launches": launches}


def period_peak_bytes(cfg) -> dict:
    """Peak device memory of one training period with remat off and on, in
    bytes: for each, a fresh trainer (its weights, VGG, Adam moments,
    batches and the period's activations) after one warm period, counted
    above what was allocated before it was built, and freed before the
    next. The trained state of phase train is left as it was."""
    peaks = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=remat))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        state, period, batches, _ = build_trainer(c, TRAIN_BATCH, seed=SEED)
        state, _ = period(state, batches, cfg.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        period(state, batches, cfg.seed)
        torch.cuda.synchronize()
        peaks["remat_on" if remat else "remat_off"] = torch.cuda.max_memory_allocated() - base
        del state, period, batches
    return peaks


def _draws_to(draws: PairDraws, device) -> PairDraws:
    c = draws.color
    return PairDraws(TPSParams(draws.tps.weights.to(device)),
                     ColorParams(*(getattr(c, f.name).to(device) for f in dataclasses.fields(c))))


ULP_NUDGES = 4    # CPU periods from nudged weights that measure a metric's spread


def phase_train_parity() -> None:
    """speed128 at f32, B = 2, from the same weights, state (step 100,
    lr > 0) and draws: the card (kernels, cuDNN, TF32 off) against the CPU
    (plain versions). Tolerances: gradients 1e-4 of the largest (f32
    through ~40 layers, sums in another order). Loss and metrics: rtol
    1e-4 plus the metric's own spread on the CPU, the largest of
    ULP_NUDGES periods in which every weight moves by one ulp, up or
    down at random, at the start of each sub-step. The second sub-step
    starts from weights that Adam moved by ±lr each, and the L1
    perceptual loss has kinks, so there its gradient (grad_norm) can
    jump by more than 1e-4 under a one-ulp change of the weights: the
    card, whose rounding is such a change, is held to what the
    reference itself resolves. Updated params: Adam turns rounding-level
    gradients into full steps of either sign, so |ΔΔ| ≤ 2·3.5·lr
    everywhere, and 1e-2 of that where the first moment exceeds 1e-2 of
    its largest."""
    base = train_config("speed128")
    cfg = base.replace(model=dataclasses.replace(base.model, dtype=torch.float32))
    sampler = cfg.augment.make_sampler()
    gen = torch.Generator().manual_seed(SEED + 20)
    s = cfg.model.img_size
    xs = [torch.rand((2, s, s, 3), generator=gen) for _ in range(2)]
    draws = [keyed_pair_draws(SEED + 21 + i, 0, torch.arange(2), sampler, cfg.augment)
             for i in range(2)]
    cpu_model = init_weights(PartNet(cfg.model, device="cpu"), seed=SEED)
    start = cpu_model.state_dict()

    def nudged(step, flip):
        """``step`` after moving every float weight one ulp up or down, at random."""
        def run(state, batch, seed, draws):
            with torch.no_grad():
                for v in state.model.state_dict().values():
                    if v.is_floating_point():
                        up = torch.rand(v.shape, generator=flip) < 0.5
                        v.copy_(torch.nextafter(v, torch.where(up, math.inf, -math.inf)))
            return step(state, batch, seed, draws)
        return run

    sides = {}
    for side, dev in [("cpu", "cpu"), ("cuda", "cuda")] + [(i, "cpu") for i in range(ULP_NUDGES)]:
        model = PartNet(cfg.model, device=dev)
        model.load_state_dict(start)
        perc = build_perceptual(cfg, dev)
        dr = [_draws_to(d, dev) for d in draws]
        batches = tuple({"image": x.to(dev)} for x in xs)
        state = create_state(cfg, model, step=100)
        if isinstance(side, int):
            flip = torch.Generator().manual_seed(SEED + 23 + side)
            period = compose_period([
                nudged(make_train_step(cfg, model, sampler, perc, warp_on=(i == 0)), flip)
                for i in range(cfg.augment.warp_every)])
            _, metrics = period(state, batches, draws=dr)
            sides[side] = {"metrics": {k: v.item() for k, v in metrics.items()}}
            continue
        loss, _ = make_loss_fn(cfg, model, sampler, perc, warp_on=True)(batches[0], dr[0])
        params = trainable(model)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        state, metrics = make_train_period(cfg, model, sampler, perc)(state, batches, draws=dr)
        sides[side] = {"grads": {k: v.cpu() for k, v in grads.items()},
                       "metrics": {k: v.item() for k, v in metrics.items()},
                       "params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                       "mu": {k: v.cpu() for k, v in state.opt_state.mu.items()}}
    cpu, gpu = sides["cpu"], sides["cuda"]
    metric_err = {k: abs(gpu["metrics"][k] - v) / max(abs(v), 1e-30)
                  for k, v in cpu["metrics"].items()}
    metric_spread = {k: max(abs(sides[i]["metrics"][k] - v) for i in range(ULP_NUDGES))
                     / max(abs(v), 1e-30) for k, v in cpu["metrics"].items()}
    gscale = max(v.abs().max().item() for v in cpu["grads"].values())
    grad_err = {part: max(max_err(gpu["grads"][k], v) for k, v in cpu["grads"].items()
                          if k.startswith(part)) / gscale
                for part in ("shape_enc", "app_enc", "decoder")}
    trunk = sum(v.abs().sum().item() for k, v in gpu["grads"].items() if k.startswith("shape_enc"))
    lr = 1e-3 * 101 / 500
    mscale = max(v.abs().max().item() for v in cpu["mu"].values())
    worst_all = worst_big = 0.0
    for k, p in cpu["params"].items():
        err = ((gpu["params"][k] - start[k]) - (p - start[k])).abs()
        worst_all = max(worst_all, err.max().item())
        big = cpu["mu"][k].abs() > 1e-2 * mscale
        if big.any():
            worst_big = max(worst_big, err[big].max().item())
    emit("train_parity", batch=2, dtype="float32", metric_rel_err=metric_err,
         metric_rel_spread_1ulp_cpu=metric_spread, grad_max_abs_err_over_max=grad_err,
         shape_enc_grad_abs_sum=trunk,
         param_update_err=worst_all, param_update_err_big=worst_big, bound=2 * 3.5 * lr)
    for k, e in metric_err.items():
        check(e <= 1e-4 + metric_spread[k],
              f"train_parity metric {k}: rel err {e} (CPU's one-ulp spread {metric_spread[k]})")
    for part, e in grad_err.items():
        check(e <= 1e-4, f"train_parity {part} gradients: {e} of the largest")
    check(trunk > 0, "no gradient reached the shape encoder on the card")
    check(worst_all <= 2 * 3.5 * lr and worst_big <= 1e-2 * 2 * 3.5 * lr,
          f"train_parity params: {worst_all}, {worst_big} (lr {lr})")


def _profile_one(name: str, fn, batch: int) -> None:
    """One call of ``fn`` under torch.profiler, aggregated by
    tools/trace_step.py (its kernel categories, top kernels, top host ops
    and the kernel wrappers' backward nodes), beside five wall times of
    the call without the profiler."""
    fn()
    torch.cuda.synchronize()
    unprofiled_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        unprofiled_ms.append((time.perf_counter() - t0) * 1e3)
    prof, wall_ms = trace_step.profile_window(fn, 1, cuda=True)
    summary = trace_step.summarize(prof, wall_ms, cuda=True)
    if trace_step.device_us(prof) == 0:   # three empty windows: no breakdown in this run
        PROFILER_FALLBACKS.append({"profile": name})
        summary.update(device_ms=None, idle_share=None, device_time="not measured: "
                       "torch.profiler recorded no device time in three windows")
    emit("profile", request=name, batch=batch, wall_ms=wall_ms, unprofiled_wall_ms=unprofiled_ms,
         **summary)


def phase_profile(served: dict, trained: dict) -> None:
    """Device time by kernel over one infer and one transfer request and
    one train period, from torch.profiler; idle share = 1 − kernel time /
    wall time (one stream, so kernels do not overlap). Beside it, five
    wall times of each without the profiler (call + synchronize)."""
    model, x_s, x_a = served["model"], served["x_s"], served["x_a"]
    infer = make_infer_fn(model)
    _profile_one("infer", lambda: infer(x_s), x_s.shape[0])
    _profile_one("transfer", lambda: transfer_batch(model, x_s, x_a), x_s.shape[0])
    period, batches, seed = trained["period"], trained["batches"], trained["cfg"].seed
    state = trained["state"]
    _profile_one("train_period", lambda: period(state, batches, seed), TRAIN_BATCH)


def phase_train_zeros() -> dict:
    """speed128 with ``augment.padding_mode="zeros"`` (a config field users
    set): the warp then builds the explicit flow and samples it through
    the bilinear_sample kernel instead of tps_warp. One counted period."""
    cfg = train_config("speed128", ["augment.padding_mode='zeros'"])
    state, period, batches, _ = build_trainer(cfg, TRAIN_BATCH, seed=SEED)
    state, _ = period(state, batches, cfg.seed)
    torch.cuda.synchronize()
    tracing.reset()
    state, metrics = period(state, batches, cfg.seed)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {**TRAIN_LAUNCHES, "tps_warp": 0, "bilinear_sample": 1}
    check(all(math.isfinite(v.item()) for v in metrics.values()), "train (zeros) not finite")
    check(launches == want, f"train (zeros padding) launches {launches}, expected {want}")
    emit("train_zeros_padding", launches=launches, loss=metrics["loss"].item())
    return launches


K16_BATCH = 64   # human36m's and penn_action's global_batch 512 over 8 TPU chips
K16_LAUNCHES = {"tps_warp": 1, "softmax_moments": 3, "render_assemble": 8, "bilinear_sample": 0,
                "render_assemble_backward": 8}


def phase_train_k16(smi: str, old=None) -> dict:
    """The deepfashion preset (K = 16, 128 px, features 128, depth 4, the
    4-scale decoder at widths 256/128/64/32, VGG to relu4_2, swap 1.0,
    bf16) at full width, B = 64, through make_train_period: one warm
    period, then one counted period after which the params must have moved
    (exact launches: per step one warp of the whole batch, softmax_moments
    on x_s, x_a and the swap's reconstruction, two decodes of 4 scales and
    their backwards); then period ms by CUDA events, its device ms
    (profiler) and peak memory. Seeded weights, the port's random VGG,
    device-resident random images (DeepFashion is not on the machine).
    Run under ``recording``: the render_assemble forward on each decoder
    scale's inputs that the period gave it, device ms per call beside its
    bound; with ``old`` (another checkout's library), that forward and the
    whole period under it in turns, and whether the forward's outputs hold
    the baseline's bits."""
    cfg = train_config("deepfashion")
    state, period, batches, perceptual = build_trainer(cfg, K16_BATCH, seed=SEED)
    state, _ = period(state, batches, cfg.seed)
    torch.cuda.synchronize()
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    lr = warmup_cosine(cfg.optim)(state.opt_state.count)
    tracing.reset()
    state, metrics = period(state, batches, cfg.seed)
    torch.cuda.synchronize()
    launches = launch_counts()
    values = {k: v.item() for k, v in metrics.items()}
    moved = max((v - before[k]).abs().max().item() for k, v in state.model.state_dict().items())
    del before
    check(all(math.isfinite(v) for v in values.values()), f"train_k16 metrics not finite: {values}")
    check(lr > 0 and moved > 0, f"train_k16 params did not move (lr {lr}, max |Δ| {moved})")
    check(launches == K16_LAUNCHES, f"train_k16 launches {launches}, expected {K16_LAUNCHES}")
    torch.cuda.reset_peak_memory_stats()
    period_ms = event_ms(lambda: period(state, batches, cfg.seed), runs=5, warmup=1)
    period_device_ms = device_ms(lambda: period(state, batches, cfg.seed), calls=2, warmup=0)
    forwards = []
    for (kernel, *_), (path, _, inputs) in PATH_INPUTS.items():
        if kernel == "render_assemble" and path == "train_k16":
            mu_, lam_, app, h, w, kind = inputs

            def call(mu_=mu_, lam_=lam_, app=app, h=h, w=w, kind=kind):
                return render_assemble(mu_, lam_, app, h, w, kind)
            row = {"app": list(app.shape), "res": h, "device_ms": device_ms(call),
                   "bound_ms": bound_ms(*render_assemble_bound(*app.shape, h))[0],
                   **forward_against(old, call)}
            check(row.get("bit_for_bit") is not False,
                  f"train_k16: the forward at {h}² differs from the baseline's")
            forwards.append(row)
    check(len(forwards) == cfg.model.decoder_scales,
          f"train_k16: {len(forwards)} recorded decoder scales")
    period_turns = {}
    if old is not None:
        def old_period():
            with using_library(old):
                period(state, batches, cfg.seed)
        period_turns = dict(zip(("baseline_period_device_ms", "turns_period_device_ms"),
                                turns_ms(old_period, lambda: period(state, batches, cfg.seed),
                                         calls=2, warmup=1)))
    m = cfg.model
    emit("train_k16", config="deepfashion", batch=K16_BATCH, dtype=str(m.dtype),
         n_parts=m.n_parts, vgg_mode=perceptual.vgg_mode, lr=lr, metrics=values,
         max_abs_param_change=moved, launches=launches,
         backward_plans=[backward_plan(m.n_parts, f, (m.decoder_out_size or m.img_size)
                                       // 2 ** (m.decoder_scales - 1 - i), K16_BATCH)
                         for i, f in enumerate(m.decoder_features[:m.decoder_scales])],
         period_ms=period_ms, period_device_ms=period_device_ms, **period_turns,
         forward_by_scale=forwards,
         train_img_per_s=K16_BATCH * cfg.augment.warp_every / period_ms * 1e3,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)
    return launches


def _timed(fn, plain, bound) -> dict:
    """ms: the wrapper's CUDA-event median over back-to-back calls (host
    included); device_ms: its kernels' own time per call (profiler);
    plain_ms: the plain version's event median; bound_ms from (bytes, flops)."""
    row = {"ms": event_ms(fn, inner=KERNEL_INNER), "device_ms": device_ms(fn),
           "plain_ms": event_ms(plain, inner=KERNEL_INNER)}
    row["bound_ms"], row["bound_by"] = bound_ms(*bound)
    return row


def _decode_rows(scales: list[dict]) -> dict:
    """One decode: the sum over its scales of each time, bytes-bound if
    every scale is."""
    out = {key: sum(s[key] for s in scales) for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
    out["bound_by"] = "bytes" if all(s["bound_by"] == "bytes" for s in scales) else "operations"
    return out


def forward_against(old, call) -> dict:
    """With ``old`` (another checkout's library): ``call`` (a wrapper call
    returning a tensor) under it and under this checkout's in turns, device
    ms per call, and whether the two outputs hold the same bits."""
    if old is None:
        return {}
    with using_library(old):
        was = call()

    def old_call():
        with using_library(old):
            return call()
    old_ms, new_ms = turns_ms(old_call, call)
    return {"baseline_device_ms": old_ms, "turns_device_ms": new_ms,
            "bit_for_bit": torch.equal(was, call())}


def phase_wide_decodes(smi: str, old=None) -> None:
    """render_assemble at ``wide_decode_cases``' scales (B = 64): the
    forward (the wrapper's event ms, its device ms, the plain version's
    event ms, the bound; with ``old``, another checkout's forward in turns
    and bit for bit) and the backward kernel (device ms per call from
    the profiler, the wrapper's event ms, the plain closed form's device
    ms, and the bound: bytes, the cotangent g read once), beside the
    backward's launch plan."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    before = tracing.counter(BACKWARD_LAUNCHES)
    rows = []
    for label, k_, mu_, lam_, app, res, g, kind in wide_decode_cases(gen):
        b, _, f = app.shape
        fwd = _timed(lambda: render_assemble(mu_, lam_, app, res, res, kind),
                     lambda: render_assemble_plain(mu_, lam_, app, res, res, kind),
                     render_assemble_bound(b, k_, f, res))
        fwd.update(forward_against(old, lambda: render_assemble(mu_, lam_, app, res, res, kind)))
        check(fwd.get("bit_for_bit") is not False,
              f"timing_wide_decodes: the forward at {label} {res}² differs from the baseline's")
        bound, by = bound_ms(*render_backward_bound(b, k_, f, res))
        dev_ms = device_ms(lambda: render_assemble_backward(mu_, lam_, app, res, res, kind, g))
        rows.append({"model": label, **backward_plan(k_, f, res, b), "forward": fwd,
                     "device_ms": dev_ms,
                     "plain_device_ms": device_ms(
                         lambda: render_assemble_vjp(mu_, lam_, app, res, res, kind, g)),
                     "ms": event_ms(lambda: render_assemble_backward(
                         mu_, lam_, app, res, res, kind, g), inner=KERNEL_INNER),
                     "bound_ms": bound, "bound_by": by, "device_over_bound": dev_ms / bound})
    check(tracing.counter(BACKWARD_LAUNCHES) > before,
          "timing_wide_decodes: the backward kernel did not launch")
    emit("timing_wide_decodes", batch=STUDY_BATCH, dtype="bfloat16 appearance", rows=rows,
         nvidia_smi=smi)


def phase_timing(cfg, served: dict, trained: dict, zeros_launches: dict, errs: dict,
                 smi: str) -> tuple[list[dict], float]:
    """Each kernel's row of the kernels line, and speed128's train img/s
    (phase timing_train)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    k, size = cfg.n_parts, cfg.map_size
    fg = serving_logits(gen, k, size)
    sm = _timed(lambda: softmax_moments(fg), lambda: softmax_moments_plain(fg),
                softmax_moments_bound(BATCH, size, size, k))

    _, mu, sigma = softmax_moments(fg)
    kind = cfg.render_kernel
    scales = []
    for name, mu_, lam, app, res in render_cases(cfg, mu, sigma, gen):
        row = _timed(lambda: render_assemble(mu_, lam, app, res, res, kind),
                     lambda: render_assemble_plain(mu_, lam, app, res, res, kind),
                     render_assemble_bound(BATCH, k, app.shape[-1], res))
        scales.append({"scale": name, **row})
    emit("timing_render_assemble_scales", batch=BATCH, scales=scales, nvidia_smi=smi)

    # The training shapes: B = 128, the speed128 maps and decoder (bf16
    # appearance, as the bf16 step passes it).
    tcfg_m = train_config("speed128").model
    tk = tcfg_m.n_parts
    tlogits, tmu, tlam, tscales = train_render_inputs(gen, app_dtype=torch.bfloat16)
    tfg = tlogits[..., :tk]
    tm = tfg.shape[1]
    sm_train = _timed(lambda: softmax_moments(tfg), lambda: softmax_moments_plain(tfg),
                      softmax_moments_bound(TRAIN_BATCH, tm, tm, tk))
    train_scales = []
    for res, app in tscales:
        row = _timed(lambda: render_assemble(tmu, tlam, app, res, res, tcfg_m.render_kernel),
                     lambda: render_assemble_plain(tmu, tlam, app, res, res, tcfg_m.render_kernel),
                     render_assemble_bound(TRAIN_BATCH, tk, app.shape[-1], res))
        train_scales.append({"scale": f"{res}x{app.shape[-1]}", **row})
    ra_train = _decode_rows(train_scales)
    # The backward per training decode: the kernel pair against the plain
    # closed form, device time; the bound is one read of g.
    cots = [torch.randn((TRAIN_BATCH, res, res, app.shape[-1]), generator=gen, device="cuda")
            for res, app in tscales]

    def decode_backward(fn):
        return lambda: [fn(tmu, tlam, app, res, res, tcfg_m.render_kernel, g)
                        for (res, app), g in zip(tscales, cots)]

    ra_bwd = {"device_ms": device_ms(decode_backward(render_assemble_backward)),
              "plain_device_ms": device_ms(decode_backward(render_assemble_vjp)),
              "bound_ms": sum(bound_ms(*render_backward_bound(TRAIN_BATCH, tk, app.shape[-1],
                                                              res))[0]
                              for res, app in tscales),
              "scales": [{"scale": f"{res}x{app.shape[-1]}",
                          "device_ms": device_ms(lambda: render_assemble_backward(
                              tmu, tlam, app, res, res, tcfg_m.render_kernel, g)),
                          "bound_ms": bound_ms(*render_backward_bound(
                              TRAIN_BATCH, tk, app.shape[-1], res))[0]}
                         for (res, app), g in zip(tscales, cots)]}
    emit("timing_training_shapes", batch=TRAIN_BATCH, softmax_moments=sm_train,
         render_assemble_scales=train_scales, render_assemble_backward=ra_bwd, nvidia_smi=smi)

    # The warp kernels at the training shapes, bf16 as the step runs them.
    img, weights, basis, coords = warp_inputs(gen, torch.bfloat16)
    nw, s = img.shape[0], img.shape[1]
    m = weights.shape[1]
    tw = _timed(lambda: tps_warp(img, weights, basis), lambda: tps_warp_plain(img, weights, basis),
                tps_warp_bound(nw, s, s, 3, m, 2))
    prior = _with_band(56)
    kh, tile = band_config(img.dtype, s, s)
    tw["band_kh56"] = _timed(lambda: tps_warp(img, weights, basis),
                             lambda: tps_warp_plain(img, weights, basis, kh, tile),
                             tps_warp_bound(nw, s, s, 3, m, 2))
    _with_band(0)
    if prior is not None:
        os.environ["PARTSEG_WARP_BAND"] = prior
    pair = tps_library_pair(img, weights, basis)
    tw.update(library_pair=TPS_LIBRARY_PAIR, library_pair_ms=event_ms(pair, inner=KERNEL_INNER),
              library_pair_device_ms=device_ms(pair))
    bs = _timed(lambda: bilinear_sample_fused(img, coords),
                lambda: bilinear_sample_plain(img, coords), bilinear_bound(nw, s * s, 3, 2, s * s))
    bs["grads_device_ms"] = device_ms(lambda: sample_with_grads(img, coords))
    bs["grads_bound_ms"] = bound_ms(*bilinear_bound(nw, s * s, 3, 2, s * s, grads=True))[0]
    grid = coords.flip(-1)[:, None].to(img.dtype).contiguous()
    nchw = img.permute(0, 3, 1, 2)

    def grid_sample():
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    bs["library_ms"] = event_ms(grid_sample, inner=KERNEL_INNER)
    bs["library_device_ms"] = device_ms(grid_sample)
    emit("timing_warp_kernels", images=nw, size=s, dtype="bfloat16", tps_warp=tw,
         bilinear_sample=bs, nvidia_smi=smi)

    # Each Function's backward at the training shapes (f32 inputs).
    bwd = {}
    for name, (fn, plain, inputs) in backward_cases(gen).items():
        for label, f in (("ms", fn), ("plain_ms", plain)):
            outs, xs, cots = _graph(f, inputs, SEED + 13)
            bwd.setdefault(name, {})[label] = event_ms(
                lambda: torch.autograd.grad(outs, xs, cots, retain_graph=True), runs=10)
            if label == "ms":
                bwd[name]["device_ms"] = device_ms(
                    lambda: torch.autograd.grad(outs, xs, cots, retain_graph=True))
    bwd["tps_warp"]["bound_ms"], bwd["tps_warp"]["bound_by"] = bound_ms(
        *tps_warp_backward_bound(nw, s, s, 3, m, 4))
    emit("timing_backward", batch=TRAIN_BATCH, backward=bwd, nvidia_smi=smi)


    model, x_s, x_a = served["model"], served["x_s"], served["x_a"]
    infer = make_infer_fn(model)
    torch.cuda.reset_peak_memory_stats()
    infer_ms = event_ms(lambda: infer(x_s), warmup=2)
    transfer_ms = event_ms(lambda: transfer_batch(model, x_s, x_a), warmup=2)
    emit("timing_end_to_end", batch=BATCH, dtype=str(cfg.dtype),
         infer_ms=infer_ms, infer_img_per_s=BATCH / infer_ms * 1e3,
         transfer_ms=transfer_ms, transfer_img_per_s=BATCH / transfer_ms * 1e3,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)

    tcfg, state = trained["cfg"], trained["state"]
    period, batches = trained["period"], trained["batches"]
    torch.cuda.reset_peak_memory_stats()
    period_ms = event_ms(lambda: period(state, batches, tcfg.seed), runs=10, warmup=2)
    images = TRAIN_BATCH * tcfg.augment.warp_every
    train_img_per_s = images / period_ms * 1e3
    emit("timing_train", config="speed128", batch=TRAIN_BATCH, dtype=str(tcfg.model.dtype),
         period_ms=period_ms, images_per_period=images, train_img_per_s=train_img_per_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)

    ra = _decode_rows(scales)
    train = trained["launches"]

    def train_shape(row: dict) -> dict:
        return {"train_" + key: row[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms")}

    kernels = [
        {"name": "softmax_moments", "route": "cuda",
         "source": "partseg_tpu_torch/csrc/softmax_moments.cu",
         "replaces": "partseg_tpu/partops/pallas/softmax_moments.py:73",
         "launches": train["softmax_moments"], "path": "speed128 train period",
         "launches_serving": served["launches"]["softmax_moments"],
         "max_abs_err": errs["softmax_moments"], "ms": sm["ms"], "device_ms": sm["device_ms"],
         "plain_ms": sm["plain_ms"], "bound_ms": sm["bound_ms"], "bound_by": sm["bound_by"],
         "library_ms": None, "library_device_ms": None, **train_shape(sm_train),
         "backward_ms": bwd["softmax_moments"]["ms"],
         "per": f"one call, logits [{BATCH},{size},{size},{k}] of [..,{k + 1}]; train_*: "
                f"[{TRAIN_BATCH},{tm},{tm},{tk}]"},
        {"name": "render_assemble", "route": "cuda",
         "source": "partseg_tpu_torch/csrc/render_assemble.cu",
         "replaces": "partseg_tpu/partops/pallas/render_assemble.py:121",
         "launches": train["render_assemble"], "path": "speed128 train period",
         "launches_serving": served["launches"]["render_assemble"],
         "max_abs_err": errs["render_assemble"], **ra,
         "library_ms": None, "library_device_ms": None, **train_shape(ra_train),
         "backward_route": "cuda", "backward_launches": train["render_assemble_backward"],
         "backward_ms": bwd["render_assemble"]["ms"],
         "backward_device_ms": ra_bwd["device_ms"],
         "backward_plain_device_ms": ra_bwd["plain_device_ms"],
         "backward_bound_ms": ra_bwd["bound_ms"],
         "per": f"one decode: {len(scales)} launches at B={BATCH}; train_* and backward_*: "
                f"{len(tscales)} scales at B={TRAIN_BATCH}"},
        {"name": "tps_warp", "route": "cuda",
         "source": "partseg_tpu_torch/csrc/tps_warp.cu",
         "replaces": "partseg_tpu/partops/pallas/bilinear_warp.py:392",
         "launches": train["tps_warp"], "path": "speed128 train period",
         "max_abs_err": errs["tps_warp"], **tw, "library_ms": None, "library_device_ms": None,
         "backward_ms": bwd["tps_warp"]["ms"], "backward_device_ms": bwd["tps_warp"]["device_ms"],
         "backward_bound_ms": bwd["tps_warp"]["bound_ms"],
         "per": f"one call, image [{nw},{s},{s},3] bf16; band_kh56: the band mode at kh = 56; "
                f"backward_*: f32 inputs"},
        {"name": "bilinear_sample", "route": "cuda",
         "source": "partseg_tpu_torch/csrc/bilinear_sample.cu",
         "replaces": "partseg_tpu/partops/pallas/bilinear_warp.py:259",
         "launches": zeros_launches["bilinear_sample"],
         "path": "speed128 train period with augment.padding_mode=zeros",
         "launches_speed128": train["bilinear_sample"],
         "max_abs_err": errs["bilinear_sample"], **bs,
         "backward_ms": bwd["bilinear_sample"]["ms"],
         "per": f"one call, image [{nw},{s},{s},3] bf16 at {s * s} points each"},
    ]
    return kernels, train_img_per_s


def _backward_rule(baseline: Path):
    """The tile rule of a checkout's render_assemble backward, loaded from
    its own wrapper module: (backward_tile, backward_partial_rows or None
    where the scratch holds one row per tile)."""
    mod = _load_module(baseline / "partseg_tpu_torch" / "partops" / "kernels"
                       / "render_assemble.py", "baseline_render_assemble")
    return mod.backward_tile, getattr(mod, "backward_partial_rows", None)


@contextlib.contextmanager
def using_library(lib):
    """The wrappers launch ``lib``'s entry points (another checkout's
    kernels, built from its csrc/) while this runs; their launch rules in
    Python stay this checkout's."""
    own = _build.library
    _build.library = lambda csrc=_build.CSRC_DIR: lib
    try:
        yield
    finally:
        _build.library = own


def turns_ms(old_call, new_call, **kw) -> tuple[list, list]:
    """Device ms per call of two callables in the order old, new, new, old
    (``kw`` to device_ms): ([old, old], [new, new])."""
    ms = [device_ms(f, **kw) for f in (old_call, new_call, new_call, old_call)]
    return [ms[0], ms[3]], [ms[1], ms[2]]


def phase_tps_wide(smi: str, old=None) -> None:
    """tps_warp where the basis is staged in chunks of columns: grid 20
    unbanded (M = 403) and grid 15 at band kh = 56 (M = 228), at the
    training warp shape (32 images of 128²×3 bf16), through
    TPSSampler.warp, the main path (its basis rows padded to 16 bytes, as
    the kernel's wide path reads them; timed on those inputs). Device time per call
    beside the bound, the wrapper's and the plain version's event times,
    and the library pair's (tps_flow + F.grid_sample, unbanded). The
    output is held within one bf16 ulp below 1 (2⁻⁸, + 1e-4) of the plain
    sample at the flow summed in the kernel's
    order (kernel_order_flow), as the card tests hold it: the plain
    einsum's order differs from the kernel's by up to 0.006 px at grid 20,
    so its error is printed beside the check, unchecked. With ``old``
    (another checkout's library), its entry point on the same inputs in
    turns with this one's (old, new, new, old), and whether the two outputs
    hold the same bits (they must)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    prior = os.environ.get("PARTSEG_WARP_BAND")
    for grid, kh in ((20, 0), (15, 56)):
        _with_band(kh)
        sampler = TPSSampler(grid_size=grid)
        img = torch.rand((32, 128, 128, 3), generator=gen, device="cuda").to(torch.bfloat16)
        weights = sampler.sample(gen, 32).weights.contiguous()
        basis = sampler.flow_basis(128, 128, "cuda")
        band, tile = band_config(img.dtype, 128, 128)
        m = weights.shape[1]
        plan = launch_plan(32, 128, 128, m, band, tile)
        check(band == kh and plan.chunk < m, f"tps_warp M = {m}: band {band}, plan {plan}")
        got = sampler.warp(TPSParams(weights), img)    # the main path: 16-byte basis rows
        kw, kb = pad_columns(weights, basis)            # as TPSSampler.warp passes them
        flow, _ = kernel_order_flow(weights, basis)
        err = max_err(got, tps_sample_plain(img.float(), flow, band, tile).to(img.dtype))
        check(bool(torch.isfinite(got).all()), f"tps_warp M = {m}: output not finite")
        check(err <= 2 ** -8 + 1e-4, f"tps_warp M = {m}: {err} from the plain sample at the "
                                     "flow in the kernel's order")
        einsum_err = max_err(got, tps_warp_plain(img.float(), weights, basis, band, tile))
        bound, by = bound_ms(*tps_warp_bound(32, 128, 128, 3, m, 2))
        pair = tps_library_pair(img, weights, basis)
        baseline = {}
        if old is not None:   # each tree's main-path inputs: the basis as it was, and padded
            was = _tps_launch(old, img, weights, basis, band, tile)
            outs = {id(lib): torch.empty_like(img) for lib in (old, _build.library())}

            def call(lib, w_, b_):
                return lambda: _build.launch(
                    "partseg_tps_warp", img.device, img.data_ptr(), 1, w_.data_ptr(),
                    b_.data_ptr(), outs[id(lib)].data_ptr(), 32, 128, 128, 3, w_.shape[1], tile,
                    band, lib=lib)
            old_ms, new_ms = turns_ms(call(old, weights, basis), call(_build.library(), kw, kb))
            same = torch.equal(was, got)
            check(same, f"tps_warp M = {m}: differs from the baseline's kernel")
            baseline = {"baseline_device_ms": old_ms, "turns_device_ms": new_ms,
                        "bit_for_bit": same}
        emit("tps_wide", grid=grid, m=m, band=band, chunk=plan.chunk, group=plan.group,
             max_abs_vs_kernel_order=err, max_abs_vs_plain_einsum=einsum_err, **baseline,
             device_ms=[device_ms(lambda: tps_warp(img, kw, kb)) for _ in range(2)],
             ms=event_ms(lambda: tps_warp(img, kw, kb), inner=KERNEL_INNER),
             plain_ms=event_ms(lambda: tps_warp_plain(img, weights, basis, band, tile),
                               inner=KERNEL_INNER),
             library_pair=TPS_LIBRARY_PAIR + ("" if not band else "; unbanded"),
             library_pair_device_ms=device_ms(pair),
             library_pair_ms=event_ms(pair, inner=KERNEL_INNER),
             bound_ms=bound, bound_by=by, nvidia_smi=smi)
    _with_band(0)
    if prior is not None:
        os.environ["PARTSEG_WARP_BAND"] = prior


LOOP_STEPS = 32


def _loop_config(run_dir: str, overrides=()):
    """speed128 at full width through the loop: B = 128 on the one card
    (the preset's 1024 is eight TPU chips' worth), scan_groups = 8 and
    warp_every = 2 (16 steps per call), bf16, the synthetic dataset at
    128 px with 256 examples (rendered once, then served from its cache)."""
    return train_config("speed128", [
        "global_batch=128", "dataset='synthetic'",
        "dataset_kwargs=(('size',128),('n_examples',256))", "ckpt_every=16",
        "log_every=16", "image_log_every=0", f"ckpt_dir={run_dir!r}", *overrides])


def _loop_log(run_dir: str) -> dict:
    return {rec["step"]: rec for rec in map(json.loads, Path(run_dir, "metrics.jsonl")
                                            .read_text().splitlines())}


def _host_costs(cfg) -> dict:
    """What the loop adds per batch on the host, each timed alone (median
    of 8, ms): taking a batch of 128 cached examples from the loader
    (its thread pool stacks them), and its copy to the card (pinned,
    non_blocking, then a synchronize)."""
    from partseg_tpu_torch.data import build_dataset, make_loader

    it = make_loader(build_dataset(cfg.dataset, **dict(cfg.dataset_kwargs)),
                     cfg.global_batch, seed=cfg.seed, num_workers=4)
    for _ in range(2):          # every example rendered once, then cached
        next(it)
    fetch, copy = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        hb = next(it)
        t1 = time.perf_counter()
        torch.from_numpy(hb["image"]).pin_memory().to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        fetch.append((t1 - t0) * 1e3)
        copy.append((time.perf_counter() - t1) * 1e3)
    return {"host_batch_ms": statistics.median(fetch), "h2d_copy_ms": statistics.median(copy)}


def _same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k].to(a[k].device)) for k in a)


def phase_train_loop() -> dict:
    """The train loop on the card (the trainer's entry points: train/loop.py
    and the CLI), speed128 at B = 128 under deterministic algorithms:
      1. 32 steps through the streaming loader: finite losses in
         metrics.jsonl, checkpoints at 16 and 32, and per period exactly
         phase train's kernel launches (counts set to 0 just before);
      2. 16 steps in a fresh directory, then a second call to 32 that
         restores: its logged loss over steps 16–31 and its parameters
         equal run 1's, bit for bit;
      3. the CLI with scan_groups = 1 killed at step 5 by fault injection
         (exit 42), then resumed to step 16 (exit 0);
      4. device_data, 32 steps: the losses it logs and its parameters
         equal run 1's, bit for bit; its logged img/s beside run 1's;
      5. run 1 again with the default (nondeterministic) algorithms, as
         users run it: finite losses, and its logged img/s."""
    import tempfile

    from partseg_tpu_torch.train.loop import train

    torch.use_deterministic_algorithms(True)
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runs = {k: os.path.join(tmp, k) for k in ("full", "split", "cli", "device",
                                                      "default")}
            full_cfg = _loop_config(runs["full"], [f"steps={LOOP_STEPS}"])
            tracing.reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            full = train(full_cfg)
            torch.cuda.synchronize()
            out["wall_s"] = {"full_32": time.perf_counter() - t0}
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            launches = launch_counts()
            periods = LOOP_STEPS // full_cfg.augment.warp_every
            want = {k: v * periods for k, v in TRAIN_LAUNCHES.items()}
            check(launches == want, f"train_loop launches {launches} over {periods} periods, "
                                    f"expected {want}")
            log = _loop_log(runs["full"])
            ckpts = sorted(int(p.stem) for p in Path(runs["full"], "checkpoints").glob("*.pt"))
            check(sorted(log) == [0, 16] and ckpts == [16, 32],
                  f"train_loop logged steps {sorted(log)}, checkpoints {ckpts}")
            check(all(math.isfinite(v) for rec in log.values() for v in rec.values()
                      if not isinstance(v, str)), f"train_loop metrics not finite: {log}")
            out["img_per_sec_per_chip"] = {s: log[s]["img_per_sec_per_chip"] for s in log}
            out["loss"] = {s: log[s]["loss"] for s in log}
            full_params = {k: v.detach().clone() for k, v in full.model.state_dict().items()}
            del full

            t0 = time.perf_counter()
            train(_loop_config(runs["split"], ["steps=16"]))
            out["wall_s"]["streaming_16"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            resumed = train(_loop_config(runs["split"], [f"steps={LOOP_STEPS}"]))
            out["wall_s"]["resume_16_to_32"] = time.perf_counter() - t0
            split_log = _loop_log(runs["split"])
            check(split_log[16]["loss"] == log[16]["loss"],
                  f"resumed loss {split_log[16]['loss']} != uninterrupted {log[16]['loss']}")
            check(_same_bits(full_params, resumed.model.state_dict()),
                  "resumed parameters differ from the uninterrupted run's")
            out["resume"] = "bit for bit"
            del resumed

            cli = [sys.executable, "-m", "partseg_tpu_torch.train.cli", "--config", "speed128",
                   "--ckpt_dir", runs["cli"], "--steps", "16", "--set",
                   "global_batch=128", "dataset='synthetic'",
                   "dataset_kwargs=(('size',128),('n_examples',256))", "scan_groups=1",
                   "ckpt_every=4", "log_every=4", "image_log_every=8"]
            t0 = time.perf_counter()
            r1 = subprocess.run(cli + ["fault_injection_step=5"], capture_output=True, text=True,
                                timeout=300)
            r2 = subprocess.run(cli, capture_output=True, text=True, timeout=300)
            out["wall_s"]["cli_fault_and_resume"] = time.perf_counter() - t0
            check(r1.returncode == 42, f"fault injection exited {r1.returncode}: {r1.stderr[-2000:]}")
            check(r2.returncode == 0 and "restored checkpoint at step 4" in r2.stdout,
                  f"resume after the fault exited {r2.returncode}: {r2.stderr[-2000:]}")
            cli_log = _loop_log(runs["cli"])
            check(max(cli_log) == 14, f"CLI resume logged steps {sorted(cli_log)}")
            out["cli"] = {"fault_rc": r1.returncode, "resume_rc": r2.returncode,
                          "logged_steps": sorted(cli_log)}

            t0 = time.perf_counter()
            dev_state = train(_loop_config(runs["device"], [f"steps={LOOP_STEPS}",
                                                            "device_data=True"]))
            out["wall_s"]["device_data_32"] = time.perf_counter() - t0
            dev_log = _loop_log(runs["device"])
            out["device_data_img_per_sec_per_chip"] = {
                s: dev_log[s]["img_per_sec_per_chip"] for s in dev_log}
            check({s: r["loss"] for s, r in dev_log.items()} == out["loss"],
                  f"device_data losses {dev_log} != streaming {out['loss']}")
            check(_same_bits(full_params, dev_state.model.state_dict()),
                  "device_data parameters differ from streaming's")
            out["device_data"] = "bit for bit with streaming"
            out["per_batch"] = _host_costs(full_cfg)

            torch.use_deterministic_algorithms(False)
            t0 = time.perf_counter()
            train(_loop_config(runs["default"], [f"steps={LOOP_STEPS}"]))
            out["wall_s"]["default_algorithms_32"] = time.perf_counter() - t0
            default_log = _loop_log(runs["default"])
            check(all(math.isfinite(r["loss"]) for r in default_log.values()),
                  f"train_loop with default algorithms: {default_log}")
            out["default_algorithms_img_per_sec_per_chip"] = {
                s: r["img_per_sec_per_chip"] for s, r in default_log.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    emit("train_loop", config="speed128", batch=TRAIN_BATCH, steps=LOOP_STEPS,
         launches_per_period=TRAIN_LAUNCHES,
         deterministic_runs=["full_32", "streaming_16", "resume_16_to_32", "device_data_32"],
         **out)
    return out


# ---------------------------------------------------------------- several ranks
#
# Phases dp and spatial start ranks with torchrun (this file again, with
# --child; or the train CLI). The H100 host has shown one card: two ranks
# then share cuda:0 and talk through gloo, which stages CUDA tensors through
# the host (NCCL refuses two ranks on one GPU). With two or more cards, the
# dp step runs once more with NCCL, one card per rank.

DP_BATCH = 128            # speed128's per-card batch, per rank
DP_START = 20             # a step with lr > 0 under speed128's warmup
DP_PERIODS = 4            # timed periods per rank
SPATIAL_BATCH = 32        # celeba256_spatial's batch per data shard (128 over 4)
SPATIAL_STEPS = 3
SPATIAL_START = 1         # lr 2e-5 in the narrow parity config


def _torchrun(args: list, timeout: float, nproc: int = 2) -> subprocess.CompletedProcess:
    """``torchrun --standalone --nproc_per_node=nproc ARGS`` from the repo
    root in a session of its own, killed whole (workers too) at ``timeout``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        raise SmokeError(f"{' '.join(args[:3])} timed out after {timeout} s: {err[-3000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def _child_init(backend: str) -> tuple[torch.device, int, int]:
    """Join torchrun's process group: every rank on cuda:0 with gloo, or on
    cuda:LOCAL_RANK with NCCL."""
    import torch.distributed as dist

    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda:0" if backend == "gloo" else f"cuda:{local}")
    torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", **kw)
    return dev, dist.get_rank(), dist.get_world_size()


def child_dp(out_dir: Path, backend: str) -> None:
    """One rank of phase dp: speed128 at full width, DP_BATCH per rank.
      1. One data-parallel step from DP_START (deterministic algorithms),
         and on rank 0 the port's one-process step run per shard from the
         same weights and draws, its gradients and metrics averaged (each
         shard rolls its own appearance for the swap term): the metrics
         within 1e-4 relative, Adam's first moments (0.1 × the averaged
         gradient) within 1e-4 of the largest, the parameters within 1e-4
         of each tensor's largest, the train_parity bounds.
      2. DP_PERIODS timed periods (default algorithms): the launches per
         period, img/s of this rank, and the gradient all-reduce's ms."""
    import torch.distributed as dist

    from partseg_tpu_torch.dist import average, broadcast_parameters, make_mesh
    from partseg_tpu_torch.train.loop import aug_ids
    from partseg_tpu_torch.train.state import make_optimizer

    dev, rank, world = _child_init(backend)
    torch.use_deterministic_algorithms(True)
    # The swap term on for the held step, so that each shard rolls its own
    # appearance; the timed periods run the preset as it is.
    cfg = train_config("speed128", ["loss.swap_weight=0.5"])
    mesh = make_mesh()
    gb = DP_BATCH * world
    gen = torch.Generator(device=dev).manual_seed(SEED)
    full = [torch.rand((gb, 128, 128, 3), generator=gen, device=dev) for _ in range(2)]
    model = init_weights(PartNet(cfg.model, device="cpu"), seed=SEED).to(dev)
    broadcast_parameters(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    perceptual = build_perceptual(cfg, dev)
    sampler = cfg.augment.make_sampler()
    seed = cfg.seed + 1

    def shard(x, d):
        return x[d * DP_BATCH:(d + 1) * DP_BATCH]

    state = create_state(cfg, model, step=DP_START)
    step = make_train_step(cfg, model, sampler, perceptual, warp_on=True, group=mesh.data_group)
    tracing.reset()
    with recording("dp"):
        state, metrics = step(state, {"image": shard(full[0], rank),
                                      "aug_id": aug_ids(DP_BATCH, rank, DP_START, 0, gb)}, seed)
    torch.cuda.synchronize()
    out = {"rank": rank, "world": world, "backend": backend, "device": str(dev),
           "step_launches": launch_counts()}
    if rank == 0:
        ref = PartNet(cfg.model, device=dev)
        ref.load_state_dict(start)
        ref_state = create_state(cfg, ref, step=DP_START)
        loss_fn = make_loss_fn(cfg, ref, sampler, perceptual, warp_on=True)
        params = list(trainable(ref).values())
        grads, shard_metrics = [torch.zeros_like(p) for p in params], []
        for d in range(world):
            draws = keyed_pair_draws(seed, DP_START, aug_ids(DP_BATCH, d, DP_START, 0, gb),
                                     sampler, cfg.augment, dev)
            loss, m = loss_fn({"image": shard(full[0], d)}, draws)
            gs = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [a + (torch.zeros_like(a) if g is None else g) for a, g in zip(grads, gs)]
            shard_metrics.append({k: v.detach() for k, v in m.items()})
        grads = [g / world for g in grads]
        want = {k: torch.stack([m[k] for m in shard_metrics]).mean() for k in shard_metrics[0]}
        want["grad_norm"] = make_optimizer(cfg.optim).update(ref, grads, ref_state.opt_state)
        metric_err = {k: abs(metrics[k].item() - v.item()) / max(abs(v.item()), 1e-30)
                      for k, v in want.items()}
        mu_scale = max(v.abs().max().item() for v in ref_state.opt_state.mu.values())
        mu_err = max((state.opt_state.mu[k] - v).abs().max().item()
                     for k, v in ref_state.opt_state.mu.items()) / mu_scale
        param_err = max(_scaled_err(v, ref.state_dict()[k])
                        for k, v in state.model.state_dict().items())
        out.update(metric_rel_err=metric_err, mu_err_of_max=mu_err, param_err_of_max=param_err,
                   loss=metrics["loss"].item(), swap_in_loss="swap" in metrics)
        check(max(metric_err.values()) <= 1e-4 and mu_err <= 1e-4 and param_err <= 1e-4,
              f"dp step against the per-shard steps averaged: metrics {metric_err}, "
              f"moments {mu_err}, params {param_err}")
        out["path_kernels"] = _check_path_inputs_f32()
        del ref, ref_state
    torch.use_deterministic_algorithms(False)
    dist.barrier()

    cfg = train_config("speed128")
    period = make_train_period(cfg, model, sampler, perceptual, group=mesh.data_group)
    batches = tuple({"image": shard(full[j], rank), "aug_id": aug_ids(DP_BATCH, rank, 0, j, gb)}
                    for j in range(2))
    for _ in range(2):
        state, metrics = period(state, batches, seed)
    torch.cuda.synchronize()
    dist.barrier()
    tracing.reset()
    t0 = time.perf_counter()
    for _ in range(DP_PERIODS):
        state, metrics = period(state, batches, seed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    out["launches_per_period"] = {k: v / DP_PERIODS for k, v in counts.items()}
    out["img_per_sec_this_rank"] = DP_PERIODS * 2 * DP_BATCH / dt
    out["period_ms"] = dt / DP_PERIODS * 1e3
    bufs = [torch.zeros_like(p) for p in trainable(model).values()] + [
        torch.zeros((), device=dev) for _ in metrics]
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        average(bufs, mesh.data_group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["grad_allreduce_ms_per_step"] = statistics.median(times)
    out["grad_allreduce_bytes"] = 4 * sum(b.numel() for b in bufs)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["final_metrics_finite"] = all(math.isfinite(v.item()) for v in metrics.values())
    check(out["final_metrics_finite"], f"dp period metrics not finite on rank {rank}")
    (out_dir / f"dp_{backend}_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def _check_path_inputs_f32() -> list:
    """check_path_inputs with TF32 off, as the plain versions' f32 products
    need (the smoke's other phases turn it off too)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return check_path_inputs()[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _log_records(run_dir: str) -> list:
    path = Path(run_dir, "metrics.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def phase_dp(smi: str) -> dict:
    """Data parallel on the card: child_dp (2 ranks on cuda:0 with gloo, and
    with NCCL on two cards where there are two), then the train CLI under
    torchrun, speed128 at global_batch 2 × 128 with --deterministic: killed
    by fault injection at step 5 (both ranks), resumed from the step-4
    checkpoint. The resumed period at step 4 logs the same metrics as the
    killed run's, bit for bit, and the killed run logged each step once
    (one writer). Returns rank 0's launches per period."""
    torch.cuda.empty_cache()
    out = {"card": smi}
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    with tempfile.TemporaryDirectory() as tmp:
        for backend in backends:
            t0 = time.perf_counter()
            r = _torchrun([str(ROOT / "chip_smoke.py"), "--child", "dp", "--backend", backend,
                           "--out", tmp], timeout=300)
            check(r.returncode == 0, f"dp child ({backend}) exited {r.returncode}: "
                                     f"{r.stdout[-2000:]} {r.stderr[-4000:]}")
            ranks = [json.loads(Path(tmp, f"dp_{backend}_rank{i}.json").read_text())
                     for i in range(2)]
            out[backend] = {"wall_s": time.perf_counter() - t0, "ranks": ranks,
                            "img_per_sec_card": sum(x["img_per_sec_this_rank"] for x in ranks)}
            want = {k: v for k, v in TRAIN_LAUNCHES.items()}
            for x in ranks:
                check(x["launches_per_period"] == want,
                      f"dp rank {x['rank']} launches per period {x['launches_per_period']}, "
                      f"expected {want}")

        run = os.path.join(tmp, "cli")
        cli = ["-m", "partseg_tpu_torch.train.cli", "--config", "speed128", "--device", "cuda:0",
               "--dist_backend", "gloo", "--deterministic", "--ckpt_dir", run, "--steps", "8",
               "--set", f"global_batch={2 * DP_BATCH}", "dataset='synthetic'",
               "dataset_kwargs=(('size',128),('n_examples',512))", "scan_groups=1",
               "ckpt_every=4", "log_every=2", "image_log_every=4"]
        t0 = time.perf_counter()
        r1 = _torchrun(cli + ["fault_injection_step=5"], timeout=240)
        killed = _log_records(run)
        r2 = _torchrun(cli, timeout=240)
        out["cli_wall_s"] = time.perf_counter() - t0
        check(r1.returncode != 0 and r1.stdout.count("FAULT INJECTION") == 2,
              f"fault injection: torchrun exited {r1.returncode}: {r1.stdout[-2000:]}")
        check(r2.returncode == 0 and r2.stdout.count("restored checkpoint at step 4") == 2,
              f"resume exited {r2.returncode}: {r2.stdout[-2000:]} {r2.stderr[-3000:]}")
        check(r1.stdout.count("backend gloo, device cuda:0") == 2,
              f"the CLI did not print each rank's backend and device: {r1.stdout[-2000:]}")
        steps = [rec["step"] for rec in killed]
        check(steps == [0, 2, 4], f"killed run logged steps {steps} (one writer: each once)")
        resumed = [rec for rec in _log_records(run)[len(killed):]]
        check([rec["step"] for rec in resumed] == [4, 6], f"resumed run logged {resumed}")
        same = {k: resumed[0][k] == killed[2][k] for k in killed[2]
                if k not in ("img_per_sec_per_chip", "time")}
        check(all(same.values()), f"resumed step 4 differs from the killed run's: {same}")
        out["cli"] = {"fault_rc": r1.returncode, "resume_rc": r2.returncode,
                      "loss_step4": killed[2]["loss"],
                      "img_per_sec_per_chip": [rec["img_per_sec_per_chip"] for rec in resumed],
                      "resume": "bit for bit"}
    gl = out["gloo"]["ranks"]
    emit("dp", config="speed128", batch_per_rank=DP_BATCH, ranks=2, **out,
         launches_per_period=[x["launches_per_period"] for x in gl],
         grad_allreduce_ms_per_step=[x["grad_allreduce_ms_per_step"] for x in gl])
    return gl[0]["launches_per_period"]


def _narrow_spatial_config() -> TrainConfig:
    """A narrow f32 config for the card's spatial parity (64 px, features
    32, depth 2, K = 4, 3 decoder scales, VGG to relu2_2 so that a max pool
    runs on the row shards, swap on), B = 2."""
    return TrainConfig(
        model=PartNetConfig(n_parts=4, img_size=64, features=32, depth=2, app_features=16,
                            decoder_scales=3, decoder_features=(32, 16, 8), dtype=torch.float32),
        augment=AugmentConfig(tps_grid=3),
        loss=LossConfig(vgg_layers=("relu1_2", "relu2_2"), vgg_trim_blocks=2, swap_weight=0.5),
        optim=OptimConfig(lr=2e-4, warmup_steps=10, decay_steps=100),
        global_batch=2)


def child_spatial(out_dir: Path) -> None:
    """One rank of phase spatial (1 data × 2 space ranks on cuda:0, gloo):
      1. gloo's all_reduce and all_gather of bf16 CUDA tensors;
      2. the narrow f32 spatial step (TF32 off) from SPATIAL_START, and on
         rank 0 the port's unsharded step from the same weights and draws:
         loss rtol 2e-5, every parameter after the update atol 5e-5, the
         gradients (Adam's first moments) within 1e-4 of the largest and
         their norm within 1e-4 relative (PERF.md §2's gradient bound);
      3. celeba256_spatial at full width through train(): SPATIAL_BATCH per
         data shard, SPATIAL_STEPS steps on the synthetic dataset at 256 px;
         its logged img/s, peak memory, launches and collectives; then one
         step timed whole, and one under torch.profiler, whose spans
         ``spatial.halo`` and ``spatial.reduce`` give the device ms of the
         collectives (``tracing``; nothing synchronises around them)."""
    import torch.distributed as dist

    from partseg_tpu_torch.dist import make_spatial_mesh
    from partseg_tpu_torch.parallel.spatial_train import make_spatial_train_step
    from partseg_tpu_torch.train.loop import train

    dev, rank, world = _child_init("gloo")
    out = {"rank": rank, "device": str(dev)}
    x = torch.full((4,), rank + 1.5, dtype=torch.bfloat16, device=dev)
    dist.all_reduce(x)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x * (rank + 1))
    out["bf16_collectives"] = [x.tolist(), [p.tolist() for p in parts]]
    check(x.tolist() == [4.0] * 4 and [p[0].item() for p in parts] == [4.0, 8.0],
          f"gloo bf16 collectives on CUDA: {out['bf16_collectives']}")

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = _narrow_spatial_config()
    mesh = make_spatial_mesh(2)
    model = init_weights(PartNet(cfg.model, device="cpu"), seed=SEED).to(dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    perceptual = build_perceptual(cfg, dev)
    sampler = cfg.augment.make_sampler()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    images = torch.rand((2, 64, 64, 3), generator=gen, device=dev)
    aug = np.arange(2)
    draws = keyed_pair_draws(cfg.seed + 1, SPATIAL_START, aug, sampler, cfg.augment, dev)
    state = create_state(cfg, model, step=SPATIAL_START)
    step = make_spatial_train_step(cfg, model, sampler, perceptual, mesh)
    rows = images[:, 32 * mesh.space_index:32 * (mesh.space_index + 1)].contiguous()
    state, metrics = step(state, {"image": rows, "aug_id": aug}, draws=draws)
    if rank == 0:
        ref = PartNet(cfg.model, device=dev)
        ref.load_state_dict(start)
        ref_state, want = make_train_step(cfg, ref, sampler, perceptual)(
            create_state(cfg, ref, step=SPATIAL_START), {"image": images}, draws=draws)
        mu_scale = max(v.abs().max().item() for v in ref_state.opt_state.mu.values())
        err = {
            "loss_rel": abs(metrics["loss"].item() / want["loss"].item() - 1),
            "grad_norm_rel": abs(metrics["grad_norm"].item() / want["grad_norm"].item() - 1),
            "param_max_abs": max((v - ref_state.model.state_dict()[k]).abs().max().item()
                                 for k, v in state.model.state_dict().items()),
            "mu_err_of_max": max((state.opt_state.mu[k] - v).abs().max().item()
                                 for k, v in ref_state.opt_state.mu.items()) / mu_scale}
        out["parity"] = err
        check(err["loss_rel"] <= 2e-5 and err["param_max_abs"] <= 5e-5
              and err["mu_err_of_max"] <= 1e-4 and err["grad_norm_rel"] <= 1e-4,
              f"spatial step against the unsharded step on the card: {err}")
        del ref, ref_state
    del model, state, perceptual
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    dist.barrier()

    run = str(out_dir / "spatial_run")
    cfg = train_config("celeba256_spatial", [
        f"global_batch={SPATIAL_BATCH}", "dataset='synthetic'",
        "dataset_kwargs=(('size',256),('n_examples',64))", f"steps={SPATIAL_STEPS}",
        "log_every=1", "image_log_every=0", "ckpt_every=1000", f"ckpt_dir={run!r}"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tracing.reset()
    t0 = time.perf_counter()
    with recording("spatial"):
        state = train(cfg, device=dev)
    torch.cuda.synchronize()
    out["loop_wall_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["collectives_per_step"] = {k: tracing.counter(f"spatial.{k}") / SPATIAL_STEPS
                                   for k in ("halo", "reduce")}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if rank == 0:
        log = _log_records(run)
        out["logged"] = {rec["step"]: {"loss": rec["loss"],
                                       "img_per_sec_per_chip": rec["img_per_sec_per_chip"]}
                         for rec in log}
        check([rec["step"] for rec in log] == list(range(SPATIAL_STEPS))
              and all(math.isfinite(rec["loss"]) for rec in log),
              f"celeba256_spatial logged {log}")
    check(out["launches"]["tps_warp"] == SPATIAL_STEPS,
          f"celeba256_spatial launches {out['launches']} over {SPATIAL_STEPS} steps")

    # One more step, timed whole, then one traced: the spans of the collectives.
    mesh = make_spatial_mesh(2)
    perceptual = build_perceptual(cfg, dev)
    sampler = cfg.augment.make_sampler()
    step = make_spatial_train_step(cfg, state.model, sampler, perceptual, mesh)
    h = cfg.model.img_size // 2
    rows = torch.rand((SPATIAL_BATCH, h, cfg.model.img_size, 3), generator=gen, device=dev)
    batch = {"image": rows, "aug_id": np.arange(SPATIAL_BATCH)}
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch, cfg.seed + 1)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    tracing.reset()
    dist.barrier()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, cfg.seed + 1)
        torch.cuda.synchronize()
        out["traced_step_ms"] = (time.perf_counter() - t0) * 1e3
    spans = tracing.snapshot()["spans"]
    out["halo_ms_per_step"] = spans["spatial.halo"]["device_ms"]
    out["reduce_ms_per_step"] = spans["spatial.reduce"]["device_ms"]
    out["collectives_traced_step"] = {k: tracing.counter(f"spatial.{k}")
                                      for k in ("halo", "reduce")}
    check(out["collectives_traced_step"] == {k: spans[f"spatial.{k}"]["calls"]
                                             for k in ("halo", "reduce")},
          f"spatial collectives {out['collectives_traced_step']} against their spans {spans}")
    check(all(math.isfinite(v.item()) for v in metrics.values()),
          f"celeba256_spatial step metrics not finite on rank {rank}")
    if rank == 0:
        out["path_kernels"] = _check_path_inputs_f32()
    (out_dir / f"spatial_rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def phase_spatial(smi: str) -> dict:
    """Spatial sharding on the card: child_spatial on 2 ranks sharing cuda:0
    (gloo). Returns rank 0's launches over the celeba256_spatial loop."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        r = _torchrun([str(ROOT / "chip_smoke.py"), "--child", "spatial", "--out", tmp],
                      timeout=420)
        check(r.returncode == 0, f"spatial child exited {r.returncode}: {r.stdout[-2000:]} "
                                 f"{r.stderr[-4000:]}")
        ranks = [json.loads(Path(tmp, f"spatial_rank{i}.json").read_text()) for i in range(2)]
    emit("spatial", config="celeba256_spatial", batch_per_data_shard=SPATIAL_BATCH,
         ranks="1 data x 2 space on cuda:0 (gloo)", steps=SPATIAL_STEPS, card=smi,
         wall_s=time.perf_counter() - t0, parity=ranks[0]["parity"],
         bf16_collectives=ranks[0]["bf16_collectives"],
         logged=ranks[0]["logged"], peak_bytes=[x["peak_bytes"] for x in ranks],
         step_ms=[x["step_ms"] for x in ranks],
         halo_ms_per_step=[x["halo_ms_per_step"] for x in ranks],
         reduce_ms_per_step=[x["reduce_ms_per_step"] for x in ranks],
         traced_step_ms=[x["traced_step_ms"] for x in ranks],
         collectives_per_step=ranks[0]["collectives_per_step"],
         launches=[x["launches"] for x in ranks], path_kernels=ranks[0]["path_kernels"],
         loop_wall_s=[x["loop_wall_s"] for x in ranks])
    return ranks[0]["launches"]


SWEEP_TILES = (64, 128, 256)
SWEEP_BLOCKS = (1, 2, 4, 8, 16, 32, 64)


def forward_tile_sweep(case, mu, lam, app, res, gauss, lib, smi) -> None:
    """This checkout's 16-part forward at each tile (pixels) and blocks per
    image (each block walks ceil(tiles / blocks) tiles), device ms per call:
    the sweep that chose forward_plan16 in csrc/render_assemble.cu."""
    b, k, c = app.shape
    dev = app.device
    out = torch.empty((b, res, res, c), device=dev)
    rows = {}
    for tile in SWEEP_TILES:
        tiles = -(-res * res // tile)
        for blocks in sorted({min(x, tiles) for x in SWEEP_BLOCKS}):
            rows[f"{tile}x{blocks}"] = device_ms(lambda tile=tile, blocks=blocks: _build.launch(
                "partseg_render_assemble_tiled", dev, mu.data_ptr(), lam.data_ptr(),
                app.data_ptr(), int(app.dtype == torch.bfloat16), out.data_ptr(), b, k, c, res,
                res, gauss, tile, blocks, lib=lib))
    best = min(rows, key=rows.get)
    emit("tile_sweep", case=case, batch=b, k=k, device_ms_by_tile_x_blocks=rows, fastest=best,
         bound_ms=bound_ms(*render_assemble_bound(b, k, c, res))[0], nvidia_smi=smi)


def phase_turns(cfg, baseline: Path, smi: str) -> None:
    """The baseline checkout's kernels against this checkout's: each C
    entry point of both libraries called on the same inputs (outputs and
    scratch allocated once), device time per call in the order baseline,
    this, this, baseline, beside the bound. render_assemble's backward
    kernel is called with each checkout's own tile rule; a baseline
    without that kernel is timed as the plain closed form
    (render_assemble_vjp), which the wrapper ran on the card before. It is
    timed per training decode and per scale (speed128, B = 128), per scale
    of the celeba serving decoder (B = 256), and at ``wide_decode_cases``
    (K > 12 or C > 128, B = 64), where this checkout's kernel is also
    timed at each tile (a ``tile_sweep`` line). At K <= 12 and C <= 128 its
    outputs must equal the baseline's bit for bit. The forward is timed per
    decode (serving, training) and at each ``wide_decode_cases`` scale and
    K = 16 decode, its outputs the baseline's bit for bit everywhere, with a
    tile sweep of the 16-part tile at each K = 16 scale; tps_warp at the
    training warp, unbanded and banded, its outputs the baseline's bit for
    bit. F.grid_sample is timed beside bilinear_sample."""
    old = _build.library(baseline / "partseg_tpu_torch" / "csrc")
    new = _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    launch = _build.launch

    def turns(case: str, make, bound=None, outs=None, **extra) -> None:
        """``outs``: each library's outputs, by id, which its calls rewrite:
        with both trees' there, whether they hold the same bits."""
        a, b = make(old), make(new)
        ms = [device_ms(a), device_ms(b), device_ms(b), device_ms(a)]
        if bound is not None:
            extra["bound_ms"], extra["bound_by"] = bound_ms(*bound)
        if outs is not None and len(outs) == 2:
            torch.cuda.synchronize()
            extra["bit_for_bit"] = all(torch.equal(x, y)
                                       for x, y in zip(outs[id(old)], outs[id(new)]))
        emit("turns", case=case, baseline_device_ms=[ms[0], ms[3]], device_ms=[ms[1], ms[2]],
             nvidia_smi=smi, **extra)
        return extra.get("bit_for_bit")

    def softmax_call(logits):
        b, h, w, k = logits.shape
        parts = torch.empty((b, h, w, k), device=dev)
        raw = torch.empty((b, k, 5), device=dev)
        return lambda lib: lambda: launch(
            "partseg_softmax_moments_f32", dev, logits.data_ptr(), parts.data_ptr(),
            raw.data_ptr(), b, h, w, k, logits.stride(2), lib=lib)

    def render_call(mu, lam, scales, gauss, outs=None):
        """Each library's forward entry point over ``scales`` [(res, app)],
        outputs allocated once per library; ``outs`` gets them by id."""
        def make(lib):
            res_outs = [torch.empty((mu.shape[0], res, res, app.shape[-1]), device=dev)
                        for res, app in scales]
            if outs is not None:
                outs[id(lib)] = res_outs

            def run():
                for (res, app), out in zip(scales, res_outs):
                    b, k, c = app.shape
                    launch("partseg_render_assemble", dev, mu.data_ptr(), lam.data_ptr(),
                           app.data_ptr(), int(app.dtype == torch.bfloat16), out.data_ptr(),
                           b, k, c, res, res, gauss, lib=lib)
            return run
        return make

    def forward_turns(case, mu_, lam_, scales, gauss):
        """Turns of the forward over ``scales``; its outputs must equal the
        baseline's bit for bit (the parts are summed in order from 0 in
        every register tile)."""
        outs = {}
        bound = tuple(sum(v) for v in zip(*(render_assemble_bound(app.shape[0], app.shape[1],
                                                                  app.shape[2], res)
                                            for res, app in scales)))
        same = turns(case, render_call(mu_, lam_, scales, gauss, outs), bound, outs,
                     k=scales[0][1].shape[1], batch=scales[0][1].shape[0])
        check(same, f"{case}: differs from the baseline's kernel")

    k, size = cfg.n_parts, cfg.map_size
    turns("softmax_moments serving", softmax_call(serving_logits(gen, k, size)),
          softmax_moments_bound(BATCH, size, size, k))
    tlogits, tmu, tlam, tscales = train_render_inputs(gen, app_dtype=torch.bfloat16)
    tm = tlogits.shape[1]
    turns("softmax_moments training", softmax_call(tlogits[..., :k]),
          softmax_moments_bound(TRAIN_BATCH, tm, tm, k))

    _, mu, sigma = softmax_moments_plain(serving_logits(gen, k, size))
    cases = render_cases(cfg, mu.contiguous(), sigma, gen)
    gauss = int(cfg.render_kernel == "gauss")
    sscales = [(res, app) for *_, app, res in cases]
    forward_turns("render_assemble serving decode", cases[0][1], cases[0][2], sscales, gauss)
    tkind = train_config("speed128").model.render_kernel
    forward_turns("render_assemble training decode", tmu, tlam, tscales, int(tkind == "gauss"))

    rules = {id(old): _backward_rule(baseline), id(new): _backward_rule(ROOT)}

    def backward_call(mu_, lam_, kind, scales, grads, outs=None, tile=None):
        """Each library's backward entry point over ``scales`` [(res, app)]
        with its own tile rule (or ``tile``), outputs and scratch allocated
        once; ``outs`` gets each library's outputs by id."""
        def make(lib):
            if not hasattr(lib, "partseg_render_assemble_bwd"):
                return lambda: [render_assemble_vjp(mu_, lam_, app, res, res, kind, g)
                                for (res, app), g in zip(scales, grads)]
            tile_rule, rows_rule = rules[id(lib)]
            calls = []
            for (res, app), g in zip(scales, grads):
                b, kk, c = app.shape
                hw = res * res
                t = tile or tile_rule(kk, c, hw)
                rows = rows_rule(kk, c, hw, b, t) if rows_rule else -(-hw // t)
                part = torch.empty((b, max(rows, 1), kk, c + 5), device=dev)
                res_outs = (torch.empty((b, kk, c), device=dev, dtype=app.dtype),
                            torch.empty((b, kk, 2), device=dev),
                            torch.empty((b, kk, 2, 2), device=dev))
                calls.append((app, g, part, res_outs, b, kk, c, res, t))
            if outs is not None:
                outs[id(lib)] = [x for call in calls for x in call[3]]

            def run():
                for app, g, part, (d_app, d_mu, d_lam), b, kk, c, res, t in calls:
                    launch("partseg_render_assemble_bwd", dev, mu_.data_ptr(), lam_.data_ptr(),
                           app.data_ptr(), g.data_ptr(), int(app.dtype == torch.bfloat16),
                           part.data_ptr(), d_app.data_ptr(), d_mu.data_ptr(), d_lam.data_ptr(),
                           b, kk, c, res, res, int(kind == "gauss"), t, lib=lib)
            return run
        return make

    def backward_bound(scales):
        return tuple(sum(v) for v in zip(*(render_backward_bound(app.shape[0], app.shape[1],
                                                                 app.shape[-1], res)
                                           for res, app in scales)))

    def backward_turns(label, mu_, lam_, kind, scales, grads):
        """Turns over one decode's ``scales`` and then each scale; at K <= 12
        and C <= 128 the outputs must equal the baseline's bit for bit."""
        if len(scales) > 1:
            turns(f"render_assemble backward {label} decode",
                  backward_call(mu_, lam_, kind, scales, grads), backward_bound(scales))
        for scale, g in zip(scales, grads):
            res, app = scale
            narrow = app.shape[1] <= NARROW_PARTS and app.shape[2] <= CHUNK_CHANNELS
            outs = {}
            same = turns(f"render_assemble backward {label} {res}x{app.shape[-1]}",
                         backward_call(mu_, lam_, kind, [scale], [g], outs), backward_bound([scale]),
                         outs, k=app.shape[1], batch=app.shape[0])
            check(same is not False or not narrow,
                  f"render_assemble backward {label} {res}x{app.shape[-1]}: differs from the "
                  "baseline's kernel at K <= 12, C <= 128")

    cots = [torch.randn((TRAIN_BATCH, res, res, app.shape[-1]), generator=gen, device="cuda")
            for res, app in tscales]
    backward_turns("training", tmu, tlam, tkind, tscales, cots)
    scots = [torch.randn((BATCH, res, res, app.shape[-1]), generator=gen, device="cuda")
             for res, app in sscales]
    backward_turns("serving", cases[0][1], cases[0][2], cfg.render_kernel, sscales, scots)
    del scots
    wide = wide_decode_cases(gen)
    decodes = {}
    for label, k_, mu_, lam_, app, res, g, kind in wide:
        decodes.setdefault(label, (mu_, lam_, int(kind == "gauss"), []))[3].append((res, app))
        forward_turns(f"render_assemble forward {label} {res}x{app.shape[-1]}", mu_, lam_,
                      [(res, app)], int(kind == "gauss"))
        if k_ > NARROW_PARTS:
            forward_tile_sweep(f"render_assemble forward {label} {res}x{app.shape[-1]}", mu_,
                               lam_, app, res, int(kind == "gauss"), new, smi)
    for label, (mu_, lam_, gk, scales) in decodes.items():
        if len(scales) > 1:
            forward_turns(f"render_assemble forward {label} decode", mu_, lam_, scales, gk)
    for label, _, mu_, lam_, app, res, g, kind in wide:
        backward_turns(label, mu_, lam_, kind, [(res, app)], [g])
        runs = {t: backward_call(mu_, lam_, kind, [(res, app)], [g], tile=t)(new)
                for t in (64, 128, 256)}
        emit("tile_sweep", case=f"render_assemble backward {label} {res}x{app.shape[-1]}",
             rule_tile=backward_tile(app.shape[1], app.shape[2], res * res),
             device_ms_by_tile={t: device_ms(run) for t, run in runs.items()},
             event_ms_by_tile={t: event_ms(run, inner=KERNEL_INNER) for t, run in runs.items()},
             nvidia_smi=smi)

    img, weights, basis, coords = warp_inputs(gen, torch.bfloat16)
    nw, s = img.shape[0], img.shape[1]
    m = weights.shape[1]
    tps = tps_warp_bound(nw, s, s, 3, m, 2)
    prior = os.environ.get("PARTSEG_WARP_BAND")
    for kh in (0, 56, 40):
        _with_band(kh)
        band, tile = band_config(img.dtype, s, s)
        check(band == kh, f"tps_warp band {band}, expected {kh}")
        outs = {id(lib): [torch.empty_like(img)] for lib in (old, new)}
        same = turns(f"tps_warp training{f' band kh={kh}' if kh else ''}",
                     lambda lib, band=band, tile=tile: lambda: launch(
                         "partseg_tps_warp", dev, img.data_ptr(), 1, weights.data_ptr(),
                         basis.data_ptr(), outs[id(lib)][0].data_ptr(), nw, s, s, 3, m, tile,
                         band, lib=lib), tps, outs)
        check(same, f"tps_warp training kh={kh}: differs from the baseline's kernel")
    _with_band(0)
    if prior is not None:
        os.environ["PARTSEG_WARP_BAND"] = prior
    pair = tps_library_pair(img, weights, basis)
    pair_bound, pair_by = bound_ms(*tps)
    emit("turns", case="tps_warp training (library pair)", library_pair=TPS_LIBRARY_PAIR,
         device_ms=[device_ms(pair), device_ms(pair)], bound_ms=pair_bound, bound_by=pair_by,
         nvidia_smi=smi)
    n = coords.shape[1]
    out = torch.empty((nw, n, 3), device=dev, dtype=img.dtype)
    outs = [torch.empty((nw, n, 3), device=dev) for _ in range(3)]
    grid = coords.flip(-1)[:, None].to(img.dtype).contiguous()
    nchw = img.permute(0, 3, 1, 2)

    def grid_sample():
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    library = [device_ms(grid_sample)]
    turns("bilinear_sample training", lambda lib: lambda: launch(
        "partseg_bilinear_sample", dev, img.data_ptr(), 1, coords.data_ptr(), out.data_ptr(),
        None, None, nw, s, s, 3, n, 0, lib=lib), bilinear_bound(nw, n, 3, 2, s * s))
    turns("bilinear_sample grads variant training", lambda lib: lambda: launch(
        "partseg_bilinear_sample", dev, img.data_ptr(), 1, coords.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr(), nw, s, s, 3, n, 1, lib=lib),
        bilinear_bound(nw, n, 3, 2, s * s, grads=True))
    library.append(device_ms(grid_sample))
    emit("turns", case="F.grid_sample training (library)", device_ms=library, nvidia_smi=smi)


EVAL_EXAMPLES = 600           # 2 batches of 256 and a remainder of 88
TAIL_TOL = 2 ** -8            # μ of padded remainder rows against an unpadded forward (bf16)
VALIDATE_STEPS = 600          # validate_synthetic's default


def _split_loader(ds, batch):
    """The eval protocols' loader: the whole split once, in order, the
    remainder batch included."""
    return make_loader(ds, batch, shuffle=False, num_epochs=1, drop_remainder=False,
                       num_workers=4)


def phase_evals(cfg, served: dict, smi: str) -> dict:
    """The landmark and segmentation protocols (evals/landmarks.py,
    evals/segmentation.py) with the celeba model of phase serving (full
    width, bf16) on a synthetic split of 600 examples (128 px, 10 blobs,
    with masks) at B = 256, remainder batch included:
      - collect_mu scores all 600 and launches softmax_moments once per
        batch (3); its padded remainder rows give the μ of an unpadded
        forward of those rows within one bf16 ulp below 1 (2⁻⁸: the two
        batch sizes may take other cuDNN algorithms);
      - a second collect_mu pass, every example rendered already, gives
        the protocol's img/s (host batch assembly included);
      - evaluate_segmentation scores all 600 (its forward is the shape
        encoder and the per-pixel part softmax: no hand kernel);
      - the card at f32 against the CPU on the split's last 24 examples
        (a batch of 16 and a remainder of 8 padded to 16): μ within 1e-4
        of its scale, phase parity's tolerance."""
    model = served["model"]
    ds = SyntheticBlobs(size=cfg.img_size, n_blobs=10, n_examples=EVAL_EXAMPLES, with_masks=True)
    batches = -(-EVAL_EXAMPLES // BATCH)
    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    mu, gt = collect_mu(model, _split_loader(ds, BATCH))
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    check(mu.shape == (EVAL_EXAMPLES, cfg.n_parts, 2) and gt.shape == (EVAL_EXAMPLES, 10, 2),
          f"collect_mu shapes {mu.shape}, {gt.shape}")
    check(bool(np.isfinite(mu).all()) and np.abs(mu).max() <= 1.0, "collect_mu: μ not finite in [-1, 1]")
    check(launches["softmax_moments"] == batches,
          f"collect_mu launched softmax_moments {launches['softmax_moments']} times, "
          f"expected one per batch ({batches})")
    t0 = time.perf_counter()
    collect_mu(model, _split_loader(ds, BATCH))
    second_s = time.perf_counter() - t0

    tail0 = (batches - 1) * BATCH
    tail = torch.from_numpy(np.stack([ds[i]["image"] for i in range(tail0, EVAL_EXAMPLES)]))
    with torch.inference_mode():
        _, mu_tail, _ = model.shape_stats(model.encode_shape(tail.cuda()))
    tail_err = float(np.abs(mu[tail0:] - mu_tail.cpu().numpy()).max())
    check(tail_err <= TAIL_TOL, f"padded remainder μ differs from an unpadded forward: {tail_err}")

    seen = []

    def counted(it):
        for b in it:
            seen.append(len(b["image"]))
            yield b

    tracing.reset()
    seg = evaluate_segmentation(model, counted(_split_loader(ds, BATCH)), n_classes=11)
    seg_launches = launch_counts()
    check(sum(seen) == EVAL_EXAMPLES and len(seen) == batches,
          f"evaluate_segmentation saw batches {seen}")
    check(all(0.0 <= seg[k] <= 1.0 for k in ("miou", "fg_iou")), f"segmentation metrics {seg}")

    f32 = model_config("celeba", use_pallas=True, dtype=torch.float32)
    cpu = init_weights(PartNet(f32, device="cpu"), seed=SEED).eval()
    gpu = PartNet(f32)
    gpu.load_state_dict(cpu.state_dict())
    gpu.eval()
    part = [ds[i] for i in range(EVAL_EXAMPLES - 24, EVAL_EXAMPLES)]
    slices = [{k: np.stack([e[k] for e in part[a:b]]) for k in ("image", "landmarks")}
              for a, b in ((0, 16), (16, 24))]
    want, _ = collect_mu(cpu, iter(slices))
    got, _ = collect_mu(gpu, iter(slices))
    f32_err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    check(f32_err <= 1e-4 * max(scale, 1.0), f"collect_mu card vs CPU at f32: {f32_err}")
    emit("evals", examples=EVAL_EXAMPLES, batch=BATCH, dtype=str(cfg.dtype),
         batches_seen=seen, launches_collect_mu=launches,
         launches_evaluate_segmentation=seg_launches,
         remainder_mu_max_abs_vs_unpadded=tail_err, remainder_tolerance=TAIL_TOL,
         f32_card_vs_cpu_mu_max_abs=f32_err, f32_mu_scale=scale,
         collect_mu_first_pass_s=first_s, collect_mu_s=second_s,
         collect_mu_img_per_s=EVAL_EXAMPLES / second_s, segmentation=seg, nvidia_smi=smi)
    return launches


EXPORT_TOL = 1e-5             # exported vs eager outputs, relative to max(scale, 1)


def phase_export(cfg, served: dict, smi: str) -> dict:
    """The celeba infer forward (bf16, full width) exported on the card
    with a symbolic batch (evals/export.py): the graph holds
    partseg::softmax_moments once, no einsum, and no softmax but the
    per-pixel part softmax over the channels; saved with torch.export.save
    and loaded, it serves B = 256 and B = 37, launching the kernel once per
    request, and agrees with eager make_infer_fn: both run the same ops and
    kernel, so outputs within 1e-5 of their scale (f32 rounding of
    identical ops) and seg identical. A static-batch export refuses B = 37.
    Infer img/s of the loaded program against eager, in turns."""
    model, x = served["model"], served["x_s"]
    x37 = x[:37].contiguous()
    t0 = time.perf_counter()
    program = export_infer(model, cfg.img_size)
    export_s = time.perf_counter() - t0
    calls = [node for node in program.graph.nodes if node.op == "call_function"]
    names = [str(node.target) for node in calls]
    softmaxes = [node for node in calls
                 if "softmax" in str(node.target) and "partseg" not in str(node.target)]
    check(names.count("partseg.softmax_moments.default") == 1,
          f"exported graph holds partseg.softmax_moments {names.count('partseg.softmax_moments.default')} times")
    check(not any("einsum" in name for name in names), "exported graph holds an einsum")
    check(len(softmaxes) == 1 and softmaxes[0].args[1] in (-1, 3),
          f"exported graph softmaxes {[(str(n.target), n.args[1:]) for n in softmaxes]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "infer.pt2")
        torch.export.save(program, path)
        size = os.path.getsize(path)
        loaded = load_exported(path).module()

    @torch.inference_mode()
    def serve(images):
        return loaded(images)

    eager = make_infer_fn(model)
    errs = {}
    launches = dict.fromkeys(launch_counts(), 0)
    for b, xb in ((BATCH, x), (37, x37)):
        torch.cuda.synchronize()
        tracing.reset()
        got = serve(xb)
        torch.cuda.synchronize()
        check(launch_counts()["softmax_moments"] == 1,
              f"exported program at B = {b} launched softmax_moments "
              f"{launch_counts()['softmax_moments']} times")
        launches = {k: v + launch_counts()[k] for k, v in launches.items()}
        want = eager(xb)
        errs[b] = {}
        for k in want:
            check(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype,
                  f"exported {k} at B = {b}: {tuple(got[k].shape)} {got[k].dtype}")
            if k == "seg":
                check(torch.equal(got[k], want[k]), f"exported seg at B = {b} differs from eager")
                continue
            err = max_err(got[k], want[k])
            errs[b][k] = err
            check(err <= EXPORT_TOL * max(want[k].abs().max().item(), 1.0),
                  f"exported {k} at B = {b}: {err} from eager")
    static = export_infer(model, cfg.img_size, batch=BATCH).module()
    try:
        static(x37)
        refused = None
    except Exception as e:   # the guard's error type differs between torch versions
        refused = type(e).__name__
    check(refused is not None, "a static B = 256 export accepted B = 37")
    ms = [event_ms(lambda: eager(x), warmup=2), event_ms(lambda: serve(x), warmup=2),
          event_ms(lambda: serve(x), warmup=2), event_ms(lambda: eager(x), warmup=2)]
    emit("export", batch=BATCH, dtype=str(cfg.dtype), export_s=export_s, program_bytes=size,
         graph_calls=len(calls), max_abs_vs_eager=errs, tolerance=EXPORT_TOL,
         static_batch_refuses_37=refused,
         turns_ms={"eager": [ms[0], ms[3]], "exported": [ms[1], ms[2]]},
         eager_img_per_s=[BATCH / t * 1e3 for t in (ms[0], ms[3])],
         exported_img_per_s=[BATCH / t * 1e3 for t in (ms[1], ms[2])], launches=launches,
         nvidia_smi=smi)
    return launches


def phase_golden(smi: str) -> dict:
    """The port at bf16 on the card against tests/golden/golden.npz, the
    JAX package's bf16 outputs, on the weights and draws JAX made
    (tests/golden/torch_golden_inputs.npz): the f32 pair within 2e-4 and
    each model output within twice the reference's own bf16 rounding
    error (tests/_torch_golden.py)."""
    golden = _load_module(ROOT / "tests" / "_torch_golden.py")

    tracing.reset()
    result = golden.check("cuda")
    launches = launch_counts()
    emit("golden", outputs=result, launches=launches, nvidia_smi=smi)
    for k, r in result.items():
        check(r["max_abs_err"] <= r["bound"], f"golden {k}: {r['max_abs_err']} > {r['bound']}")
    want = {"softmax_moments": 2, "render_assemble": 3, "tps_warp": 1, "bilinear_sample": 0,
            "render_assemble_backward": 0}
    check(launches == want, f"golden launches {launches}, expected {want}")
    return launches


def phase_validate(run_dir: str, smi: str) -> dict:
    """partseg_tpu_torch.tools.validate_synthetic: the synthetic preset at
    its full width (64 px, K = 5, features 64, depth 3, VGG to relu3_2,
    B = 32) trains VALIDATE_STEPS steps through the loop on the card, then
    the landmark protocol scores it against a random model; then
    validate_segmentation on its checkpoint. Fails when the reference's
    rule fails: equivariance loss halved, trained error under 0.6× the
    random model's."""
    from partseg_tpu_torch.tools import validate_segmentation, validate_synthetic

    torch.cuda.synchronize()
    tracing.reset()
    t0 = time.perf_counter()
    result = validate_synthetic.main(VALIDATE_STEPS, run_dir, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    t0 = time.perf_counter()
    seg = validate_segmentation.main(run_dir, device="cuda")
    seg_wall = time.perf_counter() - t0
    emit("validate", config="synthetic", steps=VALIDATE_STEPS, result=result, segmentation=seg,
         wall_s=wall, segmentation_wall_s=seg_wall, launches=launches, nvidia_smi=smi)
    check(result["ok"], f"validate_synthetic failed the reference's rule: {result}")
    check(all(launches[k] > 0 for k in ("tps_warp", "softmax_moments", "render_assemble",
                                        "render_assemble_backward")),
          f"validate launches {launches}")
    return launches


@contextlib.contextmanager
def _captured():
    """Capture standard output into the yielded list's one string."""
    buf, out = io.StringIO(), []
    with contextlib.redirect_stdout(buf):
        yield out
    out.append(buf.getvalue())


def phase_cli(run_dir: str, smi: str) -> dict:
    """The user's path on validate's checkpoint (the synthetic preset):
    the infer and transfer CLIs on PNGs where cv2 imports, else their
    compute paths on arrays (load_model_and_params, infer_image and
    render_overlay; transfer at the full decode size); the eval CLI with
    --dump (4 batches of 64 of each split); the export CLI with --verify.
    The CLIs run in this process on the card."""
    infer_cli = importlib.import_module("partseg_tpu_torch.evals.infer")
    transfer_cli = importlib.import_module("partseg_tpu_torch.evals.transfer")
    eval_cli = importlib.import_module("partseg_tpu_torch.evals.cli")
    export_cli = importlib.import_module("partseg_tpu_torch.evals.export")
    from partseg_tpu_torch.train.config import load_config

    try:
        import cv2
    except ImportError:
        cv2 = None
    common = ["--config", "synthetic", "--ckpt_dir", run_dir]
    restored = f"[infer] restored step {VALIDATE_STEPS}"
    tracing.reset()
    rng = np.random.default_rng(SEED)
    imgs = [rng.uniform(0, 1, (64, 64, 3)).astype(np.float32) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        if cv2 is not None:
            pngs = [os.path.join(tmp, f"in{i}.png") for i in range(2)]
            for p, img in zip(pngs, imgs):
                cv2.imwrite(p, (img * 255).astype(np.uint8))
            viz, swap = os.path.join(tmp, "viz.png"), os.path.join(tmp, "t.png")
            with _captured() as log:
                infer_cli.main(common + ["--image", pngs[0], "--out", viz])
                transfer_cli.main(common + ["--shape", pngs[0], "--appearance", pngs[1],
                                            "--out", swap])
            check(log[0].count(restored) == 2 and cv2.imread(viz).shape == (64, 64, 3)
                  and cv2.imread(swap).shape == (64, 64, 3), f"infer/transfer CLIs: {log[0][-2000:]}")
            ran = ["infer.main", "transfer.main"]
        else:
            print("cv2: absent", flush=True)
            cfg = load_config("synthetic")
            with _captured() as log:
                res = infer_image(load_model_and_params(cfg, run_dir), imgs[0])
                viz = render_overlay(imgs[0], res)
                swap = transfer(load_model_and_params(full_size_decoder(cfg), run_dir), *imgs)
            check(log[0].count(restored) == 2 and viz.shape == (64, 64, 3)
                  and swap.shape == (64, 64, 3) and np.isfinite(swap).all()
                  and np.isfinite(res["landmarks"]).all(), f"infer/transfer paths: {log[0]}")
            ran = ["load_model_and_params", "infer_image", "render_overlay", "transfer"]
        dump = os.path.join(tmp, "mu.npz")
        with _captured() as log:
            eval_cli.main(common + ["--batch", "64", "--max_batches", "4", "--dump", dump])
        metrics = json.loads(log[0].strip().splitlines()[-1])
        with np.load(dump) as data:
            dumped = data["mu"].shape
        check(metrics["n_train"] == metrics["n_test"] == 256.0 and dumped == (256, 5, 2)
              and math.isfinite(metrics["landmark_error_pct_iod"]), f"eval CLI: {log[0][-2000:]}")
        with _captured() as log:
            export_cli.main(common + ["--out", os.path.join(tmp, "infer.pt2"), "--verify"])
        check("[export] verify OK" in log[0], f"export CLI: {log[0][-2000:]}")
        ran += ["evals.cli.main --dump", "evals.export.main --verify"]
    launches = launch_counts()
    check(launches["softmax_moments"] > 0 and launches["render_assemble"] > 0,
          f"cli launches {launches}")
    emit("cli", cv2="absent" if cv2 is None else "present", ran=ran, eval_metrics=metrics,
         launches=launches, nvidia_smi=smi)
    return launches


# ------------------------------------------------------------------ the tools

STUDY_VARIANTS = ("flagship", "speed128_r5_wf25d32")
STUDY_SMOKE_STEPS = 40          # the reduced study's flagship budget
STUDY_TIMEOUT_S = 600
FEED_IMAGES = 2000
INFER_TOL = 1e-4                # bench_infer's exported vs eager outputs (abs; seg exact)
WARP_F32_TOL = 1e-4             # phase kernels_warp's f32 tolerance


def study_config(name: str):
    """The quality study's 128 px config of variant ``name``."""
    return train_config("synthetic", PX128_BASE + VARIANTS_128[name])


@contextlib.contextmanager
def _env(**values):
    """Set environment variables while the block runs."""
    prior = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_trace(smi: str) -> dict:
    """tools.trace_step on speed128 at B = 128 (the preset at full width):
    one warm-up period, then two under torch.profiler; its breakdown per
    optimizer step (categories, top kernels, idle share). The hand
    kernels' categories must be in it, and the categories must sum to the
    total."""
    torch.cuda.synchronize()
    tracing.reset()
    with _env(TRACE_BATCH=str(TRAIN_BATCH), TRACE_CONFIG="speed128", TRACE_SET=""), \
            _captured() as log:
        result = trace_step.main()
    launches = launch_counts()
    cats = result["by_category_ms_per_step"]
    emit("trace", config="speed128", batch=TRAIN_BATCH, sub_steps=result["sub_steps"],
         device_ms_per_step=result["device_ms_per_step"],
         wall_ms_per_step=result["wall_ms_per_step"], idle_share=result["idle_share"],
         kernel_launches_per_step=result["kernel_launches_per_step"],
         by_category_ms_per_step=cats, top_kernels=result["top_kernels"][:12],
         top_host_ops=result["top_host_ops"][:8], printed_lines=len(log[0].splitlines()),
         launches=launches, nvidia_smi=smi)
    check(abs(sum(cats.values()) - result["device_ms_per_step"])
          <= 1e-9 * result["device_ms_per_step"], f"trace categories {cats}")
    check(all(cats.get(k, 0) > 0 for k in ("tps_warp", "softmax_moments", "render_assemble",
                                           "conv_matmul")), f"trace categories {cats}")
    check(0 <= result["idle_share"] < 1, f"trace idle share {result['idle_share']}")
    return launches


def phase_components(smi: str) -> dict:
    """tools.profile_components at its flagship 128 px config, B = 64:
    each row's ms by CUDA events."""
    from partseg_tpu_torch.tools import profile_components

    torch.cuda.synchronize()
    tracing.reset()
    with _captured():
        rows = profile_components.main()
    launches = launch_counts()
    emit("components", batch=profile_components.B, img_size=profile_components.S,
         rows=[{k: r[k] for k in ("name", "ms", "img_per_s")} for r in rows],
         launches=launches, nvidia_smi=smi)
    check(len(rows) == 12 and all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows),
          f"components rows {rows}")
    check(launches["tps_warp"] > 0 and launches["bilinear_sample"] > 0
          and launches["render_assemble"] > 0 and launches["softmax_moments"] == 0,
          f"components launches {launches}")
    return launches


def phase_bench_infer(smi: str) -> dict:
    """tools.bench_infer on the celeba config at B = 256: eager and
    exported img/s, and the exported program's outputs against eager's
    (seg equal, the others within INFER_TOL)."""
    from partseg_tpu_torch.tools import bench_infer

    torch.cuda.synchronize()
    tracing.reset()
    with _captured():
        result = bench_infer.main(["--config", "celeba", "--batch", str(BATCH)])
    launches = launch_counts()
    errs = result["exported"]["max_abs_vs_eager"]
    emit("bench_infer", config="celeba", batch=BATCH,
         eager_img_per_s=result["eager"]["value"], exported_img_per_s=result["exported"]["value"],
         max_abs_vs_eager=errs, tolerance=INFER_TOL, launches=launches, nvidia_smi=smi)
    check(errs["seg"] == 0.0 and all(v <= INFER_TOL for v in errs.values()),
          f"bench_infer exported vs eager {errs}")
    check(launches["softmax_moments"] > 0, f"bench_infer launches {launches}")
    return launches


def phase_probe_warp(smi: str) -> dict:
    """tools.probe_warp_parity: the tps_warp kernel and the explicit-flow
    bilinear_sample kernel against the plain gather warp on a smooth
    4 × 128² image; the interior error of both within kernels_warp's f32
    tolerance."""
    from partseg_tpu_torch.tools import probe_warp_parity

    torch.cuda.synchronize()
    tracing.reset()
    with _captured():
        result = probe_warp_parity.main()
    launches = launch_counts()
    emit("probe_warp", tps_warp=result["tps_warp"], bilinear_sample=result["bilinear_sample"],
         tolerance=WARP_F32_TOL, launches=launches, nvidia_smi=smi)
    check(result["tps_warp"]["interior_max"] <= WARP_F32_TOL
          and result["bilinear_sample"]["interior_max"] <= WARP_F32_TOL,
          f"probe_warp interior errors {result}")
    check(launches["tps_warp"] == 1 and launches["bilinear_sample"] == 1,
          f"probe_warp launches {launches}")
    return launches


def _cuda_libraries(pid: int) -> set:
    """The CUDA driver and torch libraries mapped into process ``pid``."""
    try:
        maps = Path(f"/proc/{pid}/maps").read_text()
    except OSError:            # the process has ended
        return set()
    return {lib for lib in ("libcuda.so", "libtorch") if lib in maps}


def phase_quality(smi: str) -> dict:
    """The quality study. First, in this process and recorded for
    path_kernels, one period of each of STUDY_VARIANTS at the study's
    128 px config and B = 64 (the flagship decode's 16²×256 scale is the
    render_assemble backward's one case of two channel chunks here, one
    cluster of two CTAs per image, a chunk each). Then the reduced study
    through its CLI, as users run it: both variants, flagship budget
    STUDY_SMOKE_STEPS, rates measured on this card by bench children in
    turns. result.json must hold both rows with measured rates (three
    rounds each), finite metrics and this card's nvidia-smi line; the
    verdict is printed, not gated (40 steps decide nothing). While it
    runs, the study's parent must never map the CUDA driver or torch
    (/proc/<pid>/maps): it holds no context. nvidia-smi's compute
    processes cannot show this in a container, where every process may
    read as one pid."""
    t0 = time.perf_counter()
    periods, plans = {}, {}
    for name in STUDY_VARIANTS:
        cfg = study_config(name)
        state, period, batches, _ = build_trainer(cfg, STUDY_BATCH, seed=SEED)
        torch.cuda.synchronize()
        tracing.reset()
        state, metrics = period(state, batches, cfg.seed)
        torch.cuda.synchronize()
        m = cfg.model
        plans[name] = [backward_plan(m.n_parts, f, (m.decoder_out_size or m.img_size)
                                     // 2 ** (m.decoder_scales - 1 - i), STUDY_BATCH)
                       for i, f in enumerate(m.decoder_features[:m.decoder_scales])]
        periods[name] = {**launch_counts(), "loss": metrics["loss"].item()}
        check(math.isfinite(periods[name]["loss"]), f"quality {name}: loss not finite")
        del state, period, batches
    flag, fast = periods["flagship"], periods["speed128_r5_wf25d32"]
    check(flag["render_assemble_backward"] == 4 and flag["softmax_moments"] == 2
          and flag["tps_warp"] == 1, f"quality flagship period launches {flag}")
    check(fast["tps_warp"] == 1, f"quality speed128_r5_wf25d32 period launches {fast}")
    chunked = [(pl["scale"], pl["tile"], pl["rows"]) for pl in plans["flagship"]
               if pl["chunks"] > 1]
    check(chunked == [("16x256", 256, 0)]
          and all(pl["groups"] == 1 for pl in plans["flagship"] + plans["speed128_r5_wf25d32"])
          and all(pl["chunks"] == 1 for pl in plans["speed128_r5_wf25d32"]),
          f"quality backward plans {plans}")
    in_process_s = time.perf_counter() - t0

    torch.cuda.empty_cache()
    parent_libs, polls = set(), 0
    with tempfile.TemporaryDirectory() as base, \
            open(os.path.join(base, "study.log"), "w+") as log:
        t1 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "partseg_tpu_torch.tools.quality_study",
             "--variants", ",".join(STUDY_VARIANTS), "--base_steps", str(STUDY_SMOKE_STEPS),
             "--base_dir", os.path.join(base, "study")],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                check(time.perf_counter() - t1 < STUDY_TIMEOUT_S,
                      f"the quality study ran over {STUDY_TIMEOUT_S} s")
                parent_libs |= _cuda_libraries(proc.pid)
                polls += 1
                time.sleep(2.0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        study_s = time.perf_counter() - t1
        log.seek(0)
        tail = log.read()[-3000:]
        check(proc.returncode in (0, 1), f"quality study exit {proc.returncode}: {tail}")
        result = json.loads(Path(base, "study", "result.json").read_text())
    rows = result["rows"]
    emit("quality", in_process_periods=periods, backward_plans=plans, in_process_s=in_process_s,
         study_s=study_s, study_exit=proc.returncode, base_steps=result["base_steps"],
         card=result["card"],
         rates={n: {k: r.get(k) for k in ("img_s_chip", "img_s_chip_runs", "rate_source",
                                          "steps", "steps_at_rate_extremes")}
                for n, r in rows.items()},
         metrics={n: {k: r[k] for k in ("landmark_err_pct_diag", "equiv_last", "miou", "fg_iou",
                                        "learned")} for n, r in rows.items()},
         verdict=result["pass_at_equal_wallclock"],
         fastest_passing_variant=result["fastest_passing_variant"],
         study_wall_s={**result["wall_s"], **{n: r["wall_s"] for n, r in rows.items()}},
         polls=polls, study_parent_pid=proc.pid,
         study_parent_cuda_libraries=sorted(parent_libs), nvidia_smi=smi)
    check(set(rows) == set(STUDY_VARIANTS) and result["card"] == smi,
          f"quality result.json rows {sorted(rows)}, card {result['card']!r}")
    for name, r in rows.items():
        check(r["rate_source"] == "measured" and len(r["img_s_chip_runs"]) == 3
              and all(math.isfinite(v) and v > 0 for v in r["img_s_chip_runs"])
              and r["img_s_chip"] == statistics.median(r["img_s_chip_runs"]),
              f"quality {name}: rates {r}")
        check(all(math.isfinite(r[k]) for k in ("landmark_err_pct_diag", "equiv_last", "miou",
                                                "fg_iou")), f"quality {name}: metrics {r}")
    check(rows["flagship"]["steps"] == STUDY_SMOKE_STEPS, f"quality flagship steps {rows}")
    check(not parent_libs, f"the study's parent mapped {sorted(parent_libs)}")
    check(proc.returncode == (0 if result["gate_pass"] else 1),
          f"quality study exit {proc.returncode} against gate_pass {result['gate_pass']}")
    return {k: flag[k] + fast[k] for k in launch_counts()}


def phase_feed(smi: str, demand: float) -> dict:
    """tools.feed_bench over FEED_IMAGES JPEGs at 178×218, with the demand
    set to speed128's train img/s of phase timing_train: the thread-pool
    backend must run; the native pool runs where partseg_native/build.sh
    builds on this host, and its line says why where it does not."""
    from partseg_tpu_torch.tools import feed_bench

    tracing.reset()
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--dir", tmp, "--n_images", str(FEED_IMAGES), "--src_wh", "178x218",
                "--batches", "50", "--warmup", "5", "--demand", str(demand)]
        with _captured() as log:
            (pool,) = feed_bench.main(args + ["--backends", "grain"])
        with _captured() as log:
            try:
                feed_bench.main(args + ["--backends", "native"])
            except SystemExit:
                pass
        native = json.loads(log[0].strip().splitlines()[-1])
    launches = launch_counts()
    emit("feed", demand_img_per_s=demand, thread_pool=pool, native=native, launches=launches,
         nvidia_smi=smi)
    check("error" not in pool and pool["img_per_s"] > 0, f"feed thread pool {pool}")
    check(native["backend"] == "native" and ("error" in native or native["img_per_s"] > 0),
          f"feed native {native}")
    check(not any(launches.values()), f"feed launched kernels {launches}: it is host-only")
    return launches


# --------------------------------------------- kernels at the paths' shapes

PATH_INPUTS: dict = {}   # (kernel, signature) → (path, grad enabled, inputs): first calls


def _record(kernel: str, path: str, signature: tuple, inputs) -> None:
    key = (kernel, *signature)
    if key not in PATH_INPUTS:
        grad = torch.is_grad_enabled()
        with torch.inference_mode(False), torch.no_grad():
            PATH_INPUTS[key] = (path, grad, inputs())


@contextlib.contextmanager
def recording(path: str):
    """While ``path`` runs, keep the inputs of the first kernel call of
    each new signature (shape, strides, dtype, options), as the path's own
    callers make them: softmax_moments from PartNet.shape_stats (the
    strided foreground slice), render_assemble from the decoder, tps_warp
    from TPSSampler.warp. An export's trace (fake tensors) and calls on
    the CPU are not kept.
    The calls go on to the wrappers unchanged, and phase path_kernels
    holds each kernel to its plain version on what was kept."""
    import partseg_tpu_torch.models.decoder as decoder_mod
    import partseg_tpu_torch.models.partnet as partnet_mod

    sm, ra, warp = partnet_mod.softmax_moments, decoder_mod.render_assemble, TPSSampler.warp

    def real(*xs):
        return not torch.compiler.is_compiling() and all(
            type(x) is torch.Tensor and x.is_cuda for x in xs)

    def softmax_moments_rec(logits):
        if real(logits):
            _record("softmax_moments", path, (tuple(logits.shape), logits.stride()),
                    lambda: [_strided_copy(logits)])
        return sm(logits)

    def render_assemble_rec(mu, lam, app, h, w, kernel="gauss"):
        if real(mu, lam, app):
            _record("render_assemble", path, (tuple(app.shape), app.dtype, h, w, kernel),
                    lambda: [mu.clone(), lam.clone(), app.clone(), h, w, kernel])
        return ra(mu, lam, app, h, w, kernel)

    def warp_rec(self, params, image, padding_mode="border"):
        if padding_mode == "border" and real(image, params.weights):
            _, h, w, _ = image.shape
            _record("tps_warp", path, (tuple(image.shape), image.dtype,
                                       tuple(params.weights.shape)),
                    lambda: [image.clone(), params.weights.contiguous().clone(),
                             self.flow_basis(h, w, image.device).clone()])
        return warp(self, params, image, padding_mode)

    partnet_mod.softmax_moments, decoder_mod.render_assemble = softmax_moments_rec, render_assemble_rec
    TPSSampler.warp = warp_rec
    try:
        yield
    finally:
        partnet_mod.softmax_moments, decoder_mod.render_assemble, TPSSampler.warp = sm, ra, warp


def phase_path_kernels() -> dict:
    """Each kernel against its plain version on the inputs that the evals,
    export, golden, validate, cli and quality paths gave it (``recording``):
    the CelebA model's remainder batch, the golden model's K = 4, the
    synthetic preset's K = 5 foreground slice of 6 logits, its 3-scale
    decoder and its 64² warp head, and the quality study's two 128 px
    variants at B = 64 (the flagship's 16²×256 decoder scale is the
    render_assemble backward's case of two channel chunks), and train_k16's
    K = 16 deepfashion period at B = 64 (every decoder scale a group of 16
    parts). Tolerances are phase kernels',
    kernels_warp's and backward's: softmax_moments parts rtol 1e-5, μ and
    Σ atol 1e-5; render_assemble 1e-5 of the largest output; tps_warp f32
    1e-4, bf16 2⁻⁸ + 1e-4. Where the path took gradients (validate's
    training): softmax_moments' gradient against autograd through the
    plain version, 1e-4 of each cotangent's largest, and render_assemble's
    backward kernel against its closed form, 1e-5 of each cotangent's
    largest (a bf16 d_app within one bf16 ulp, rtol 2⁻⁷). Repeats give the
    same bits."""
    report, errs = check_path_inputs()
    seen = {(r["kernel"], r["path"]) for r in report}
    every = ("softmax_moments", "render_assemble", "tps_warp")
    for path, kernels in (("validate", every), ("golden", every), ("evals", ("softmax_moments",)),
                          ("train_k16", every), ("quality", every)):
        check(all((k, path) in seen for k in kernels),
              f"path_kernels: {path} left no inputs of {kernels}: {sorted(seen)}")
    wide = [r for r in report if r["kernel"] == "render_assemble" and r["grad"]
            and (r["app"][1] > NARROW_PARTS or r["app"][2] > CHUNK_CHANNELS)]
    check(any(r["path"] == "quality" and r["app"] == [STUDY_BATCH, 10, 256] and r["res"] == 16
              for r in wide),
          f"path_kernels: no two-chunk backward case at quality's 16²×256: {wide}")
    k16 = {r["res"] for r in wide if r["path"] == "train_k16" and r["app"][:2] == [K16_BATCH, 16]}
    check(k16 == {16, 32, 64, 128}, f"path_kernels: train_k16's backward scales {sorted(k16)}")
    check(any(r["kernel"] == "softmax_moments" and r["path"] == "train_k16" and r["grad"]
              and r["shape"][-1] == 16 for r in report),
          "path_kernels: no K = 16 softmax_moments gradient from train_k16")
    emit("path_kernels", cases=report, tolerances=PATH_TOLERANCES)
    return errs


PATH_TOLERANCES = {
    "softmax_moments": "parts rtol 1e-5; mu, sigma atol 1e-5; gradient 1e-4 of max",
    "render_assemble": "atol 1e-5 * max|plain output|; backward kernel vs closed form "
                       "1e-5 of max, bf16 d_app rtol 2^-7",
    "tps_warp": "f32 1e-4; bf16 2^-8 + 1e-4 against the f32 plain version cast once"}


def check_path_inputs() -> tuple[list, dict]:
    """phase path_kernels' checks on every input ``recording`` kept in this
    process; returns (one row per case, each kernel's largest f32 error)."""
    report = []
    errs = {"softmax_moments": 0.0, "render_assemble": 0.0, "tps_warp": 0.0}
    for i, ((kernel, *sig), (path, grad, inputs)) in enumerate(PATH_INPUTS.items()):
        row = {"kernel": kernel, "path": path, "grad": grad}
        if kernel == "softmax_moments":
            (x,) = inputs
            got, again, want = softmax_moments(x), softmax_moments(x), softmax_moments_plain(x)
            e = [max_err(a, b) for a, b in zip(got, want)]
            row.update(shape=list(x.shape), ld=x.stride(2), parts_mu_sigma_max_abs=e)
            check(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-30)
                  and max(e[1:]) <= 1e-5, f"softmax_moments at {path}'s {list(x.shape)} "
                                          f"(ld {x.stride(2)}): {e}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"softmax_moments repeat differs at {path}'s {list(x.shape)}")
            errs[kernel] = max(errs[kernel], *e)
            if grad:
                g = [_scaled_err(a, b) for a, b in zip(_grads(softmax_moments, [x], SEED + i),
                                                       _grads(softmax_moments_plain, [x],
                                                              SEED + i))]
                row["grad_scaled_err"] = g
                check(all(math.isfinite(v) and v <= 1e-4 for v in g),
                      f"softmax_moments gradient at {path}'s {list(x.shape)}: {g}")
        elif kernel == "render_assemble":
            mu, lam, app, h, w, kind = inputs
            out, ref = render_assemble(mu, lam, app, h, w, kind), render_assemble_plain(
                mu, lam, app, h, w, kind)
            e, scale = max_err(out, ref), ref.abs().max().item()
            row.update(app=list(app.shape), dtype=str(app.dtype), res=h, render_kernel=kind,
                       max_abs=e, max_abs_out=scale)
            check(bool(torch.isfinite(out).all()) and e <= 1e-5 * scale,
                  f"render_assemble at {path}'s {list(app.shape)} {h}²: {e} > 1e-5·{scale}")
            errs[kernel] = max(errs[kernel], e)
            if grad:
                gen = torch.Generator(device=app.device).manual_seed(SEED + i)
                g = torch.randn((app.shape[0], h, w, app.shape[-1]), generator=gen,
                                device=app.device)
                got = render_assemble_backward(mu, lam, app, h, w, kind, g)
                again = render_assemble_backward(mu, lam, app, h, w, kind, g)
                want = render_assemble_vjp(mu, lam, app, h, w, kind, g)
                ge = [_scaled_err(a, b) for a, b in zip(got, want)]
                row["backward_scaled_err"] = ge
                d_scale = want[2].float().abs().max().item()
                check(all(math.isfinite(v) for v in ge) and max(ge[:2]) <= 1e-5
                      and torch.allclose(got[2].float(), want[2].float(), atol=1e-5 * d_scale,
                                         rtol=0 if app.dtype == torch.float32 else 2 ** -7),
                      f"render_assemble backward kernel at {path}'s {list(app.shape)} {h}²: {ge}")
                check(got[2].dtype == app.dtype and all(torch.equal(a, b)
                                                        for a, b in zip(got, again)),
                      f"render_assemble backward kernel at {path}'s {h}²: dtype or repeat")
        else:
            im, weights, basis = inputs
            band, tile = band_config(im.dtype, im.shape[1], im.shape[2])
            got, again = tps_warp(im, weights, basis), tps_warp(im, weights, basis)
            want = tps_warp_plain(im.float(), weights, basis, band, tile).to(im.dtype)
            e = max_err(got, want)
            tol = 1e-4 if im.dtype == torch.float32 else 2 ** -8 + 1e-4
            row.update(shape=list(im.shape), dtype=str(im.dtype), m=weights.shape[1],
                       max_abs=e)
            check(got.dtype == im.dtype and e <= tol and torch.equal(got, again),
                  f"tps_warp at {path}'s {list(im.shape)} {im.dtype}: {e} > {tol} or repeat")
            if im.dtype == torch.float32:
                errs[kernel] = max(errs[kernel], e)
        report.append(row)
    return report, errs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another checkout of the repo: time its kernels against these")
    parser.add_argument("--child", choices=("dp", "spatial"), default=None,
                        help="run one rank of phase dp or spatial (torchrun starts them)")
    parser.add_argument("--backend", default="gloo", help="--child dp: gloo or nccl")
    parser.add_argument("--out", type=Path, default=None, help="--child: where ranks report")
    args = parser.parse_args()
    if args.child == "dp":
        child_dp(args.out, args.backend)
        return 0
    if args.child == "spatial":
        child_spatial(args.out)
        return 0
    smi = phase_device()
    phase_build()
    cfg = model_config("celeba", use_pallas=True)
    if args.baseline is not None:
        old = _build.library(args.baseline / "partseg_tpu_torch" / "csrc")
        phase_warp_kernels(old)
        phase_turns(cfg, args.baseline, smi)
        phase_tps_wide(smi, old)
        phase_wide_decodes(smi, old)
        with recording("train_k16"):
            phase_train_k16(smi, old)
        print(smi, flush=True)
        return 0
    errs = phase_kernels(cfg)
    errs.update(phase_warp_kernels())
    phase_backward(cfg)
    served = phase_serving(cfg)
    phase_parity(cfg)
    trained = phase_train()
    zeros_launches = phase_train_zeros()
    phase_train_parity()
    with recording("train_k16"):
        k16_launches = phase_train_k16(smi)
    phase_train_loop()
    paths = {"train_k16": k16_launches, "dp": phase_dp(smi), "spatial": phase_spatial(smi)}
    with recording("evals"):
        paths["evals"] = phase_evals(cfg, served, smi)
    with recording("export"):
        paths["export"] = phase_export(cfg, served, smi)
    with recording("golden"):
        paths["golden"] = phase_golden(smi)
    with tempfile.TemporaryDirectory() as run_dir:
        with recording("validate"):
            paths["validate"] = phase_validate(run_dir, smi)
        with recording("cli"):
            paths["cli"] = phase_cli(run_dir, smi)
    tools_s = {}             # the seconds of each phase that drives a tool

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        tools_s[name] = time.perf_counter() - t0
        return out

    paths["trace"] = timed("trace", phase_trace, smi)
    paths["components"] = timed("components", phase_components, smi)
    paths["bench_infer"] = timed("bench_infer", phase_bench_infer, smi)
    paths["probe_warp"] = timed("probe_warp", phase_probe_warp, smi)
    with recording("quality"):
        paths["quality"] = timed("quality", phase_quality, smi)
    for name, e in phase_path_kernels().items():
        errs[name] = max(errs[name], e)
    kernels, train_img_per_s = phase_timing(cfg, served, trained, zeros_launches, errs, smi)
    timed("timing_wide_decodes", phase_wide_decodes, smi)
    paths["feed"] = timed("feed", phase_feed, smi, train_img_per_s)
    emit("tools_seconds", phases=tools_s, total=sum(tools_s.values()))
    for row in kernels:
        row["launches_by_path"] = {path: counts[row["name"]] for path, counts in paths.items()}
    phase_tps_wide(smi)
    phase_profile(served, trained)
    emit("profiler", calls_without_device_time=len(PROFILER_FALLBACKS),
         fallbacks=PROFILER_FALLBACKS)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
