"""Serving in a closed loop of one client: each request is a batch of images
from a pool of distinct device-resident batches, sent through the program's
entry point under ``torch.inference_mode()`` once the previous request's
outputs are synchronised.

``entry`` "infer" sends ``batch`` images to ``make_infer_fn``; "transfer"
sends ``batch`` shape images and ``batch`` appearance images (the pool's next
batch) to ``transfer_batch``. A request's latency runs from its dispatch to
its outputs' synchronisation, read from CUDA events recorded on the card
around it (a host clock is off by about half a millisecond at these lengths).
A sample of the window's requests, drawn from the seed, is checked once the
window has closed against the reference in float32.
"""

from __future__ import annotations

import math
import random
import time

import torch

from h100_bench import program
from h100_bench.reference import model as ref
from h100_bench import weights


class State:
    pass


def setup(spec, seed: int, device, variant: str) -> State:
    from partseg_tpu_torch.evals.export import make_infer_fn
    from partseg_tpu_torch.evals.transfer import transfer_batch

    cfg, traffic = spec.config, spec.traffic
    st = State()
    st.cfg, st.traffic, st.seed, st.device, st.variant = cfg, traffic, seed, device, variant
    st.entry, st.batch = traffic["entry"], int(traffic["batch"])
    tc = program.train_config(cfg, variant)
    st.parts = program.Parts()
    st.w_model = program.model_weights(cfg, seed, device)
    st.parts.stamp("weights")
    model = program.build_model(tc, st.w_model, device).eval()
    st.parts.stamp("model")
    st.pool = program.image_pool(int(traffic["pool"]), st.batch, cfg["model"]["img_size"], seed,
                                 device)
    if st.entry == "infer":
        infer = make_infer_fn(model)
        st.call = lambda i: infer(st.pool[i % len(st.pool)])
    elif st.entry == "transfer":
        st.call = lambda i: transfer_batch(model, *_transfer_inputs(st, i))
    else:
        raise ValueError(f"unknown serving entry {st.entry!r}")
    st.model = model
    st.sampler = random.Random(weights.stream(seed, 4))
    st.kept = []
    st.cursor = 0
    for i in range(int(traffic["warmup"])):
        _request(st)
        _sync(device)
        st.parts.stamp(f"request_{i + 1}")
    st.kept = []
    return st


def _transfer_inputs(st, i: int):
    n = len(st.pool)
    return st.pool[i % n], st.pool[(i + 1) % n]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _request(st):
    """Send request ``st.cursor``; return its outputs once synchronised."""
    with torch.inference_mode():
        out = st.call(st.cursor)
        if st.variant == "altered_answer":
            (out["landmarks"] if st.entry == "infer" else out)[0] += 0.5   # one answer
    st.cursor += 1
    return out


def _timed(st) -> float:
    """One request; its latency in ms; kept for the check by reservoir sampling."""
    if torch.device(st.device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = _request(st)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        out = _request(st)
        ms = (time.perf_counter() - t0) * 1e3
    st.seen += 1
    k = int(st.traffic["check_requests"])
    if len(st.kept) < k:
        st.kept.append((st.cursor - 1, out))
    else:
        j = st.sampler.randrange(st.seen)
        if j < k:
            st.kept[j] = (st.cursor - 1, out)
    return ms


def window(st, seconds: float, traced_units: int) -> dict:
    from h100_bench.trace import Window, profile_window

    st.seen = 0
    lat = []
    budget = max(seconds - float(st.traffic["trace_seconds"]), 1.0) if traced_units else seconds
    t0 = time.perf_counter()
    while not lat or time.perf_counter() - t0 < budget:
        lat.append(_timed(st))
    elapsed = time.perf_counter() - t0
    n = len(lat)
    out = {"attempted": n, "failed": 0, "seconds": elapsed, "images": n * st.batch}
    if traced_units:
        prof, wall = profile_window(lambda: _request(st), traced_units)
        out.update(traced=Window.of(prof, wall, traced_units), attempted=n + traced_units)
    tail = sorted(lat)[max(0, math.ceil(float(st.traffic["tail_quantile"]) * n) - 1)]
    out["end_to_end"] = {st.traffic["rate_metric"]: n * st.batch / elapsed,
                         st.traffic["tail_metric"]: tail}
    return out


def host_dispatch(st, calls: int) -> list[float]:
    """ms the host takes to issue one request onto an idle card."""
    out = []
    for _ in range(calls):
        _sync(st.device)
        t0 = time.perf_counter()
        _request(st)
        out.append((time.perf_counter() - t0) * 1e3)
    _sync(st.device)
    return out


def release(st) -> None:
    del st.model, st.call
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()


def _max_rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@torch.no_grad()
def check(st) -> dict:
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        net = ref.PartNet(st.cfg["model"]).to(st.device)
        weights.load(net, st.w_model)
        rows = int(st.traffic["check_rows"])
        gaps: dict[str, float] = {}

        def worst(name, value):
            gaps[name] = max(gaps.get(name, 0.0), value)

        for i, out in st.kept:
            for r in range(0, st.batch, rows):
                sl = slice(r, r + rows)
                if st.entry == "infer":
                    want = ref.infer(net, st.pool[i % len(st.pool)][sl])
                    worst("landmark_err", float((out["landmarks"][sl] - want["landmarks"]).abs().max()))
                    worst("heatmap_err", _max_rel(out["heatmaps"][sl], want["heatmaps"]))
                    worst("sigma_err", _max_rel(out["sigma"][sl], want["sigma"]))
                else:
                    xs, xa = _transfer_inputs(st, i)
                    want = ref.transfer(net, xs[sl], xa[sl])
                    diff = (out[sl].float() - want).abs()
                    worst("recon_rmse", float(diff.square().mean().sqrt()))
                    worst("recon_img_mae", float(diff.mean(dim=(1, 2, 3)).max()))
        return gaps
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
