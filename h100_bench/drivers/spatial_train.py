"""Spatially sharded training on four cards: the program's spatial step from
``train.loop.build_step_fn`` on a ``make_spatial_mesh(space_shards)`` mesh,
2 data shards × 2 space ranks, over NCCL (gloo on the CPU), steps back to
back on batches drawn in turn from a pool of distinct global batches.

Rank 0 is the harness's own process. Its set-up starts ranks 1–3 as child
processes (this file as a script, one card each), and all four join one
process group through a store that rank 0 serves on a free local port, with
a finite timeout. A child exits when rank 0 does (it watches its standard
input, which rank 0 holds open), and rank 0 ends the run with an error when
a child exits with one. Each rank builds the same weights, model, VGG and
image pool from the seed and keeps its data shard's rows for its space index;
each checks after its set-up that it holds no forbidden module.

Set-up drives the step through ``check_steps`` steps on distinct batches,
reading the first forward on rank 0's rows (its landmarks are whole on every
rank) and the first gradient as the optimizer got it. From those steps' time
rank 0 fixes the window's step count and sends it, once, to the other ranks;
every rank then runs that many steps back to back, with nothing that
synchronises the host inside the window, and rank 0 synchronises at its end.
The rate counts the global images once. A traced run profiles rank 0 alone
over the same steps on every rank (a window the profiler delivered empty is
taken again on every rank). ``failed`` counts the steps whose loss is not
finite on some rank.

The check: the reference of the 2 × 2 step (``reference/sharded.py``), each
data shard's loss and gradient computed whole, on the rank of space index 0
of that shard, the gradients summed between those ranks over the mesh's
data group; compared with ``checks.train_gaps``.

The float8 control (``--variant control``): the program's spatial step with
each ResBlock's output rounded through float8_e4m3fn and its gradient passed
straight through (``models.blocks.f8_store``), as ``act_quant = "f8"`` does
on one card; the spatial forward refuses ``act_quant`` itself, so the
rounding is planted around its ResBlocks. Faults: ``frozen_state`` and
``half_batch`` (the step gets the first half of each data shard's rows and
ids; the first forward is read on those rows and compared with the
reference's same rows) as ``--variant``; ``no_halo`` (each rank's
convolutions see zero rows at its shard's inner edges instead of its
neighbour's rows), which exists only across ranks, is planted by the
traffic key ``"plant": "no_halo"`` (the tests set it; no mix does).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

if __name__ == "__main__":   # a child rank, run as a script
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench import checks, program, weights  # noqa: E402
from h100_bench.reference import sharded  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=600)
VARIANTS = ("program", "control", "frozen_state", "half_batch")


class State:
    pass


# ------------------------------------------------------------------ faults


@contextlib.contextmanager
def no_halo():
    """The program's row-shard convolutions with zero rows for their halos
    at every shard edge, as if each rank's rows were a whole image."""
    from partseg_tpu_torch.parallel import spatial_model

    def zero_rows(x, halo, group, dim=1):
        if halo <= 0:
            return x
        return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [halo, halo])

    with mock.patch.object(spatial_model, "halo_exchange", zero_rows):
        yield


@contextlib.contextmanager
def float8_control():
    """The program's spatial ResBlocks with their outputs rounded through
    float8_e4m3fn, the gradient straight through: the one-card control's
    ``act_quant = "f8"`` on the sharded forward."""
    from partseg_tpu_torch.models.blocks import f8_store
    from partseg_tpu_torch.parallel import spatial_model, spatial_train

    resblock = spatial_model._resblock

    def rounded(x, block, group):
        return f8_store(resblock(x, block, group))

    with mock.patch.object(spatial_model, "_resblock", rounded), \
            mock.patch.object(spatial_train, "_resblock", rounded):
        yield


# ------------------------------------------------------------------ ranks


def _device(device, rank: int) -> torch.device:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return torch.device("cpu")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_children(spec, seed: int, device, variant: str, world: int, port: int) -> list:
    env = dict(os.environ)
    if torch.device(device).type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    args = json.dumps({"cell": spec.cell, "config": spec.config, "traffic": spec.traffic})
    return [subprocess.Popen([sys.executable, __file__, args, str(r), str(port), str(seed),
                              str(device), variant], stdin=subprocess.PIPE, stdout=2, env=env,
                             cwd=str(Path(__file__).resolve().parents[2]))
            for r in range(1, world)]


def _watch(children: list, stop: threading.Event) -> None:
    """Rank 0's watch: a child that exits with an error ends the run (a rank
    left out of a collective would stall the others)."""
    while not stop.wait(0.5):
        for r, p in enumerate(children, 1):
            if p.poll() not in (None, 0):
                print(f"[spatial_train] rank {r} exited with {p.returncode}; ending the run",
                      file=sys.stderr, flush=True)
                os._exit(1)


def _orphan_guard() -> None:
    """A child's watch: rank 0 closing its end of standard input (it exited)
    ends this process."""
    def watch():
        while os.read(0, 4096):
            pass
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _build(st, spec, seed: int, variant: str, store) -> None:
    """Every rank's set-up: weights, model, VGG and pool from the seed, the
    process group, the mesh and the step; then the first steps."""
    from partseg_tpu_torch.dist.mesh import make_spatial_mesh
    from partseg_tpu_torch.parallel import spatial_train
    from partseg_tpu_torch.train import build_perceptual, create_state
    from partseg_tpu_torch.train.loop import build_step_fn
    from partseg_tpu_torch.train.state import trainable

    cfg, traffic, device = spec.config, spec.traffic, st.device
    tc = dataclasses.replace(program.train_config(cfg, "program"),
                             space_shards=int(cfg["space_shards"]))
    if tc.augment.warp_every != 1:
        raise ValueError("this driver checks one step per period (augment.warp_every = 1)")
    st.cfg, st.traffic, st.seed, st.variant = cfg, traffic, seed, variant
    st.batch, st.space = int(traffic["batch"]), tc.space_shards
    st.w_model = program.model_weights(cfg, seed, device)
    st.w_vgg = program.vgg_weights(cfg, seed, device)
    st.parts.stamp("weights")
    model = program.build_model(tc, st.w_model, device)
    st.parts.stamp("model")
    perceptual = build_perceptual(tc, device)
    weights.load(perceptual.vgg, st.w_vgg)
    st.parts.stamp("vgg")
    kw = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                            rank=st.rank, world_size=st.world, timeout=TIMEOUT, **kw)
    mesh = make_spatial_mesh(st.space)
    # The reference runs on the ranks of space index 0, one a data shard: their data group.
    st.ref_group = mesh.data_group
    st.data_index, st.space_index, st.n_data = mesh.data_index, mesh.space_index, mesh.n_data
    st.parts.stamp("process_group")
    st.pool = _rows(st, _global_pool(st, device))
    st.parts.stamp("pool")
    st.train_state = create_state(tc, model)
    st.step_fn = build_step_fn(tc, model, tc.augment.make_sampler(), perceptual, mesh)
    st.trainable = lambda: trainable(st.train_state.model)
    st.cursor = 0
    st.p0 = checks.clone(st.trainable())
    st.losses, st.first = [], {}

    forward = spatial_train.sharded_partnet_forward

    def read_first(*args):
        out = forward(*args)
        if st.rank == 0 and not st.first:
            st.first.update(recon=out["recon"].detach().clone(),
                            mu_a=out["mu_a"].detach().clone())
        return out

    times = []
    with mock.patch.object(spatial_train, "sharded_partnet_forward", read_first), _planted(st):
        for i in range(int(traffic["check_steps"])):
            metrics = _step(st)
            st.losses.append(metrics["loss"].detach().clone())
            _sync(device)
            times.append(time.perf_counter())
            if i == 0:
                st.g1 = {k: v / (1.0 - tc.optim.b1)
                         for k, v in checks.clone(st.train_state.opt_state.mu).items()}
                st.parts.stamp("step_1")
    st.p_end = checks.clone(st.trainable())
    st.step_s = (times[-1] - times[0]) / max(len(times) - 1, 1)
    st.parts.stamp("first_steps")


@contextlib.contextmanager
def _planted(st):
    """The control's rounding and the planted fault, where the run asks for them."""
    with contextlib.ExitStack() as stack:
        if st.variant == "control":
            stack.enter_context(float8_control())
        if st.traffic.get("plant") == "no_halo":
            stack.enter_context(no_halo())
        yield


def _global_pool(st, device) -> torch.Tensor:
    """[pool, batch, S, S, 3] f32 from the seed: uniform noise about 0.5, row i
    of each data shard at contrast lo + (hi − lo) · i / (rows − 1)."""
    size = st.cfg["model"]["img_size"]
    u = program.image_pool(int(st.traffic["pool"]), st.batch, size, st.seed, device)
    lo, hi = st.traffic.get("contrast", (1.0, 1.0))
    b = st.batch // st.n_data
    c = torch.linspace(lo, hi, b, device=device).repeat(st.n_data).view(1, st.batch, 1, 1, 1)
    return u.sub_(0.5).mul_(c).add_(0.5)


def _rows(st, pool: torch.Tensor) -> torch.Tensor:
    """This rank's rows of its data shard, [pool, batch / n_data, S / space, S, 3]."""
    b, h = st.batch // st.n_data, pool.shape[2] // st.space
    return pool[:, st.data_index * b:(st.data_index + 1) * b,
                st.space_index * h:(st.space_index + 1) * h].contiguous()


def _ids(st, slot: int) -> np.ndarray:
    return slot * st.batch + np.arange(st.batch)


def _step(st) -> dict:
    """One call of the program's step on this rank's rows of the pool's next batch."""
    slot = st.cursor % st.pool.shape[0]
    b = st.batch // st.n_data
    rows, ids = st.pool[slot], _ids(st, slot)[st.data_index * b:(st.data_index + 1) * b]
    if st.variant == "half_batch":
        rows, ids = rows[:b // 2], ids[:b // 2]
    if st.variant == "frozen_state":
        opt = st.train_state.opt_state
        saved = (checks.clone(st.trainable()), checks.clone(opt.mu), checks.clone(opt.nu), opt.count)
    st.train_state, metrics = st.step_fn(st.train_state, ({"image": rows, "aug_id": ids},),
                                         st.seed)
    if st.variant == "frozen_state":
        with torch.no_grad():
            for k, p in st.trainable().items():
                p.copy_(saved[0][k])
        opt.mu, opt.nu, opt.count = saved[1], saved[2], saved[3]
    st.cursor += 1
    return metrics


def _broadcast(st, values: list[int]) -> list[int]:
    t = torch.tensor(values, dtype=torch.int64, device=st.device)
    dist.broadcast(t, 0)
    return t.tolist()


def _run(st, n: int, traced_units: int) -> dict:
    """Every rank's window: ``n`` steps back to back, timed on rank 0, then
    ``traced_units`` steps profiled on rank 0."""
    from h100_bench.trace import Window, device_us

    losses = []
    _sync(st.device)
    t0 = time.perf_counter()
    with _planted(st):
        for _ in range(n):
            losses.append(_step(st)["loss"])
        _sync(st.device)
        elapsed = time.perf_counter() - t0
        out = {"attempted": n, "seconds": elapsed, "images": n * st.batch}
        if traced_units:
            registry = _registry()
            before = registry.counters() if registry else {}
            for _ in range(3):
                prof, wall = _profiled(st, lambda: losses.append(_step(st)["loss"]), traced_units)
                empty = st.rank == 0 and st.device.type == "cuda" and device_us(prof) == 0
                if not _broadcast(st, [int(empty)])[0]:
                    break
            if st.rank == 0:
                traced = Window.of(prof, wall, traced_units)
                if registry:
                    after = registry.counters()
                    traced.counters = {k: v - before.get(k, 0) for k, v in after.items()}
                out["traced"] = traced
            out["attempted"] = n + traced_units
    bad = (~torch.isfinite(torch.stack(losses).float())).float()
    dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    out["failed"] = int(bad.sum())
    out["end_to_end"] = {st.traffic["rate_metric"]: n * st.batch / elapsed}
    return out


def _registry():
    try:
        from partseg_tpu_torch import tracing
    except ImportError:   # a program without the span registry
        return None
    return tracing


def _profiled(st, fn, calls: int):
    """(prof or None, wall s): ``calls`` calls of ``fn``, under torch.profiler on
    rank 0 (trace.profile_window's activities, without its retry, which every
    rank must share)."""
    from torch.profiler import ProfilerActivity, profile

    if st.rank != 0:
        for _ in range(calls):
            fn()
        _sync(st.device)
        return None, 0.0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if st.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync(st.device)
        wall = time.perf_counter() - t0
    return prof, wall


def _dispatch(st, calls: int) -> list[float]:
    """ms the host takes to issue one step onto an idle card (rank 0's
    times; every rank runs the steps)."""
    out = []
    with _planted(st):
        for _ in range(calls):
            _sync(st.device)
            t0 = time.perf_counter()
            _step(st)
            out.append((time.perf_counter() - t0) * 1e3)
    _sync(st.device)
    return out


def _release(st) -> None:
    for name in ("train_state", "step_fn", "trainable", "pool"):
        delattr(st, name)
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(st) -> dict | None:
    """The reference of the check steps on the ranks of space index 0, each
    its own data shard; the result on rank 0 (None elsewhere)."""
    if st.space_index != 0:
        return None
    pool = _global_pool(st, st.device)
    steps = [(pool[i % pool.shape[0]], _ids(st, i % pool.shape[0]))
             for i in range(len(st.losses))]

    def reduce(tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=st.ref_group)
        return [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    with checks.no_tf32():
        want = sharded.reference_steps(st.cfg, st.w_model, st.w_vgg, steps, st.seed, st.device,
                                       st.n_data, shards=[st.data_index], reduce=reduce)
    return want if st.rank == 0 else None


def _leave() -> None:
    """Every rank leaves the process group together, once the reference is done."""
    dist.barrier()
    dist.destroy_process_group()


def _child(argv: list[str]) -> int:
    """Ranks 1..world−1: the harness's sequence of calls, as rank 0 makes them."""
    from h100_bench import run as bench

    _orphan_guard()
    spec_d, rank, port, seed, device, variant = argv
    spec = bench.Spec({}, **json.loads(spec_d), limits={})
    st = State()
    st.rank, st.world, st.parts = int(rank), int(spec.cell["chips"]), program.Parts()
    st.device = _device(device, st.rank)
    store = dist.TCPStore("127.0.0.1", int(port), st.world, False, timeout=TIMEOUT)
    _build(st, spec, int(seed), variant, store)
    bad = bench.forbidden_modules()
    if bad:
        raise ImportError(f"rank {st.rank} holds {bad} after set-up")
    n, traced_units, calls = _broadcast(st, [0, 0, 0])
    _run(st, n, traced_units)
    _dispatch(st, calls)
    _release(st)
    _reference(st)
    _leave()
    return 0


# ------------------------------------------------------------------ the harness's calls (rank 0)


def setup(spec, seed: int, device, variant: str) -> State:
    if variant not in VARIANTS:
        raise ValueError(f"the spatial step has no variant {variant!r} (it takes {VARIANTS})")
    st = State()
    st.rank, st.world, st.parts = 0, int(spec.cell["chips"]), program.Parts()
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < st.world:
        raise RuntimeError(f"{spec.cell['name']} needs {st.world} CUDA devices; "
                           f"torch sees {torch.cuda.device_count()}")
    st.device = _device(device, 0)
    store = dist.TCPStore("127.0.0.1", 0, st.world, True, timeout=TIMEOUT, wait_for_workers=False)
    st.children = _start_children(spec, seed, device, variant, st.world, store.port)
    st.stop = threading.Event()
    threading.Thread(target=_watch, args=(st.children, st.stop), daemon=True).start()
    st.parts.stamp("ranks_started")
    try:
        _build(st, spec, seed, variant, store)
    except BaseException:
        _end_children(st, kill=True)
        raise
    return st


def window(st, seconds: float, traced_units: int) -> dict:
    budget = max(seconds - float(st.traffic["trace_seconds"]), 1.0) if traced_units else seconds
    n = max(1, round(budget / st.step_s))
    calls = int(st.traffic["host_dispatch_calls"]) if traced_units else 0
    _broadcast(st, [n, traced_units, calls])
    return _run(st, n, traced_units)


def host_dispatch(st, calls: int) -> list[float]:
    return _dispatch(st, calls)


def release(st) -> None:
    _release(st)


def check(st) -> dict:
    want = _reference(st)
    _leave()
    _end_children(st)
    rows = st.first["mu_a"].shape[0] if st.first else 0
    h = st.first["recon"].shape[1] if st.first else 0
    want["first"] = {"recon": want["first"]["recon"][:rows, :h],
                     "mu_a": want["first"]["mu_a"][:rows]}
    prog = {"losses": [float(v) for v in st.losses], "g1": st.g1, "p0": st.p0,
            "p_end": st.p_end, "first": st.first}
    return checks.train_gaps(prog, want)


def _end_children(st, kill: bool = False, timeout: float = 120.0) -> None:
    st.stop.set()
    for p in st.children:
        if kill:
            p.kill()
        try:
            p.wait(timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.stdin:
            p.stdin.close()
    codes = [p.returncode for p in st.children]
    if not kill and any(codes):
        raise RuntimeError(f"a rank exited with an error: exit codes {codes}")


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]))
