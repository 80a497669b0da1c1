"""Training, back to back: the program's ``make_train_period`` called on
batches drawn in turn from a pool of distinct device-resident batches, the
state carried from step to step.

Set-up builds one trainer from the seed and drives it through its first
``check_steps`` steps through the window's own call, on distinct batches;
the window continues with that same object. The reference follows those
first steps in float32 from the same weights, images and keyed draws, and
the check compares the first step's forward (its reconstruction and
landmarks, read by a forward hook on the program's model), the first gradient
as the optimizer got it (Adam's first moment after step 1, ÷ (1 − b1)), the
parameters' change over the steps, leaf by leaf by their norms, and each
step's loss (``checks.train_gaps``).
"""

from __future__ import annotations

import dataclasses
import time
from unittest import mock

import numpy as np
import torch

from h100_bench import checks, program, weights


class State:
    pass


def setup(spec, seed: int, device, variant: str) -> State:
    from partseg_tpu_torch.train import build_perceptual, create_state, make_train_period
    from partseg_tpu_torch.train import step as program_step
    from partseg_tpu_torch.train.state import trainable

    cfg, traffic = spec.config, spec.traffic
    tc = program.train_config(cfg, variant)
    if tc.augment.warp_every != 1:
        raise ValueError("this driver checks one step per period (augment.warp_every = 1)")
    st = State()
    st.cfg, st.traffic, st.seed, st.device, st.variant = cfg, traffic, seed, device, variant
    st.batch = b = int(traffic["batch"])
    st.parts = program.Parts()
    st.w_model = program.model_weights(cfg, seed, device)
    st.w_vgg = program.vgg_weights(cfg, seed, device)
    st.parts.stamp("weights")
    model = program.build_model(tc, st.w_model, device)
    st.parts.stamp("model")
    perceptual = build_perceptual(tc, device)
    weights.load(perceptual.vgg, st.w_vgg)
    st.parts.stamp("vgg")
    st.pool = program.image_pool(int(traffic["pool"]), b, cfg["model"]["img_size"], seed, device,
                                 tuple(traffic.get("contrast", (1.0, 1.0))))
    st.train_state = create_state(tc, model)
    make_loss_fn = program_step.make_loss_fn
    if variant == "half_batch":
        make_loss_fn = _over_half_the_rows(make_loss_fn)
    with mock.patch.object(program_step, "make_loss_fn", make_loss_fn):
        st.period = make_train_period(tc, model, tc.augment.make_sampler(), perceptual)
    st.trainable = lambda: trainable(st.train_state.model)
    st.cursor = 0
    st.p0 = checks.clone(st.trainable())
    st.losses, st.first = [], {}
    hook = model.register_forward_hook(lambda mod, args, out: _read_first(st, out))
    for i in range(int(traffic["check_steps"])):
        metrics = _step(st)
        st.losses.append(metrics["loss"].detach().clone())
        if i == 0:
            hook.remove()
            st.g1 = {k: v / (1.0 - tc.optim.b1) for k, v in checks.clone(st.train_state.opt_state.mu).items()}
            _sync(device)
            st.parts.stamp("step_1")
    st.p_end = checks.clone(st.trainable())
    _sync(device)
    st.parts.stamp("first_steps")
    return st


def _read_first(st, out) -> None:
    """Keep the first forward's reconstruction and landmarks (a forward hook's
    body: it returns None, so the output goes on unchanged)."""
    if not st.first:
        st.first.update(recon=out.recon.detach().clone(), mu_a=out.mu_a.detach().clone())


def _over_half_the_rows(make_loss_fn):
    """The program's loss maker with a fault planted: the forward still runs
    on every row (the check reads it), but the loss and its gradient are the
    mean over the first half of the rows only."""

    def make(*args, **kwargs):
        inner = make_loss_fn(*args, **kwargs)

        def loss_fn(batch: dict, draws):
            with torch.no_grad():
                inner(batch, draws)
            half = batch["image"].shape[0] // 2
            return inner({k: v[:half] for k, v in batch.items()}, _rows(draws, half))

        return loss_fn

    return make


def _rows(tree, n: int):
    """The first ``n`` rows of every tensor in a tree of draws."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree[:n]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _rows(getattr(tree, f.name), n)
                                            for f in dataclasses.fields(tree)})
    return type(tree)(*(_rows(x, n) for x in tree))


def _ids(st, slot: int) -> np.ndarray:
    return slot * st.batch + np.arange(st.batch)


def _step(st) -> dict:
    """One call of the program's period on the pool's next batch."""
    slot = st.cursor % st.pool.shape[0]
    images, ids = st.pool[slot], _ids(st, slot)
    if st.variant == "frozen_state":
        opt = st.train_state.opt_state
        saved = (checks.clone(st.trainable()), checks.clone(opt.mu), checks.clone(opt.nu), opt.count)
    st.train_state, metrics = st.period(st.train_state, ({"image": images, "aug_id": ids},), st.seed)
    if st.variant == "frozen_state":
        with torch.no_grad():
            for k, p in st.trainable().items():
                p.copy_(saved[0][k])
        opt.mu, opt.nu, opt.count = saved[1], saved[2], saved[3]
    st.cursor += 1
    return metrics


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(st, seconds: float, traced_units: int) -> dict:
    from h100_bench.trace import Window, profile_window

    losses, steps = [], 0
    budget = max(seconds - float(st.traffic["trace_seconds"]), 1.0) if traced_units else seconds
    t0 = time.perf_counter()
    while steps == 0 or time.perf_counter() - t0 < budget:
        losses.append(_step(st)["loss"])
        steps += 1
    _sync(st.device)
    elapsed = time.perf_counter() - t0
    out = {"attempted": steps, "seconds": elapsed, "images": steps * st.batch}
    if traced_units:
        prof, wall = profile_window(lambda: losses.append(_step(st)["loss"]), traced_units)
        out.update(traced=Window.of(prof, wall, traced_units), attempted=steps + traced_units)
    out["failed"] = int((~torch.isfinite(torch.stack(losses))).sum())
    out["end_to_end"] = {st.traffic["rate_metric"]: steps * st.batch / elapsed}
    return out


def host_dispatch(st, calls: int) -> list[float]:
    """ms the host takes to issue one step onto an idle card."""
    out = []
    for _ in range(calls):
        _sync(st.device)
        t0 = time.perf_counter()
        _step(st)
        out.append((time.perf_counter() - t0) * 1e3)
    _sync(st.device)
    return out


def release(st) -> None:
    for name in ("train_state", "period", "trainable"):
        delattr(st, name)
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()


def check(st) -> dict:
    steps = [(st.pool[i % st.pool.shape[0]], _ids(st, i % st.pool.shape[0]))
             for i in range(len(st.losses))]
    want = checks.reference_steps(st.cfg, st.w_model, st.w_vgg, steps, st.seed, st.device)
    prog = {"losses": [float(v) for v in st.losses], "g1": st.g1, "p0": st.p0, "p_end": st.p_end,
            "first": st.first}
    return checks.train_gaps(prog, want)
