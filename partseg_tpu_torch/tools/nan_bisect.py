"""Two-phase hunt for the first non-finite value of a training run, the
port's twin of tools/nan_bisect.py.

Phase card:  python -m partseg_tpu_torch.tools.nan_bisect card [--cpu]
    trains the synthetic preset (260 steps) with a checkpoint and a
    metrics line every 10 steps, on the card unless --cpu.
Phase cpu:   python -m partseg_tpu_torch.tools.nan_bisect cpu
    finds the first non-finite loss in metrics.jsonl, restores the
    checkpoint one window before it on the CPU, seeks the loader to that
    step and steps, with every module's output checked, until the fault
    raises FloatingPointError.

Both take ``--run DIR`` (default logs/nan_bisect) and ``--set KEY=VAL``
overrides of the preset (``steps=N`` included); give phase cpu the same
ones as phase card.

How it finds the fault, against JAX's ``jax_debug_nans`` (which raises at
the first primitive that yields a NaN, forward or backward): a forward
hook on every module of the model and of the perceptual loss raises at
the first module whose output holds a NaN or an inf, and names it
(``shape_enc.stem.conv``, say), so the forward's fault is located to the
innermost module that produced it, not to a single op inside it; ops
outside any module (the augmentation, the loss arithmetic) are caught
only by the check of the loss after the step. The backward runs under
``torch.autograd.detect_anomaly()``, which raises at the first backward
function that returns a NaN and prints the forward op that created it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib

import torch
from torch import nn

RUN = "logs/nan_bisect"
EVERY = 10          # checkpoint and metrics cadence of phase card


def _config(run: str, overrides=()):
    from partseg_tpu_torch.train.config import apply_overrides, load_config

    cfg = load_config("synthetic").replace(
        steps=260, ckpt_dir=run, ckpt_every=EVERY, ckpt_keep=40, log_every=EVERY,
        image_log_every=0,
    )
    return apply_overrides(cfg, overrides)


def phase_card(run: str = RUN, overrides=(), device=None) -> None:
    from partseg_tpu_torch.train.loop import train

    train(_config(run, overrides), restore=False, device=device)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


@contextlib.contextmanager
def nonfinite_hooks(modules: dict[str, nn.Module]):
    """While open, a forward hook on every submodule of ``modules``
    raises FloatingPointError at the first output holding a NaN or an
    inf, naming the module (``<prefix>.<its name>``)."""
    handles = []

    def hook_for(name):
        def hook(module, args, out):
            for t in _tensors(out):
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"non-finite output of module {name} ({type(module).__name__}), "
                        f"shape {tuple(t.shape)}")
        return hook

    try:
        for prefix, root in modules.items():
            for name, m in root.named_modules():
                full = f"{prefix}.{name}" if name else prefix
                handles.append(m.register_forward_hook(hook_for(full)))
        yield
    finally:
        for h in handles:
            h.remove()


def phase_cpu(run: str = RUN, overrides=()) -> None:
    from partseg_tpu_torch.data import build_dataset, make_loader
    from partseg_tpu_torch.models.partnet import PartNet, init_weights
    from partseg_tpu_torch.train.checkpoint import CheckpointManager
    from partseg_tpu_torch.train.loop import aug_ids, build_step_fn
    from partseg_tpu_torch.train.state import create_state
    from partseg_tpu_torch.train.step import build_perceptual

    cfg = _config(run, overrides)
    if cfg.augment.warp_every > 1 or cfg.data_echo > 1:
        raise SystemExit(
            "nan_bisect needs per-step granularity; rerun with "
            "augment.warp_every=1 and data_echo=1 (the sub-step graphs are "
            "identical, only the schedule differs)"
        )
    hist = [json.loads(line)
            for line in pathlib.Path(run, "metrics.jsonl").read_text().splitlines()]
    bad = next((h["step"] for h in hist if not math.isfinite(h["loss"])), None)
    if bad is None:
        raise SystemExit(f"{run}/metrics.jsonl logs no non-finite loss")
    start = max((bad // EVERY - 1) * EVERY, 0)      # one checkpoint before the bad window
    print(f"first NaN logged at step {bad}; restoring step {start}", flush=True)

    model = init_weights(PartNet(cfg.model, device="cpu"), seed=cfg.seed)
    state = create_state(cfg, model)
    if start > 0:            # step 0 is the seeded init, which has no checkpoint
        mgr = CheckpointManager(run, save_every=EVERY)
        state = mgr.restore(state, start)
        mgr.close()
    perceptual = build_perceptual(cfg, "cpu")
    step_fn = build_step_fn(cfg, model, cfg.augment.make_sampler(), perceptual)
    ds = build_dataset(cfg.dataset, split="train", **dict(cfg.dataset_kwargs))
    it = make_loader(ds, cfg.global_batch, seed=cfg.seed, num_workers=1,
                     backend=cfg.loader_backend, start_batch=start)
    seed = cfg.seed + 1                 # the loop's augmentation key
    with torch.autograd.detect_anomaly(), nonfinite_hooks({"model": model,
                                                           "perceptual": perceptual}):
        for step in range(start, bad + 12):
            hb = next(it)
            batch = {"image": torch.from_numpy(hb["image"]),
                     "aug_id": aug_ids(cfg.global_batch, 0, step, 0, cfg.global_batch)}
            try:
                state, metrics = step_fn(state, (batch,), seed)
                loss = metrics["loss"].item()
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} with every module output finite: the "
                        "fault is in an op outside the modules (augmentation, loss terms)")
            except RuntimeError as e:
                if "nan values" not in str(e):
                    raise
                print(f"\n=== NaN raised at step {step} (backward) ===\n{e}", flush=True)
                raise FloatingPointError(f"backward at step {step}: {e}") from e
            except FloatingPointError as e:
                print(f"\n=== NaN raised at step {step} ===\n{e}", flush=True)
                raise
            print(f"step {step}: loss {loss:.5f}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=("card", "cpu"))
    ap.add_argument("--run", default=RUN, help="the run directory")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                    help="overrides of the synthetic preset (the same for both phases)")
    ap.add_argument("--cpu", action="store_true", help="phase card: train on the CPU")
    a = ap.parse_args()
    if a.phase == "card":
        phase_card(a.run, getattr(a, "set"), device="cpu" if a.cpu else None)
    else:
        phase_cpu(a.run, getattr(a, "set"))
