"""Quality-vs-speed study on the CUDA card, the port's twin of
tools/quality_study.py.

Two modes:

--px 64: flagship-class against the throughput128 deltas scaled to the
  64 px synthetic task, at EQUAL STEPS.

--px 128 (default): the bench recipes — the celeba preset's flagship
  model and loss against speed128's 48-channel trunk and its later rungs —
  on a 128 px / 10-part synthetic task at EQUAL WALL-CLOCK: variant v
  trains base_steps × rate_v / rate_flagship steps, where a rate is the
  variant's training img/s on this card at the study's global batch (64),
  so a recipe that steps 3× faster trains 3× more steps, what a fixed
  training-hour budget buys. A variant passes when it learned, its
  landmark error is at most 1.05× the flagship's and its mIoU at least
  0.95× the flagship's; the default recipe should be the fastest that
  passes (fastest_passing_variant).

Rates come from the card. Before any training, each selected variant
without ``--rate NAME=IMG_S`` is measured in a child process,
``python -m partseg_tpu_torch.bench --config synthetic --batch 64 --set
<PX128_BASE + its overrides>`` (bench's warm-up, then RATE_PERIODS timed
periods), RATE_ROUNDS rounds taken in turns across the variants. The
median is the variant's rate; its row keeps every round
(``img_s_chip_runs``), ``rate_source`` ("measured" or "--rate"), and the
budgets at the rounds' extremes (``steps_at_rate_extremes``).
``result.json`` records the card's name and power limit as nvidia-smi
prints them. On the CPU (--cpu) every rate must be given: a CPU rate is
not the card's.

One process per variant: the train CLI trains it in one child, with a
checkpoint every --ckpt_every steps (default 600, the JAX tool's segment
length, so --resume restores at its granularity; the JAX tool's
--segment_steps, which restarted the trainer to bound a leak of the TPU
transport, has no counterpart), then
validate_synthetic --eval_only and validate_segmentation evaluate the
checkpoint in two children of their own, side by side. Each row keeps
its training and evaluation seconds (``wall_s``), and result.json the
rates' and the whole study's. The parent imports no torch and never
touches the card.

    python -m partseg_tpu_torch.tools.quality_study [--px 128] [--base_steps 800]
        [--variants flagship,speed128] [--rate NAME=IMG_S ...] [--seeds 1]
        [--scan 1] [--ckpt_every 600] [--device_data] [--resume]
        [--anchor_json PRIOR/result.json] [--base_dir logs/quality_study] [--cpu]

Prints one JSON line and, in 128 px mode, writes <base_dir>/result.json;
the exit code is 1 when no variant passes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
STUDY_BATCH = 64          # PX128_BASE's global_batch: the rates are measured at it
SEGMENT_STEPS = 600       # the JAX tool's default segment length: the checkpoint cadence
RATE_ROUNDS = 3           # bench rounds per measured variant, taken in turns
RATE_PERIODS = 20         # timed bench periods per round

VARIANTS_64 = {
    # Flagship-class at 64px synthetic (the synthetic preset's defaults).
    "quality": [],
    # The throughput128 deltas, scaled to the 64px synthetic task:
    # depth 3→2, decoder 3→2 scales, VGG features at half res (32²)
    # with blocks ≤2 — mirroring throughput128 against celeba.
    "throughput": [
        "model.depth=2",
        "model.decoder_scales=2",
        "loss.vgg_resolution=32",
        "loss.vgg_trim_blocks=2",
        "loss.vgg_layers=('relu1_2','relu2_2')",
    ],
}

# 128px mode: identical data, optimizer and augmentation; ONLY the model
# and loss fields that differ between the celeba and speed128 presets
# (plus the later rungs) vary.
PX128_BASE = [
    "model.img_size=128",
    "model.n_parts=10",
    "dataset_kwargs=(('size',128),('n_blobs',10),('n_examples',2048))",
    "global_batch=64",
    "optim.decay_steps=20000",
]

FLAGSHIP_128 = [
    # The celeba preset = PartNetConfig + LossConfig defaults; the
    # synthetic base config is smaller, so reset every differing field.
    "model.features=128",
    "model.app_features=128",
    "model.depth=4",
    "model.decoder_scales=4",
    "model.decoder_features=(256,128,64,32)",
    "loss.vgg_layers=('relu1_2','relu2_2','relu3_2','relu4_2')",
    "loss.vgg_trim_blocks=4",
    "loss.vgg_resolution=None",
]

SPEED128 = [
    "model.features=48",
    "model.app_features=48",
    "model.depth=3",
    "model.decoder_scales=3",
    "model.decoder_features=(96,48,24)",
    "loss.vgg_layers=('relu1_2','relu2_2')",
    "loss.vgg_trim_blocks=2",
    "loss.vgg_resolution=64",
]

_R3 = ["model.decoder_out_size=64", "model.stem_stride=4"]
_V1 = ["loss.vgg_layers=('relu1_2',)", "loss.vgg_trim_blocks=1"]
_D32 = ["model.decoder_out_size=32", "model.stem_stride=4", "augment.warp_every=2"]

# name: overrides on top of PX128_BASE. The JAX tool's override lists,
# field for field; no rate is stored here (every rate is this card's).
VARIANTS_128 = {
    "flagship": FLAGSHIP_128,
    "speed128": SPEED128,
    # Decode at 64² (the loss resolution).
    "speed128_d64": SPEED128 + ["model.decoder_out_size=64"],
    # ... and a stride-4 stem (part maps at 32²).
    "speed128_r3": SPEED128 + _R3,
    # Warp on every 2nd step only.
    "speed128_r3_we2": SPEED128 + _R3 + ["augment.warp_every=2"],
    # VGG to relu1_2 only.
    "speed128_r3_v1": SPEED128 + _R3 + _V1,
    # Both.
    "speed128_r4": SPEED128 + _R3 + ["augment.warp_every=2"] + _V1,
    # warp_every 3 and 4: the warp amortised over longer periods, with
    # equivariance pairs on every 3rd / 4th step only.
    "speed128_r4_we3": SPEED128 + _R3 + ["augment.warp_every=3"] + _V1,
    "speed128_r4_we4": SPEED128 + _R3 + ["augment.warp_every=4"] + _V1,
    # warp_fraction on top of r4: warp only the first B·f samples of each
    # warp-on sub-step (augment/pair.py), so every warp-on step keeps
    # true-warp pairs at a fraction of the warp's cost.
    "speed128_r4_wf50": SPEED128 + _R3 + ["augment.warp_every=2",
                                          "augment.warp_fraction=0.5"] + _V1,
    # Per-step warp signal at a quarter of the cost (no cadence cut).
    "speed128_r4_wf25": SPEED128 + _R3 + ["augment.warp_fraction=0.25"] + _V1,
    # Decode AND take the loss at 32²: the decoder drops its 64² scale
    # (the perceptual loss pools the target to the recon resolution);
    # part maps stay at 32², only reconstruction detail drops.
    "speed128_r5_d32": SPEED128 + _D32 + _V1 + ["loss.vgg_resolution=32"],
    # d32 with the half-batch warp.
    "speed128_r5_wf50d32": SPEED128 + _D32 + ["augment.warp_fraction=0.5"] + _V1
    + ["loss.vgg_resolution=32"],
    # d32 with the quarter-batch warp: the speed128 preset's recipe.
    "speed128_r5_wf25d32": SPEED128 + _D32 + ["augment.warp_fraction=0.25"] + _V1
    + ["loss.vgg_resolution=32"],
    # data_echo=4 on r4: each host batch feeds 4 steps with fresh
    # augmentation draws (a quarter of the host's decode demand). The
    # device's work per step is r4's.
    "speed128_r4_echo4": SPEED128 + _R3 + ["augment.warp_every=2"] + _V1 + ["data_echo=4"],
    # f8 fusion-boundary activation storage on r4 (blocks.f8_store;
    # straight-through gradient).
    "speed128_r4_f8": SPEED128 + _R3 + ["augment.warp_every=2"] + _V1 + ["model.act_quant=f8"],
}


class _Child:
    """A tool subprocess started from the repo root, its output kept in
    temporary files (so that children running side by side never block
    on a full pipe)."""

    def __init__(self, cmd):
        self.cmd = cmd
        self.out, self.err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(cmd, stdout=self.out, stderr=self.err, text=True, cwd=ROOT)

    def last_json(self) -> dict:
        """Wait, echo its output, and parse the LAST JSON line it printed
        (the validators exit 1 on a fail and still print it)."""
        rc = self.proc.wait()
        with self.out, self.err:
            self.out.seek(0)
            self.err.seek(0)
            out, err = self.out.read(), self.err.read()
        sys.stdout.write(out)
        if err:
            sys.stderr.write(err[-2000:])
        for line in reversed(out.splitlines()):
            if line.startswith("{"):
                return json.loads(line)
        raise RuntimeError(f"{self.cmd[:4]}... printed no JSON (rc={rc})")


def _run_json(cmd) -> dict:
    """Run a tool subprocess and parse the last JSON line it prints."""
    return _Child(cmd).last_json()


def _first_int(overrides, key: str) -> int:
    """The value of the first ``key=`` override, 1 without one."""
    return next((int(o.split("=")[1]) for o in overrides if o.startswith(key + "=")), 1)


def dispatch_span(overrides, scan: int) -> int:
    """Steps of one dispatch: a warp_every period, re-dispatched data_echo
    times, scan_groups of them; the train loop rejects partial spans."""
    return _first_int(overrides, "augment.warp_every") * _first_int(overrides, "data_echo") * scan


def step_budget(base_steps: int, rate: float, flag_rate: float, span: int) -> int:
    """base_steps × rate / flag_rate, rounded UP to whole dispatch spans."""
    steps = max(1, round(base_steps * rate / flag_rate))
    if span > 1 and steps % span:
        steps += span - steps % span
    return steps


def bench_command(overrides) -> list[str]:
    """The bench child that measures one variant's rate on the card."""
    return [sys.executable, "-m", "partseg_tpu_torch.bench", "--config", "synthetic",
            "--batch", str(STUDY_BATCH), "--steps", str(RATE_PERIODS),
            "--set", *PX128_BASE, *overrides]


def measure_rates(names) -> dict[str, list[float]]:
    """Each variant's bench img/s in RATE_ROUNDS rounds, taken in turns
    across the variants so that a drift of the host falls on all alike."""
    runs = {name: [] for name in names}
    for r in range(RATE_ROUNDS):
        for name in names:
            print(f"=== rate {name}: round {r + 1} of {RATE_ROUNDS} ===", flush=True)
            runs[name].append(float(_run_json(bench_command(VARIANTS_128[name]))["value"]))
    return runs


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_variant(name, overrides, steps, base_dir, scan=1, resume=False, device_data=False,
                ckpt_every=None, cpu=False) -> dict:
    """Train in one child process, then evaluate in two.

    resume=True continues a killed study from the variant's latest
    checkpoint instead of wiping its run dir (restore-latest and the
    loader's seek: the trained numerics equal one uninterrupted run)."""
    out_dir = os.path.abspath(os.path.join(base_dir, name))
    if not resume:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"=== variant {name}: steps={steps} overrides={overrides} ===", flush=True)
    common = [*overrides, "log_every=50", "image_log_every=0",
              f"ckpt_every={ckpt_every or SEGMENT_STEPS}"]
    if device_data:
        # The dataset as one device table; steps gather their batch by index.
        common += ["device_data=True"]
    if scan > 1:
        # scan_groups fetch groups per dispatch: the same step sequence.
        common += [f"scan_groups={scan}"]
    restore_flag = [] if resume else ["--no-restore"]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "partseg_tpu_torch.train.cli", "--config", "synthetic",
         "--ckpt_dir", out_dir, "--steps", str(steps), *restore_flag,
         *(["--device", "cpu"] if cpu else []), "--set", *common], cwd=ROOT)
    if r.returncode != 0:
        raise RuntimeError(f"training {name} failed rc={r.returncode}")
    t1 = time.perf_counter()
    # The two evaluations read the same checkpoint and run side by side.
    on_cpu = ["--cpu"] if cpu else []
    children = [_Child([sys.executable, "-m", "partseg_tpu_torch.tools.validate_synthetic",
                        "--eval_only", "--out_dir", out_dir, "--steps", str(steps), *on_cpu,
                        "--set", *common]),
                _Child([sys.executable, "-m", "partseg_tpu_torch.tools.validate_segmentation",
                        "--ckpt_dir", out_dir, *on_cpu, "--set", *common])]
    syn, seg = (child.last_json() for child in children)
    wall = {"train": t1 - t0, "evaluate": time.perf_counter() - t1}
    print(f"=== variant {name}: {wall} s ===", flush=True)
    return {
        "steps": steps,
        "landmark_err_pct_diag": syn["landmark_err_pct_diag_trained"],
        "equiv_last": syn["equiv_last"],
        "miou": seg["miou_trained"],
        "fg_iou": seg["fg_iou_trained"],
        "learned": bool(syn["ok"]),
        "seg_abs_pass": bool(seg["ok"]),
        "wall_s": wall,
    }


def main_64(steps: int, base_dir: str, cpu: bool = False):
    rows = {
        name: run_variant(name, ov, steps, base_dir, cpu=cpu)
        for name, ov in VARIANTS_64.items()
    }
    q, t = rows["quality"], rows["throughput"]
    result = {
        "mode": "64px_equal_steps",
        "steps": steps,
        "quality": q,
        "throughput": t,
        # Relative gate, loose by design: the throughput recipe trains
        # with fewer FLOPs per step.
        "gate_pass": bool(
            t["learned"]
            and t["landmark_err_pct_diag"] <= 2.0 * q["landmark_err_pct_diag"]
            and t["miou"] >= 0.7 * q["miou"]
        ),
    }
    print(json.dumps(result))
    return result


def _aggregate_seeds(per_seed: dict[int, dict]) -> dict:
    """Mean metrics over seed replicas: the gate compares MEANS; the
    per-seed rows and the max-min spread ship in the row, so a pass can be
    weighed against the spread."""
    keys = ("landmark_err_pct_diag", "equiv_last", "miou", "fg_iou")
    rows = list(per_seed.values())
    agg = dict(rows[0])
    for k in keys:
        vals = [r[k] for r in rows]
        agg[k] = sum(vals) / len(vals)
    agg["learned"] = all(r["learned"] for r in rows)
    agg["seg_abs_pass"] = all(r["seg_abs_pass"] for r in rows)
    agg["n_seeds"] = len(rows)
    agg["seed_rows"] = {str(s): r for s, r in per_seed.items()}
    agg["seed_spread"] = {
        k: max(r[k] for r in rows) - min(r[k] for r in rows) for k in keys
    }
    return agg


def main_128(base_steps: int, base_dir: str, variants: list[str],
             rates: dict[str, float] | None = None,
             anchor_json: str | None = None, scan: int = 1,
             resume: bool = False, device_data: bool = False, seeds: int = 1,
             ckpt_every: int | None = None, cpu: bool = False):
    """Equal-WALL-CLOCK study: variant v trains base_steps × rate_v /
    rate_flagship steps (same global batch, so steps/s ∝ img/s).

    anchor_json: a prior run's result.json; its rows are reused for any
    variant not listed in ``variants`` (same protocol: base_steps must
    match), so new rungs can be gated against an archived flagship anchor
    without retraining it.
    """
    rates = rates or {}
    prior_rows = {}
    if anchor_json:
        with open(anchor_json) as f:
            prior = json.load(f)
        if prior.get("base_steps") != base_steps:
            raise SystemExit(
                f"anchor {anchor_json} ran base_steps={prior.get('base_steps')}"
                f" != {base_steps}; rows are not comparable"
            )
        prior_rows = prior["rows"]
    unknown = [n for n in variants if n not in VARIANTS_128]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS_128)}")
    if "flagship" not in variants and "flagship" not in prior_rows:
        raise SystemExit("the 128px study needs the flagship anchor")
    seg_every = ckpt_every or SEGMENT_STEPS
    for name in variants:
        span = dispatch_span(VARIANTS_128[name], scan)
        if scan > 1 and seg_every % span:
            raise SystemExit(
                f"--scan {scan}: ckpt_every={seg_every} must be a multiple of "
                f"the dispatch span {span} for variant {name}"
            )
    missing = [n for n in variants if n not in rates]
    if missing and cpu:
        raise SystemExit(f"--cpu: rates are the card's; pass --rate NAME=IMG_S for {missing}")
    card = None if cpu else card_line()
    t0 = time.perf_counter()
    runs = measure_rates(missing) if missing else {}
    rates_s = time.perf_counter() - t0
    sel = {}
    for name in variants:
        if name in runs:
            sel[name] = (VARIANTS_128[name], statistics.median(runs[name]), "measured")
        else:
            sel[name] = (VARIANTS_128[name], float(rates[name]), "--rate")

    flag_rate = (
        sel["flagship"][1] if "flagship" in sel
        else prior_rows["flagship"]["img_s_chip"]
    )
    flag_runs = runs.get("flagship", [flag_rate])
    rows = {k: dict(v) for k, v in prior_rows.items() if k not in sel}
    for name, (ov, rate, source) in sel.items():
        span = dispatch_span(ov, scan)
        steps = step_budget(base_steps, rate, flag_rate, span)
        kw = dict(scan=scan, resume=resume, device_data=device_data, ckpt_every=ckpt_every,
                  cpu=cpu)
        if seeds == 1:
            rows[name] = run_variant(name, PX128_BASE + ov, steps, base_dir, **kw)
        else:
            # Seed replicas: seed 0 keeps the variant's name and dir (so a
            # single-seed run resumes as replica 0); seed s>0 sets cfg.seed,
            # which drives the init, the data order and the draws.
            per_seed = {}
            for s in range(seeds):
                rname = name if s == 0 else f"{name}_s{s}"
                sov = ov if s == 0 else ov + [f"seed={s}"]
                per_seed[s] = run_variant(rname, PX128_BASE + sov, steps, base_dir, **kw)
            rows[name] = _aggregate_seeds(per_seed)
        rows[name]["img_s_chip"] = rate
        rows[name]["rate_source"] = source
        if name in runs:
            rows[name]["img_s_chip_runs"] = runs[name]
        # The budget had the rounds' extremes been the rates (the
        # flagship's: its own rate's spread, in steps).
        own = runs.get(name, [rate])
        rows[name]["steps_at_rate_extremes"] = [
            step_budget(base_steps, min(own), max(flag_runs), span),
            step_budget(base_steps, max(own), min(flag_runs), span)]

    f = rows["flagship"]
    verdicts = {}
    for name, r in rows.items():
        if name == "flagship":
            continue
        verdicts[name] = bool(
            r["learned"]
            and r["landmark_err_pct_diag"]
            <= 1.05 * f["landmark_err_pct_diag"]
            and r["miou"] >= 0.95 * f["miou"]
        )
    passing = [n for n, ok in verdicts.items() if ok]
    fastest_pass = (
        max(passing, key=lambda n: rows[n]["img_s_chip"]) if passing else None
    )
    result = {
        "mode": "128px_equal_wallclock",
        "base_steps": base_steps,
        "seeds": seeds,
        "rows": rows,
        "pass_at_equal_wallclock": verdicts,
        "fastest_passing_variant": fastest_pass,
        "gate_pass": bool(passing),
        "card": card,
        "wall_s": {"rates": rates_s, "total": time.perf_counter() - t0},
        "rate_protocol": {"batch": STUDY_BATCH, "rounds": RATE_ROUNDS,
                          "timed_periods": RATE_PERIODS, "statistic": "median",
                          "command": "python -m partseg_tpu_torch.bench --config synthetic"},
    }
    os.makedirs(base_dir, exist_ok=True)
    with open(os.path.join(base_dir, "result.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--px", type=int, default=128, choices=(64, 128))
    ap.add_argument("--steps", type=int, default=800,
                    help="64px mode: equal steps per variant")
    ap.add_argument("--base_steps", type=int, default=800,
                    help="128px mode: the FLAGSHIP's step budget; faster "
                         "variants scale up by their rate")
    ap.add_argument("--base_dir", default="logs/quality_study")
    ap.add_argument("--variants", default="flagship,speed128")
    ap.add_argument("--rate", action="append", default=[], metavar="NAME=IMG_S",
                    help="give a variant's rate instead of measuring it on the card")
    ap.add_argument("--anchor_json", default=None,
                    help="reuse rows (incl. the flagship anchor) from a "
                         "prior result.json instead of retraining them")
    ap.add_argument("--scan", type=int, default=1,
                    help="scan_groups for the training runs (the same step sequence)")
    ap.add_argument("--device_data", action="store_true",
                    help="train with cfg.device_data: the synthetic set on the card, "
                         "steps gather by index")
    ap.add_argument("--ckpt_every", type=int, default=None,
                    help=f"checkpoint cadence (span-aligned); default {SEGMENT_STEPS}")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seed replicas per NEW variant row (gate on the mean; "
                         "per-seed rows + spread recorded); s>0 sets cfg.seed=s")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed study from each variant's latest "
                         "checkpoint instead of wiping its run dir")
    ap.add_argument("--cpu", action="store_true",
                    help="train and evaluate on the CPU (every rate given by --rate)")
    a = ap.parse_args(argv)
    if a.px == 64:
        r = main_64(a.steps, a.base_dir, cpu=a.cpu)
    else:
        rates = dict((k, float(v)) for k, v in (s.split("=") for s in a.rate))
        r = main_128(a.base_steps, a.base_dir, a.variants.split(","), rates,
                     anchor_json=a.anchor_json, scan=a.scan, resume=a.resume,
                     device_data=a.device_data, seeds=a.seeds, ckpt_every=a.ckpt_every,
                     cpu=a.cpu)
    return 0 if r["gate_pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
