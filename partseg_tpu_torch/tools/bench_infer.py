"""Inference (serving) throughput on the card, the port's twin of
tools/bench_infer.py: the shape-encoder inference forward — part
heatmaps, soft-argmax landmarks, dense segmentation — as a service would
run it. Two paths, the same forward:

  eager    — ``evals.export.make_infer_fn``, in process (a Python service
             embedding partseg_tpu_torch; the JAX tool's "jit"),
  exported — ``evals.export.export_infer`` at the batch, written with
             ``torch.export.save``, read back with ``torch.export.load``
             and called: what a serving process that loads the program
             runs.

    python -m partseg_tpu_torch.tools.bench_infer [--config speed128] [--batch 256]
        [--steps 30] [--warmup 3] [--ckpt_dir RUN] [--cpu]

Prints one JSON line per path with the JAX tool's keys (img/s over
``--steps`` calls after ``--warmup``, by the host's clock around the calls
and a ``torch.cuda.synchronize``); the exported line adds
``max_abs_vs_eager``, each output's largest difference from the eager
forward on the same images. It runs on the card unless --cpu. The loaded
program holds the op ``partseg::softmax_moments``, which the package's
import registers.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

import partseg_tpu_torch.evals.export as export_mod   # registers partseg::softmax_moments


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="speed128")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from partseg_tpu_torch.evals.infer import load_model_and_params
    from partseg_tpu_torch.train.config import load_config

    cfg = load_config(args.config)
    model = load_model_and_params(cfg, args.ckpt_dir, device="cpu" if args.cpu else None)
    dev = export_mod.model_device(model)
    cuda = dev.type == "cuda"
    s = cfg.model.img_size
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((args.batch, s, s, 3), generator=gen, device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def measure(call):
        for _ in range(args.warmup):
            call(x)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            out = call(x)
        sync()
        del out
        return args.batch * args.steps / (time.perf_counter() - t0)

    def line(path, rate, **extra):
        row = {"metric": "infer_throughput", "path": path, "value": round(rate, 1),
               "unit": "img/s/chip", "batch": args.batch, "img_size": s,
               "config": args.config, **extra}
        print(json.dumps(row), flush=True)
        return row

    eager = export_mod.make_infer_fn(model)
    eager_row = line("eager", measure(eager))

    program = export_mod.export_infer(model, s, batch=args.batch)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "infer.pt2")
        torch.export.save(program, path)
        loaded = export_mod.load_exported(path).module()

    @torch.inference_mode()
    def serve(images):
        return loaded(images)

    got, want = serve(x), eager(x)
    errs = {k: (got[k].float() - want[k].float()).abs().max().item() for k in want}
    exported_row = line("exported", measure(serve), max_abs_vs_eager=errs)
    return {"eager": eager_row, "exported": exported_row}


if __name__ == "__main__":
    main()
