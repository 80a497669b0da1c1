"""Serving export, the port's twin of partseg_tpu/evals/export.py: the
inference forward (shape encoder → part heatmaps, soft-argmax landmarks,
dense segmentation) as a ``torch.export`` program with the trained
weights in it.

``make_infer_fn`` and ``export_infer`` run one module, ``InferForward``,
so the eager and the exported forward are the same code. The part-map
kernel is the registered op ``partseg::softmax_moments``, which the
exported graph holds as one node: running the program launches the hand
kernel on the card. Two differences from the JAX artifact, which needs no
package code and is lowered for two platforms at once:

- a program runs on the device it was exported on (its weights and the
  op's device are in it), so export on the device that will serve;
- loading it needs the op registered, i.e. ``import partseg_tpu_torch``
  (``load_exported`` does).

The batch dimension is symbolic unless a static batch is asked for.

CLI:
    python -m partseg_tpu_torch.evals.export --config configs/celeba.py \\
        --ckpt_dir logs/celeba --out partnet_infer.pt2 --verify [--cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Callable

import numpy as np
import torch
from torch import nn

from partseg_tpu_torch.models.partnet import PartNet
from partseg_tpu_torch.tracing import span


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def as_images(images, device: torch.device) -> torch.Tensor:
    """NHWC numpy array or tensor in [0, 1] → f32 tensor on ``device``."""
    return torch.as_tensor(images, dtype=torch.float32, device=device)


class InferForward(nn.Module):
    """The batched inference forward of ``model``.

    images [B, H, W, 3] f32 in [0,1] → dict of tensors:
      heatmaps  [B, h, w, K]      per-part spatial distributions, f32
      logits    [B, h, w, K(+1)]  raw shape-encoder logits, f32
      landmarks [B, K, 2]         soft-argmax μ, (y, x) in [-1, 1]
      sigma     [B, K, 2, 2]      part covariances
      seg       [B, h, w]         int32 labels; with a background channel
                                  0 = background and part k → k+1
    """

    def __init__(self, model: PartNet):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        model, cfg = self.model, self.model.cfg
        logits = model.encode_shape(images)
        parts, mu, sigma = model.shape_stats(logits)
        seg = torch.argmax(model.segmentation(logits), dim=-1).to(torch.int32)
        if cfg.background:
            # Softmax channel order is [parts..., bg]: bg → 0, part k → k+1.
            seg = torch.where(seg == cfg.n_parts, 0, seg + 1).to(torch.int32)
        return {"heatmaps": parts, "logits": logits, "landmarks": mu,
                "sigma": sigma, "seg": seg}


def make_infer_fn(model: PartNet) -> Callable[[torch.Tensor], dict]:
    """Batched inference forward: images [B, H, W, 3] in [0,1] (numpy or
    tensor) → ``InferForward``'s dict, on the model's device; each call in
    the span ``serve.infer``."""
    device = model_device(model)
    forward = InferForward(model)

    @torch.inference_mode()
    def infer(images) -> dict:
        with span("serve.infer"):
            return forward(as_images(images, device))

    return infer


def export_infer(model: PartNet, img_size: int,
                 batch: int | None = None) -> torch.export.ExportedProgram:
    """``torch.export`` of the inference forward on the model's device.
    batch=None → a symbolic batch dimension (one program, any batch);
    batch=N → static shapes (any other batch is refused)."""
    example = torch.zeros((batch or 2, img_size, img_size, 3), device=model_device(model))
    dynamic = None if batch is not None else {"images": {0: torch.export.Dim("b")}}
    with torch.no_grad():
        return torch.export.export(InferForward(model).eval(), (example,),
                                   dynamic_shapes=dynamic)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Load a program written by ``torch.export.save``; call it as
    ``program.module()(images)``. The op it holds is registered by this
    package's import."""
    return torch.export.load(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description="export the inference forward")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--out", default="partnet_infer.pt2")
    ap.add_argument("--batch", type=int, default=None,
                    help="static batch size; default: symbolic (any batch)")
    ap.add_argument("--cpu", action="store_true",
                    help="export on the CPU (the program then serves on the CPU)")
    ap.add_argument("--verify", action="store_true",
                    help="load the program and check it matches the direct "
                         "forward on random input")
    args = ap.parse_args(argv)

    from partseg_tpu_torch.evals.infer import load_model_and_params
    from partseg_tpu_torch.train.config import load_config

    cfg = load_config(args.config)
    model = load_model_and_params(cfg, args.ckpt_dir, device="cpu" if args.cpu else None)
    program = export_infer(model, cfg.model.img_size, batch=args.batch)
    torch.export.save(program, args.out)
    print(f"[export] wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"device={model_device(model)}, "
          f"in_shape=({args.batch or 'b'}, {cfg.model.img_size}, {cfg.model.img_size}, 3)")

    if args.verify:
        reloaded = load_exported(args.out)
        s = cfg.model.img_size
        x = np.random.default_rng(0).uniform(size=(args.batch or 2, s, s, 3)).astype(np.float32)
        with torch.inference_mode():
            got = reloaded.module()(as_images(x, model_device(model)))
        want = make_infer_fn(model)(x)
        for k in want:
            np.testing.assert_allclose(got[k].float().cpu().numpy(),
                                       want[k].float().cpu().numpy(),
                                       rtol=2e-2, atol=2e-2, err_msg=k)
        print("[export] verify OK: the loaded program matches the direct forward")


if __name__ == "__main__":
    main()
